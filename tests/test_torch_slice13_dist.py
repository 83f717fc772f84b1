"""The supervised ablation's data-parallel train step on the CPU: two gloo
ranks as subprocesses (``tests/torch_dist_worker.py``) at B = 1 a rank
against one process at B = 2, on the same weights, batch, noise (the random
point mode's pools and fresh points included) and matching, with the trunk
unfrozen and DropPath 0.3: the loss (the group mean), every gradient the
update starts from and the parameters after AdamW within 1e-5 of each
tensor's largest magnitude (at least 1), the two ranks' valid counts
unequal; the steps with the mask count or the CE weight sum left per rank
miss that tolerance."""

import torch

from torch_dist_worker import run_ranks

TOL = 1e-5


def _excess(got, want) -> float:
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    return float((got - want).abs().max() - TOL * max(1.0, float(want.abs().max())))


def _worst(got: dict, want: dict, keys=None) -> float:
    return max(_excess(got[k], want[k]) for k in (keys if keys is not None else want))


def test_supervised_ddp_step_equals_the_global_batch_step(tmp_path):
    ranks = run_ranks("ddp_step", 2, tmp_path, "supervised")
    ref = ranks[0]["ref"]
    losses = [k for k in ref["metrics"] if k.startswith("loss") or k == "total_loss"]
    assert "loss_mask" in losses and len(losses) == 3 * 3 + 1
    for out in ranks:
        ddp = out["ddp"]
        assert _worst(ddp["metrics"], ref["metrics"], losses + ["grad_norm"]) <= 0
        assert ddp["grads"].keys() == ref["grads"].keys()
        assert any(k.startswith("backbone.") for k in ref["grads"])
        assert _worst(ddp["grads"], ref["grads"]) <= 0
        assert _worst(ddp["params"], ref["params"]) <= 0
    for planted in ("local_num_masks", "local_class_weight"):
        bad = ranks[0][planted]
        assert _worst(bad["grads"], ref["grads"]) > 0, planted
        assert _worst(bad["metrics"], ref["metrics"], losses) > 0, planted
