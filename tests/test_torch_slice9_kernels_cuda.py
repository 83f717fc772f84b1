"""Stage 5 on the card: one full-width ``train-distillation`` step through
``run.main`` with exact launch counts, and the part head's gather backward.

- ``train-distillation`` at its full-size default (the 22,000 x 8 + 1 column
  head, banded sampling) over ``chip_smoke.cli_dataset``'s images and
  ``chip_smoke.stage4_store``: one step at B = 2 launches each kernel of
  the path exactly ``chip_smoke.PER_TRAIN_STEP`` times, every sampling
  launch banded.
- The head's backward on the card adds the rows of duplicate live columns
  (two images of one class, the no-object column of every image) by
  atomics: at B = 4 its gradient equals the CPU's within 1e-5 of max, and
  is zero outside the live rows.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On the card: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_slice9_kernels_cuda.py``.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from partdistillation_torch.models.transformer_decoder import (
    PartDistillationTransformerDecoder,
    TransformerDecoderConfig,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels have no CPU mode)")


def test_train_distillation_full_width_one_step(cuda, tmp_path, capsys):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    from partdistillation_torch import run

    ov = cs.cli_dataset(str(tmp_path), 0)
    ov += cs.stage4_store(str(tmp_path), 0)[0]
    cs.reset_launches()
    run.main(["train-distillation", "--set", *ov, "data.batch_size=2", "max_iters=1",
              "log_every=1"])
    res = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")][-1]
    assert res["stage"] == "train-distillation" and res["steps"] == 1
    assert cs.launch_counts() == cs.PER_TRAIN_STEP
    assert cs.banded_launches() == cs.PER_TRAIN_STEP["msda_folded"] == 6


def test_head_gather_backward_with_duplicate_columns(cuda):
    cfg = TransformerDecoderConfig(num_classes=8, num_object_classes=22000, num_parts=8,
                                   dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    dec = torch.randn((4, 200, 256), generator=g).to(torch.bfloat16)
    cot = torch.randn((4, 200, 9), generator=g)
    goc = torch.tensor([4711, 21999, 4711, 0])
    grads = {}
    for device in ("cpu", "cuda"):
        torch.manual_seed(0)
        model = PartDistillationTransformerDecoder(cfg, 256).to(device)
        head = model.part_class_embed
        with torch.no_grad():
            head.weight.copy_(torch.randn(head.weight.shape, generator=g.manual_seed(1)) / 16)
            head.bias.copy_(torch.randn(head.bias.shape, generator=g.manual_seed(2)))
        logits = model._class_head(goc.to(device))(dec.to(device))
        assert logits.dtype == torch.float32 and tuple(logits.shape) == (4, 200, 9)
        (logits * cot.to(device)).sum().backward()
        grads[device] = (head.weight.grad.cpu(), head.bias.grad.cpu())
    live = torch.zeros(22000 * 8 + 1, dtype=torch.bool)
    live[model.live_columns(goc).flatten().cpu()] = True
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert not got[~live].any()
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err
