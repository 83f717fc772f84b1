"""The comparison fails a broken program and the control.

The faults: a step that returns its state unchanged, half of the batch left
out of the loss after the forward (the mean taken over the rest), and an
answer altered where it is produced (one leaf's gradient zeroed by the
backward).

Each test skips the harness's look for a card and drives the rest of a run
at a tiny size on the CPU with the timed path broken underneath, under the
cell's own limits, and sees ``correct`` come out false. The control test
puts the reference computed with fp8 operands in the program's place."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import check, control, program, run, train
from portbench.tests.tiny import tiny_config, tiny_traffic

CELLS = [("proposal.train", "m2f-swinL-proposal", "stage3_train"),
         ("supervised.train", "m2f-swinL-supervised", "supervised_train")]


def limits(cell: str) -> dict:
    return run.load_json(run.HERE, "limits", cell + ".json")


def state_unchanged(monkeypatch):
    from partdistillation_torch.engine.optim import Optimizer

    real = Optimizer.step

    def step(self):
        saved = [p.detach().clone() for p in self.params]
        norm = real(self)
        with torch.no_grad():
            for p, s in zip(self.params, saved):
                p.copy_(s)
        return norm

    monkeypatch.setattr(Optimizer, "step", step)


def half_batch(monkeypatch):
    """The forward on the whole batch, the loss over its first half (the
    mean taken over the rest)."""
    from partdistillation_torch.models.meta_arch.proposal import ProposalLoss

    real = ProposalLoss.criterion

    def criterion(self, outputs, t, noise):
        n = t["image"].shape[0] // 2
        outputs = {k: check._first_half(outputs[k], n)
                   for k in ("pred_logits", "pred_masks", "aux_outputs")}
        t = {k: v[:n] for k, v in t.items()}
        noise = {k: (v if k == "drop_keep" else v[:, :n]) for k, v in noise.items()}
        return real(self, outputs, t, noise)

    monkeypatch.setattr(ProposalLoss, "criterion", criterion)


def zeroed_gradient(monkeypatch):
    """An answer altered where it is produced: the backward hands one
    decoder leaf a zero gradient."""
    real = program.build_trainer

    def build(*args, **kw):
        model, trainer = real(*args, **kw)
        leaf = dict(model.named_parameters())[control.FAULT_LEAF]
        leaf.register_hook(torch.zeros_like)
        return model, trainer

    monkeypatch.setattr(program, "build_trainer", build)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, zeroed_gradient])
@pytest.mark.parametrize("cell,config,traffic", CELLS)
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, fault, cell, config, traffic):
    fault(monkeypatch)
    rec = train.run(tiny_config(config), tiny_traffic(traffic), 31, 0.3, False, "cpu",
                    time.perf_counter(), limits(cell), str(tmp_path))
    assert not rec["correct"], rec["checks"]


def test_an_altered_row_is_not_correct(tmp_path, monkeypatch):
    """A row altered where the program's mapper produces it: one pixel of the
    image. The reference maps the written files itself, so the rows differ."""
    from partdistillation_torch.data.mappers import PartEvalMapper

    real = PartEvalMapper.__call__

    def call(self, item):
        ex = real(self, item)
        if ex is not None:
            ex["image"] = ex["image"].copy()
            ex["image"][0, 0, 0] = 255.0 - ex["image"][0, 0, 0]
        return ex

    monkeypatch.setattr(PartEvalMapper, "__call__", call)
    rec = train.run(tiny_config("m2f-swinL-supervised"), tiny_traffic("supervised_train"), 31,
                    0.3, False, "cpu", time.perf_counter(), limits("supervised.train"),
                    str(tmp_path))
    assert rec["checks"]["input_gap"]["value"] > 0 and not rec["correct"], rec["checks"]


@pytest.mark.parametrize("cell,config,traffic", CELLS)
def test_the_control_is_not_correct(tmp_path, cell, config, traffic):
    out = control.readings(tiny_config(config), tiny_traffic(traffic), 8, "cpu", str(tmp_path))
    assert check.verdict(out["program"], limits(cell)), out["program"]
    assert not check.verdict(out["fp8"], limits(cell)), out["fp8"]
    assert not check.verdict(out["fp8_decoder"], limits(cell)), out["fp8_decoder"]
    assert not check.verdict(out["half_batch"], limits(cell)), out["half_batch"]
    assert not check.verdict(out["zeroed_gradient"], limits(cell)), out["zeroed_gradient"]
