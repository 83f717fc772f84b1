"""The training loop of a cell: ``Trainer.train_step`` fed by the program's
``DataLoader`` through the wire format, one client in a closed loop (the
next batch is taken when the step has returned its metrics, which
synchronises), as the program's ``_train_loop`` runs it.

Set-up writes the traffic's image set, makes the weights on the device from
the seed, builds the trainer and runs the checked steps and the warm-up
steps through the window's own call and feed. The first three steps'
batches, image ids and noise are kept for the reference, with the program's
losses, the first step's features, predictions and loss terms (a forward hook
and the step's metrics), its first gradient (read from the optimizer's state
after one step) and each leaf's change after three. Then the window measures
for ``seconds``; with a trace, its first ``trace_steps`` steps run under the
profiler. After the window the program is freed and the reference follows
the three steps, on its own rows of the same images where the store has a
plain mapper.
"""

from __future__ import annotations

import gc
import math
import shutil
import tempfile
import time
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from . import backbones, check, data, program, stores, tasks
from .trace import Tracer
from .weights import make_weights

NOISE_SALT = 0x5EED_0F_2011


def draw_noise(cfg: dict, b: int, t: int, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The step's randomness as the program's loss takes it: the backbone's
    (its ``draw_noise``: DropPath keep decisions), the matcher's grid jitter
    or points, and the criterion's point jitter or point pools
    (``reference/loss.py``)."""
    crit = cfg["criterion"]
    layers = 1 + cfg["model"]["decoder"]["dec_layers"]

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=device)

    backbone, group = backbones.load(cfg["model"])
    noise = backbone.draw_noise(group, b, uniform)
    if crit["match_point_mode"] == "random":
        noise["match_points"] = uniform(layers, b, crit["num_points"], 2)
    else:
        noise["match_jitter"] = uniform(layers, b, 2)
    n_imp = int(crit["importance_sample_ratio"] * crit["num_points"])
    if crit["point_mode"] == "random":
        if n_imp:
            noise["point_pool"] = uniform(layers, b, t,
                                          int(crit["num_points"] * crit["oversample_ratio"]), 2)
        noise["point_fresh"] = uniform(layers, b, t, crit["num_points"] - n_imp, 2)
    else:
        noise["point_jitter"] = uniform(layers, b, t, 2)
    return noise


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Session:
    """The program's trainer, loader and noise of one run, and what its
    checked steps left for the reference."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, tmp: str):
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.paths = data.write_dataset(tmp, traffic, seed)
        self.model, self.trainer = program.build_trainer(
            cfg, make_weights(cfg["model"], seed, self.device), self.device, seed)
        self.loader = program.build_loader(cfg, traffic, self.paths, seed)
        self.batches = iter(self.loader)
        self.g = torch.Generator(device=self.device)
        self.g.manual_seed((int(seed) ^ NOISE_SALT) & 0xFFFF_FFFF_FFFF_FFFF)
        self.kept_batches, self.kept_noise, self.kept_ids = [], [], []
        self.prog = {"loss": [], "grad": {}, "change": {}}

    def next_batch(self):
        """(the loader's batch, its packed form, the step's noise)."""
        with record_function("portbench.data"):
            batch = next(self.batches)
            packed = program.pack(batch)
        noise = draw_noise(self.cfg, self.traffic["batch"], self.cfg["mask_capacity"], self.g,
                           self.device)
        return batch, packed, noise

    def step(self, packed, noise) -> dict:
        with record_function("portbench.step"):
            return self.trainer.train_step(packed, noise)

    def checked_steps(self) -> None:
        """The checked steps, then the warm-up steps, through the window's
        call and feed; keeps the program's readings and the checked inputs."""
        frozen = self.cfg["optimizer"]["freeze_keys"]
        trainable = [(n, p) for n, p in self.model.named_parameters()
                     if not any(k in n.lower() for k in frozen)]
        start = {n: p.detach().clone() for n, p in trainable}
        checked = self.traffic["checked_steps"]
        fields = ("image",) + tasks.load(self.cfg).FIELDS
        for step in range(checked + self.traffic["warmup_steps"]):
            batch, packed, noise = self.next_batch()
            hook = self.model.register_forward_hook(self._keep_outputs) if step == 0 else None
            metrics = self.step(packed, noise)
            if hook is not None:
                hook.remove()
            if step < checked:
                self.kept_batches.append({k: packed[k] for k in fields})
                self.kept_noise.append({k: v.cpu() for k, v in noise.items()})
                self.kept_ids.append([str(i) for i in batch["image_id"]])
                self.prog["loss"].append(metrics["total_loss"])
            if step == 0:
                state = self.trainer.optimizer.adam.state
                grads = {n: state[p]["exp_avg"] / (1.0 - check.BETA1) for n, p in trainable}
                self.prog["grad"] = {n: float(g.norm()) for n, g in grads.items()}
                self.prog["first"] = {
                    **self.prog.pop("outputs"),
                    "terms": {k: v for k, v in metrics.items() if k.startswith("loss_")},
                    "grad": {n: g.detach().float().cpu() for n, g in grads.items()}}
                del grads
            if step == checked - 1:
                self.prog["change"] = {n: float((p.detach() - start[n]).norm())
                                       for n, p in trainable}
                start = None
        _sync(self.device)

    def reference_rows(self):
        """(the checked batches the reference trains on, ``input_gap``):
        the reference mapper's own rows of the same images where the store
        has one, else the loader's rows and None."""
        mapper = stores.load(self.traffic).REFERENCE
        if mapper is None:
            return self.kept_batches, None
        m = mapper(self.paths, self.cfg["image_size"], self.cfg["mask_capacity"])
        rows = [m.batch(ids) for ids in self.kept_ids]
        return rows, check.input_gap(self.kept_batches, rows, self.cfg["image_size"])

    def _keep_outputs(self, module, args, out) -> None:
        """The first step's backbone features, mask features and decoder
        predictions, as the step's own forward produced them, on the host."""
        kept = check.first_step(out, {}, {})
        self.prog["outputs"] = {k: kept[k] for k in ("features", "decoder")}

    def close(self) -> None:
        """Stop the loader and free the program's state."""
        if self.loader is not None:
            self.loader.close()
        self.loader = self.batches = self.trainer = self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, limits: Dict[str, float], tmp_root: str = None) -> dict:
    """One run of a training cell; returns the run's record (``run.py``
    turns it into the result line)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    tmp = tempfile.mkdtemp(prefix="portbench-", dir=tmp_root)
    sess = None
    try:
        sess = Session(cfg, traffic, seed, device, tmp)
        sess.checked_steps()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start

        tracer = Tracer(tmp, cuda) if trace else None
        waits, intervals, losses = [], [], []
        n_img = 0
        t0 = last = time.perf_counter()
        if tracer:
            tracer.start()
        while True:
            tw = time.perf_counter()
            batch, packed, noise = sess.next_batch()
            waits.append(time.perf_counter() - tw)
            metrics = sess.step(packed, noise)
            now = time.perf_counter()
            intervals.append(now - last)
            last = now
            losses.append(metrics["total_loss"])
            n_img += int(np.asarray(batch["batch_valid"]).sum())
            if tracer and len(intervals) == traffic["trace_steps"]:
                _sync(device)
                tracer.stop()
            if now - t0 >= seconds:
                break
        window_s = last - t0
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        record = {"loop": "train", "steps": len(intervals), "images": n_img,
                  "window_s": window_s, "intervals": intervals, "waits": waits,
                  "setup_s": setup_s, "peak_bytes": peak, "batch": traffic["batch"],
                  "failed": int(sum(not math.isfinite(x) for x in losses))}
        if tracer:
            if tracer.t1 is None:  # the window ended before the traced steps did
                _sync(device)
                tracer.stop()
            record["trace"] = tracer.summary(min(traffic["trace_steps"], len(intervals)))
        sess.close()
        rows, in_gap = sess.reference_rows()
        ref = check.run_reference(cfg, seed, rows, sess.kept_noise, device,
                                  against=sess.prog.pop("first"))
        numbers = check.compare(sess.prog, ref, ref["first_gaps"])
        if in_gap is not None:
            numbers["input_gap"] = in_gap
        record["checks"] = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
        record["correct"] = check.verdict(numbers, limits)
        if trace:
            from .flops import train_step_flops

            record["step_flops"] = train_step_flops(cfg, traffic["batch"])
        return record
    finally:
        if sess is not None:
            sess.close()
        shutil.rmtree(tmp, ignore_errors=True)
