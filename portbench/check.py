"""The comparison that decides ``correct`` for a training cell.

The plain reference (``reference/``) follows the program's first three
steps from the same seeded weights, on the same images in the same order,
and the same noise. The numbers, each taken by its worst case:

- ``input_gap``: where the store has a plain mapper (``reference/data.py``),
  the share of the checked batches' values that differ between the rows the
  program's loader made and the reference's own from the written files (the
  reference then trains on its own rows; elsewhere on the loader's);
- ``feature_gap``: the first step's backbone levels and mask features, as
  the step's own forward produced them, per image: ||prog - ref|| / ||ref||;
  an image the program did not compute reads 1;
- ``mask_gap_first_layer``: the decoder's mask logits of the prediction
  before its first masked attention, per image the median query's relative
  gap, the worst image; ``mask_gap_image_median``: over all prediction
  layers, each layer's median image's, the worst layer (``mask_gap``, the
  worst image of the worst layer, for the record: a rounding that flips an
  attention mask moves every later layer of that image);
- ``image_coef_gap``: the program's first clipped gradient over the
  decoder's leaves (read from its optimizer's first moment after one step
  over 1 - beta1), fitted by least squares as a sum of the reference's
  per-image gradients: the worst image's |coefficient - 1|;
- ``grad_gap``: over the trainable leaves, the gap between the norm of that
  first gradient and the reference's, over the reference's norm of that leaf
  or of the median leaf, whichever is larger;
- ``change_gap``: the same for the norm of each leaf's change after three
  steps, over the leaves whose first reference gradient is at least a
  thousandth of the median leaf's (the rest move under Adam by round-off);
- for the record: the losses' largest relative gap (``loss_gap``, and
  ``loss_gap_first`` of the first step), the first step's loss terms' largest
  (``terms_gap_first``), the first gradient's difference over all leaves
  (``grad_diff``) and the median leaf's gaps.

A cell's ``limits/<cell>.json`` names the numbers it compares. The reference
computes in float32 with TF32 off; ``rounding`` makes it the control, every
product's operands rounded to ``bf16`` or scaled ``fp8``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import backbones, tasks
from .reference import loss as ref_loss
from .reference.model import Rounding, Segmenter, is_frozen
from .weights import make_weights

BETA1 = 0.9


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def unpack_masks(packed: np.ndarray, size: int) -> np.ndarray:
    """(..., S, ceil(S/8)) rows of bits, the first pixel in a byte's most
    significant bit -> (..., S, S) float32."""
    return np.unpackbits(packed, axis=-1)[..., :size].astype(np.float32)


def reference_batch(packed: dict, size: int, device, task) -> dict:
    """A step's image and ``task``'s targets on ``device`` from a row dict:
    the wire format's (bit-packed masks) or the reference mapper's (bool
    masks)."""
    fields = {k: torch.as_tensor(packed[k], device=device) for k in task.FIELDS
              if k not in ("masks", "valid")}
    masks = packed["masks"]
    masks = masks.astype(np.float32) if masks.dtype == bool else unpack_masks(masks, size)
    fields["masks"] = torch.as_tensor(masks, device=device)
    fields["valid"] = torch.as_tensor(np.asarray(packed["valid"], bool), device=device)
    return {"image": torch.as_tensor(packed["image"], device=device).float(),
            "targets": task.targets(fields)}


def input_gap(prog: List[dict], ref: List[dict], size: int) -> float:
    """The share of the checked batches' values (image bytes, mask pixels,
    valid flags, labels) where the rows the program was handed differ from
    the reference mapper's; 0 when they agree exactly."""
    worst = 0.0
    for p, r in zip(prog, ref):
        masks = unpack_masks(p["masks"], size).astype(bool)
        pairs = [(np.asarray(p["image"]), r["image"]), (masks, r["masks"]),
                 (np.asarray(p["valid"], bool), r["valid"])]
        if "labels" in p:
            pairs.append((np.asarray(p["labels"]).astype(np.int64), r["labels"]))
        bad = sum(int((a != b).sum()) if a.shape == b.shape else b.size for a, b in pairs)
        worst = max(worst, bad / sum(b.size for _, b in pairs))
    return worst


def feature_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """The worst image's relative gap over the backbone's levels and the
    mask features; an image the program did not compute reads 1."""
    worst = 0.0
    for k, r in ref.items():
        p = prog[k].to(r.device, torch.float32)
        n = min(p.shape[0], r.shape[0])
        if n < r.shape[0]:
            worst = 1.0
        diff = (p[:n] - r[:n]).flatten(1).norm(dim=1) / r[:n].flatten(1).norm(dim=1)
        worst = max(worst, float(diff.max()))
    return worst


def _rel(p: torch.Tensor, r: torch.Tensor, dims: int) -> torch.Tensor:
    """||p - r|| / ||r|| over all but the first ``dims`` dimensions."""
    p = p.to(r.device, torch.float32)
    return (p - r).flatten(dims).norm(dim=-1) / r.flatten(dims).norm(dim=-1).clamp(min=1e-30)


def decoder_gaps(prog: List[Tuple[torch.Tensor, torch.Tensor]],
                 ref: List[Tuple[torch.Tensor, torch.Tensor]]) -> Dict[str, float]:
    """Over the prediction layers' mask logits, per image and layer the
    median query's relative gap: ``mask_gap_first_layer`` (the worst image
    of the layer before any masked attention), ``mask_gap_image_median`` (the
    worst layer's median image) and ``mask_gap`` (the worst of all); an
    image the program did not compute reads 1."""
    keys = ("mask_gap", "mask_gap_first_layer", "mask_gap_image_median")
    if len(prog) != len(ref) or any(p[1].shape[0] < r[1].shape[0] for p, r in zip(prog, ref)):
        return {k: 1.0 for k in keys}
    per_layer = [_rel(pm[:rm.shape[0]], rm, 2).median(dim=1).values
                 for (_, pm), (_, rm) in zip(prog, ref)]
    return {"mask_gap": max(float(g.max()) for g in per_layer),
            "mask_gap_first_layer": float(per_layer[0].max()),
            "mask_gap_image_median": max(float(g.median()) for g in per_layer)}


DECODER = "sem_seg_head.predictor."


def image_gradients(shares: torch.Tensor, named) -> List[Dict[str, torch.Tensor]]:
    """Each image's gradient of its share of the loss, over the decoder's
    trainable leaves (the graph is kept for the step's own backward)."""
    leaves = [(n, p) for n, p in named if n.startswith(DECODER) and p.requires_grad]
    out = []
    for share in shares:
        gs = torch.autograd.grad(share, [p for _, p in leaves], retain_graph=True,
                                 allow_unused=True)
        out.append({n: (torch.zeros_like(p) if g is None else g.detach())
                    for (n, p), g in zip(leaves, gs)})
    return out


def image_coef_gap(prog: Dict[str, torch.Tensor], images: List[Dict[str, torch.Tensor]],
                   scale: float) -> float:
    """The program's first clipped gradient over the decoder's leaves, by
    least squares a sum of the reference's per-image gradients (clipped by the
    reference's factor ``scale``): the worst image's |coefficient - 1|. An
    image left out of the program's loss reads about 1."""
    names = list(images[0])
    dev = images[0][names[0]].device
    b = len(images)
    gram = torch.zeros(b, b, dtype=torch.float64, device=dev)
    rhs = torch.zeros(b, dtype=torch.float64, device=dev)
    for n in names:
        stack = torch.stack([g[n].flatten() for g in images]).double()
        gram += stack @ stack.T
        rhs += stack @ (prog[n].to(dev).double().flatten() / scale)
    coef = torch.linalg.lstsq(gram, rhs[:, None]).solution[:, 0]
    return float((coef - 1.0).abs().max())


def grad_diff(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """The first gradient's difference over all leaves together:
    ||g_prog - g_ref|| / ||g_ref||."""
    num = den = 0.0
    for n, r in ref.items():
        num += float((prog[n].to(r.device, torch.float32) - r).norm()) ** 2
        den += float(r.norm()) ** 2
    return (num / max(den, 1e-60)) ** 0.5


def terms_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The first step's loss terms' largest relative gap."""
    return max(abs(prog[k] - v) / max(abs(v), 1e-30) for k, v in ref.items())


def first_step_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """Every first-step number of the module docstring: ``prog`` and ``ref``
    are what ``first_step`` kept of each side's first step (the reference's
    with its per-image gradients)."""
    out = {"feature_gap": feature_gap(prog["features"], ref["features"]),
           **decoder_gaps(prog["decoder"], ref["decoder"]),
           "grad_diff": grad_diff(prog["grad"], ref["grad"]),
           "terms_gap_first": terms_gap(prog["terms"], ref["terms"])}
    if "images" in ref:
        out["image_coef_gap"] = image_coef_gap(prog["grad"], ref["images"], ref["scale"])
    return out


def prediction_layers(out: dict) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(class logits, mask logits) of every prediction layer, from the one
    before the first decoder layer to the last."""
    return ([(a["pred_logits"], a["pred_masks"]) for a in out["aux_outputs"]]
            + [(out["pred_logits"], out["pred_masks"])])


def first_step(out: dict, terms: Dict[str, float], grads: Dict[str, torch.Tensor],
               device="cpu", images: List[Dict[str, torch.Tensor]] = None,
               scale: float = 1.0) -> dict:
    """What a first step leaves for the comparison, on ``device``: its
    forward's features and predictions, its loss terms and its clipped
    gradients (a reference's also its per-image gradients and clipping
    factor)."""
    feats = {**out["backbone_features"], "mask_features": out["mask_features"]}
    move = lambda x: x.detach().to(device)  # noqa: E731
    kept = {"features": {k: move(v) for k, v in feats.items()},
            "decoder": [(move(a), move(b)) for a, b in prediction_layers(out)],
            "terms": dict(terms), "grad": {n: move(g).float() for n, g in grads.items()}}
    if images is not None:
        kept["images"] = [{n: move(g) for n, g in img.items()} for img in images]
        kept["scale"] = scale
    return kept


def loss_terms(parts: List[List[torch.Tensor]]) -> Dict[str, float]:
    """The reference criterion's per-layer [ce, mask, dice] under the
    program's names: the final layer's plain, layer i's with ``_i``."""
    out = {}
    for i, layer in enumerate(parts):
        suffix = "" if i == 0 else f"_{i - 1}"
        for name, v in zip(("loss_ce", "loss_mask", "loss_dice"), layer):
            out[name + suffix] = float(v.detach())
    return out


def _first_half(x, n: int):
    """``x``'s first ``n`` rows, through dicts and lists."""
    if isinstance(x, dict):
        return {k: _first_half(v, n) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_first_half(v, n) for v in x]
    return x[:n]


def run_reference(cfg: dict, seed: int, batches: List[dict], noises: List[dict], device,
                  rounding: str = "f32", against: dict = None, keep: bool = False,
                  in_program_place: bool = False, decoder_rounding: str = None,
                  zero_grad: str = None, half_loss: bool = False) -> dict:
    """The reference's three steps: losses, the first clipped gradient's
    norm and the change's norm after the steps, per trainable leaf, and the
    first step's numbers (``first_step_gaps``, under ``first_gaps``) against
    ``against``: the program's first step, or, ``in_program_place``, the
    float32 reference's, with this run in the program's place (a control or
    a planted fault). With ``keep``, its own first step on the host under
    ``first``. ``decoder_rounding``: the decoder's products alone rounded so.
    Planted faults: ``zero_grad`` names a leaf whose gradient is zeroed before
    each update; ``half_loss`` computes the forward on the whole batch and the
    loss over its first half alone (the mean taken over the rest)."""
    frozen = cfg["optimizer"]["freeze_keys"]
    task = tasks.load(cfg)
    with torch.device("meta"):
        model = Segmenter(cfg["model"], rounding, frozen)
    if decoder_rounding is not None:
        rnd = Rounding(decoder_rounding)
        for m in model.sem_seg_head.predictor.modules():
            if hasattr(m, "rnd"):
                m.rnd = rnd
    model.to_empty(device=device)
    model.load_state_dict(make_weights(cfg["model"], seed, device))
    model.train()
    named = [(n, p) for n, p in model.named_parameters()]
    for n, p in named:
        p.requires_grad_(not is_frozen(n, frozen))
    opt = ref_loss.AdamW(named, cfg["optimizer"], backbones.load(cfg["model"])[0].NO_DECAY)
    start = {n: p.detach().clone() for n, p in named if not is_frozen(n, frozen)}
    losses, grads, result = [], {}, {}
    with no_tf32():
        for step, (packed, noise) in enumerate(zip(batches, noises)):
            b = reference_batch(packed, cfg["image_size"], device, task)
            nz = {k: v.to(device) for k, v in noise.items()}
            model.zero_grad(set_to_none=True)
            out = model(b["image"], nz.get("drop_keep"))
            lout, tgt = out, b["targets"]
            if half_loss:
                h = b["targets"]["valid"].shape[0] // 2
                lout = {k: _first_half(out[k], h)
                        for k in ("pred_logits", "pred_masks", "aux_outputs")}
                tgt = _first_half(tgt, h)
                nz = {k: (v if k == "drop_keep" else v[:, :h]) for k, v in nz.items()}
            total, parts, shares = task.reference_loss(lout, tgt, nz, cfg["criterion"],
                                                       per_image=True)
            images = (image_gradients(shares, named)
                      if step == 0 and not in_program_place else None)
            total.backward()
            if zero_grad is not None:
                dict(named)[zero_grad].grad.zero_()
            g = opt.step()
            losses.append(float(total.detach()))
            if step == 0:
                grads = {n: float(v.norm()) for n, v in g.items()}
                first = first_step(out, loss_terms(parts), g, device, images, opt.scale)
                if against is not None:
                    result["first_gaps"] = (first_step_gaps(first, against) if in_program_place
                                            else first_step_gaps(against, first))
                if keep:
                    result["first"] = first_step(out, first["terms"], g, "cpu", images,
                                                 opt.scale)
                del first, images
            del out, lout, total, parts, shares, g
    change = {n: float((p.detach() - start[n]).norm()) for n, p in named if n in start}
    return {**result, "loss": losses, "grad": grads, "change": change}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Dict[str, float]:
    """Each leaf's gap of norms over the reference's norm of that leaf or of
    the median leaf, whichever is larger."""
    med = float(np.median(list(ref.values())))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in ref
            if keep is None or n in keep}


def _gaps(prog: dict, ref: dict):
    """(each step's loss gap, each leaf's gradient gap, each moving leaf's
    change gap)."""
    med = float(np.median(list(ref["grad"].values())))
    moving = {n for n, v in ref["grad"].items() if v >= 1e-3 * med}
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"])]
    return (losses, leaf_gaps(prog["grad"], ref["grad"]),
            leaf_gaps(prog["change"], ref["change"], moving))


def compare(prog: dict, ref: dict, first_gaps: Dict[str, float]) -> Dict[str, float]:
    """Every number of the module docstring, with the first step's numbers
    ``first_gaps`` (``first_step_gaps``)."""
    losses, grad, change = _gaps(prog, ref)
    return {**first_gaps, "loss_gap": max(losses), "loss_gap_first": losses[0],
            "grad_gap": max(grad.values()),
            "grad_gap_median": float(np.median(list(grad.values()))),
            "change_gap": max(change.values()),
            "change_gap_median": float(np.median(list(change.values())))}


def worst(prog: dict, ref: dict, n: int = 3) -> dict:
    """Where the worst cases lie: each step's loss gap and the leaves with
    the largest gradient and change gaps."""
    losses, grad, change = _gaps(prog, ref)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:n]  # noqa: E731
    return {"loss_steps": losses, "grad_leaves": top(grad), "change_leaves": top(change)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that ``limits`` names within its limit."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
