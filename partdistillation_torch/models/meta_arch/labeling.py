"""Stage-1 object labelling (the reference's LabelingDetic).

Counterpart of the JAX package's ``models/meta_arch/labeling.py``:

* a detector runs over each ImageNet image; the detections whose class is
  the image's synset are kept, all of them when none is
  (labeling_detic.py:64-77); the ``topk`` best by score are saved as
  ``{object_masks (RLE), scores, pred_classes, pred_names, class_code}``;
* the detector from pixels (``make_proposal_detection_fn``) is the
  class-agnostic Mask2Former segmenter: the best non-void class probability
  of each query, its top-k queries, their mask logits resized to the image,
  ``> 0``; the open-vocabulary class of each mask comes from CLIP: the image
  embedding of the mask's bounding-box crop against the text embeddings of
  the class names (``clip_region_scorer_device`` on the port's towers,
  ``clip_region_scorer`` through transformers' ``CLIPModel`` on the host);
* ``precomputed_detector`` reads a store of detections.

The device crop is ``jax.image.scale_and_translate(..., "linear")`` with
JAX's antialiasing: its per-crop (crop, H) and (crop, W) weights
(``ops.resize.compute_weight_mat``) applied by two f32 products in full f32
precision; an empty mask crops the whole image. The host crop
(``crop_backend="host"``, JAX's ``clip_region_scorer_jax(crop_backend=
"host")``) cuts each mask's bounding box out of the uint8 image and resizes
it with PIL's bilinear filter, as the reference's preprocessing does.
``transformers`` is imported only where a checkpoint is read.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ... import resolve_device
from ...ops.resize import compute_weight_mat, triangle_kernel
from ...data.transforms import resize_image
from ...utils.bitpack import pack_bits
from ...utils.precision import full_f32
from ..clip_vit import normalize_clip_pixels
from .proposal import normalize_images, stable_topk

__all__ = ["LabelingConfig", "select_class_matched_topk", "make_proposal_detection_fn",
           "crop_regions", "crop_regions_host", "clip_region_scorer_device",
           "load_clip_region_scorer", "clip_region_scorer", "clip_text_classifier", "clip_text_classifier_from",
           "clip_text_classifier_device", "segmenter_detector", "precomputed_detector",
           "run_labeling", "run_labeling_batched"]


@dataclasses.dataclass(frozen=True)
class LabelingConfig:
    topk: int = 10
    score_threshold: float = 0.0
    match_classes: bool = True  # the class match, with the keep-all fallback


def select_class_matched_topk(scores: torch.Tensor, class_ids: torch.Tensor,
                              valid: torch.Tensor, target_class,
                              cfg: LabelingConfig = LabelingConfig()):
    """(N,) detections -> (topk,) indices, scores and validity: the class
    matches first, all detections when none matches, ranked by score."""
    valid = valid & (scores >= cfg.score_threshold)
    pool = valid
    if cfg.match_classes:
        matched = valid & (class_ids == target_class)
        pool = torch.where(matched.any(), matched, valid)
    ranked = torch.where(pool, scores, torch.full_like(scores, float("-inf")))
    top_scores, top_idx = stable_topk(ranked, cfg.topk)
    return top_idx, top_scores, top_scores > float("-inf")


def make_proposal_detection_fn(model_cfg, model, device=None):
    """The stage-1 detector's forward on ``device`` (``cuda`` unless told
    otherwise): ``fn(images (B, H, W, 3) uint8 or float) -> {masks (B, K, H,
    W) bool, masks_packed (B, K, H, ceil(W / 8)) uint8, scores (B, K), valid
    (B, K)}``, K = ``model_cfg.test_topk``, with ``fn.device``. The
    class-agnostic segmenter's best non-void class probability of each query
    is its score (the softmax in f32)."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    topk = model_cfg.test_topk

    def fn(images) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            images = torch.as_tensor(images, device=dev)
            out = model(normalize_images(images))
            h, w = images.shape[1:3]
            scores = torch.softmax(out["pred_logits"].float(), dim=-1)[..., :-1].amax(-1)
            scores, idx = stable_topk(scores, topk)
            ml = out["pred_masks"]
            ml = ml.gather(1, idx[:, :, None, None].expand(-1, -1, *ml.shape[2:]))
            masks = F.interpolate(ml.float(), size=(h, w), mode="bilinear",
                                  align_corners=False) > 0.0
            return {"masks": masks, "masks_packed": pack_bits(masks), "scores": scores,
                    "valid": masks.any(dim=(2, 3))}

    fn.device = dev
    return fn


def _first_true(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8).argmax(-1)


def crop_regions(images: torch.Tensor, masks: torch.Tensor, crop_size: int) -> torch.Tensor:
    """The bounding-box crop of each mask, resized to crop_size^2 as JAX's
    ``scale_and_translate(..., method="linear")`` (antialiased): images
    (B, H, W, 3) f32, masks (B, K, H, W) bool -> (B, K, crop, crop, 3) f32.
    An empty mask crops the whole image."""
    b, k, h, w = masks.shape
    ys, xs = masks.any(3), masks.any(2)
    empty = ~ys.any(-1)
    zero = torch.zeros_like(empty, dtype=torch.float32)
    y0 = torch.where(empty, zero, _first_true(ys).float())
    y1 = torch.where(empty, zero + h, h - _first_true(ys.flip(-1)).float())
    x0 = torch.where(empty, zero, _first_true(xs).float())
    x1 = torch.where(empty, zero + w, w - _first_true(xs.flip(-1)).float())
    sy, sx = crop_size / (y1 - y0), crop_size / (x1 - x0)
    wy = compute_weight_mat(h, crop_size, sy, -y0 * sy, triangle_kernel, True)  # (B, K, H, c)
    wx = compute_weight_mat(w, crop_size, sx, -x0 * sx, triangle_kernel, True)  # (B, K, W, c)
    with full_f32(images.device):
        rows = (wy.transpose(-1, -2).reshape(b, k * crop_size, h)
                @ images.float().reshape(b, h, w * 3))
        rows = rows.reshape(b * k, crop_size, w, 3).permute(0, 1, 3, 2).reshape(
            b * k, crop_size * 3, w)
        out = rows @ wx.reshape(b * k, w, crop_size)  # (B K, c 3, c)
    return out.reshape(b, k, crop_size, 3, crop_size).permute(0, 1, 2, 4, 3)


def crop_regions_host(images: np.ndarray, masks: np.ndarray, crop_size: int) -> np.ndarray:
    """The bounding-box crop of each mask, resized to crop_size^2 by PIL's
    bilinear filter on the host: images (B, H, W, 3) uint8, masks
    (B, K, H, W) bool -> (B, K, crop, crop, 3) f32 in [0, 255]. An empty
    mask crops the whole image (as ``crop_regions``)."""
    images, masks = np.asarray(images), np.asarray(masks, bool)
    b, k = masks.shape[:2]
    out = np.zeros((b, k, crop_size, crop_size, 3), np.float32)
    for i in range(b):
        for j in range(k):
            ys, xs = np.nonzero(masks[i, j])
            box = (slice(ys.min(), ys.max() + 1), slice(xs.min(), xs.max() + 1)) if len(ys) \
                else (slice(None), slice(None))
            out[i, j] = resize_image(images[i][box], (crop_size, crop_size))
    return out


def clip_region_scorer_device(vision_tower, text_emb, crop_backend: str = "device"):
    """Region scorer on the port's CLIP vision tower: ``scorer(image (H, W, 3),
    masks (N, H, W)) -> (class_ids (N,) int32, probs (N,) f32)`` as numpy,
    the softmax over 100 x the cosine similarity with the (C, D)
    L2-normalised ``text_emb``; ``scorer.batched(images (B, H, W, 3), masks
    (B, K, H, W))`` -> numpy (B, K) arrays and ``scorer.batched_async`` the
    same as tensors on the tower's device, without a sync. Images are
    [0, 255] (uint8 or float); the crops, at the tower's image size, go to
    it CLIP-normalised. ``crop_backend``: "device" (``crop_regions`` on the
    tower's device) or "host" (``crop_regions_host``: PIL on the host, the
    image taken as uint8)."""
    if crop_backend not in ("device", "host"):
        raise ValueError(f"crop_backend must be 'device' or 'host', got {crop_backend!r}")
    dev = vision_tower.visual_projection.weight.device
    crop = vision_tower.cfg.image_size
    text = torch.as_tensor(np.asarray(text_emb), dtype=torch.float32, device=dev)

    def crops_of(images, masks) -> torch.Tensor:
        if crop_backend == "host":
            images = torch.as_tensor(images).cpu().numpy().astype(np.uint8)
            return torch.from_numpy(crop_regions_host(
                images, torch.as_tensor(masks).cpu().numpy(), crop)).to(dev)
        return crop_regions(torch.as_tensor(images, device=dev).float(),
                            torch.as_tensor(masks, device=dev).bool(), crop)

    def batched_async(images, masks):
        with torch.inference_mode():
            b, k = masks.shape[:2]
            crops = crops_of(images, masks) / 255.0
            emb = vision_tower(normalize_clip_pixels(crops.reshape(b * k, crop, crop, 3)))
            emb = emb.float()
            emb = emb / emb.norm(dim=-1, keepdim=True)
            with full_f32(dev):
                sims = emb @ text.t()
            probs = torch.softmax(100.0 * sims, dim=-1)
            return (probs.argmax(-1).int().reshape(b, k),
                    probs.amax(-1).reshape(b, k))

    def batched(images, masks):
        ids, probs = batched_async(images, masks)
        return ids.cpu().numpy(), probs.cpu().numpy()

    def scorer(image, masks):
        masks = torch.as_tensor(masks, device=dev)
        if masks.shape[0] == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.float32)
        ids, probs = batched(torch.as_tensor(image, device=dev)[None], masks[None])
        return ids[0], probs[0]

    scorer.batched = batched
    scorer.batched_async = batched_async
    return scorer


def _import_transformers():
    try:
        import transformers
    except ImportError as e:
        raise SystemExit("reading a CLIP checkpoint (--clip-model) needs the transformers "
                         "package, which is not installed") from e
    return transformers


def _prompts(class_names, template: str):
    return [template.format(str(n).replace("_", " ")) for n in class_names]


def clip_text_classifier(class_names, clip_model_path: str, template: str = "a {}") -> np.ndarray:
    """(C, D) L2-normalised CLIP text embeddings of the class names through
    transformers' ``CLIPModel`` from a local checkpoint directory."""
    tf = _import_transformers()
    model = tf.CLIPModel.from_pretrained(clip_model_path)
    processor = tf.CLIPProcessor.from_pretrained(clip_model_path)
    return clip_text_classifier_from(model, processor, class_names, template)


def clip_text_classifier_from(model, processor, class_names, template: str = "a {}"):
    """As ``clip_text_classifier``, from a loaded HF model and processor."""
    with torch.no_grad():
        inputs = processor(text=_prompts(class_names, template), return_tensors="pt",
                           padding=True)
        emb = model.get_text_features(**inputs)
        emb = emb / emb.norm(dim=-1, keepdim=True)
    return emb.numpy()


def clip_text_classifier_device(text_tower, token_ids, batch: int = 256) -> np.ndarray:
    """(C, D) L2-normalised text embeddings of (C, T) token ids through the
    port's text tower, ``batch`` prompts at a time (f32 products in full f32
    for an f32 tower)."""
    out = []
    with torch.inference_mode():
        for s in range(0, len(token_ids), batch):
            emb = text_tower(np.asarray(token_ids[s:s + batch])).float()
            out.append((emb / emb.norm(dim=-1, keepdim=True)).cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, text_tower.cfg.projection_dim),
                                                    np.float32)


def load_clip_region_scorer(clip_model_path: str, class_names, template: str = "a {}",
                            dtype=torch.bfloat16, device=None):
    """The device scorer from a local transformers CLIP checkpoint: both
    towers built on ``device`` with the checkpoint's weights (the vision
    tower in ``dtype``, the text tower in f32); the class names' prompts
    tokenised by the checkpoint's processor to the text window."""
    from ..clip_text import CLIPTextTower, text_config_from_hf
    from ..clip_vit import CLIPVisionTower, config_from_hf

    tf = _import_transformers()
    dev = resolve_device(device)
    model = tf.CLIPModel.from_pretrained(clip_model_path).eval()
    processor = tf.CLIPProcessor.from_pretrained(clip_model_path)
    sd = model.state_dict()
    # a full CLIPModel's projection widths are the top-level config's: read
    # them off the weights
    tcfg = dataclasses.replace(text_config_from_hf(model.config.text_config),
                               projection_dim=sd["text_projection.weight"].shape[0])
    vcfg = dataclasses.replace(config_from_hf(model.config.vision_config), dtype=dtype,
                               projection_dim=sd["visual_projection.weight"].shape[0])
    text_tower = CLIPTextTower(tcfg, device=dev)
    text_tower.load_state_dict(sd, strict=False)
    vision_tower = CLIPVisionTower(vcfg, device=dev)
    vision_tower.load_state_dict(sd, strict=False)
    del model
    ids = processor(text=_prompts(class_names, template), return_tensors="np",
                    padding="max_length", truncation=True,
                    max_length=tcfg.max_positions)["input_ids"]
    text_emb = clip_text_classifier_device(text_tower, ids)
    return clip_region_scorer_device(vision_tower, text_emb)


def clip_region_scorer(clip_model_path: str, class_names, template: str = "a {}") -> Callable:
    """Region classifier on the host through transformers' ``CLIPModel``
    (the processor's resize and crop of each mask's bounding box):
    ``scorer(image (H, W, 3) uint8, masks (N, H, W) bool) -> (class_ids,
    probs)``."""
    tf = _import_transformers()
    model = tf.CLIPModel.from_pretrained(clip_model_path).eval()
    processor = tf.CLIPProcessor.from_pretrained(clip_model_path)
    text_emb = torch.from_numpy(clip_text_classifier_from(model, processor, class_names,
                                                          template))

    def scorer(image, masks):
        image, masks = np.asarray(image), np.asarray(masks)
        crops = []
        for m in masks:
            ys, xs = np.nonzero(m)
            crops.append(image[ys.min():ys.max() + 1, xs.min():xs.max() + 1])
        with torch.no_grad():
            emb = model.get_image_features(**processor(images=crops, return_tensors="pt"))
            emb = emb / emb.norm(dim=-1, keepdim=True)
            sims = (emb @ text_emb.T).numpy()
        probs = np.exp(100.0 * sims)
        probs = probs / probs.sum(-1, keepdims=True)
        return probs.argmax(-1).astype(np.int32), probs.max(-1).astype(np.float32)

    return scorer


def segmenter_detector(detection_fn, image_size: int,
                       region_scorer: Optional[Callable] = None) -> Callable:
    """Per-image detector from pixels: the segmenter's proposals, their
    scores times the region scorer's class probability when one is given."""
    from ...data.transforms import load_image, resize_image

    def detector(item: dict) -> Optional[dict]:
        image = load_image(item["file_name"])
        if image is None:
            return None
        image = resize_image(image, (image_size, image_size))
        out = detection_fn(np.array(image[None]))
        keep = out["valid"][0].cpu().numpy()
        masks = out["masks"][0].cpu().numpy()[keep]
        scores = out["scores"][0].float().cpu().numpy()[keep]
        if len(scores) == 0:
            return {"masks": masks, "scores": scores, "class_ids": scores.astype(np.int32)}
        if region_scorer is not None:
            class_ids, probs = region_scorer(image, masks)
            scores = scores * probs
        else:
            class_ids = np.full(len(scores), -1, np.int32)
        return {"masks": masks, "scores": scores, "class_ids": class_ids}

    return detector


def precomputed_detector(detections_store_dir: str) -> Callable[[dict], Optional[dict]]:
    """A store of precomputed detections as a detector; records hold
    {image_id, masks (RLE list), scores, class_ids | pred_names}."""
    from ...data.pseudo_store import PseudoLabelStore
    from ...utils import rle as rle_codec

    store = PseudoLabelStore(detections_store_dir)

    def detector(item: dict) -> Optional[dict]:
        record = store.get(item["image_id"])
        if record is None:
            return None
        masks = np.stack([rle_codec.decode(r) for r in record["masks"]]).astype(bool)
        return {"masks": masks,
                "scores": np.asarray(record["scores"], np.float32),
                "class_ids": np.asarray(record.get("class_ids", [-1] * len(masks)), np.int32),
                "pred_names": record.get("pred_names")}

    return detector


def run_labeling(detector: Callable[[dict], Optional[dict]], items, writer,
                 cfg: LabelingConfig = LabelingConfig()) -> Dict[str, int]:
    """Stage 1 one image at a time: detect -> class match -> top-k -> RLE
    record. Images the store already holds are skipped."""
    from ...utils import rle as rle_codec

    n_saved = n_skipped = n_empty = 0
    for item in items:
        if item["image_id"] in writer:
            n_skipped += 1
            continue
        if _save_detection(detector(item), item, writer, cfg, rle_codec):
            n_saved += 1
        else:
            n_empty += 1
    writer.flush()
    return {"saved": n_saved, "skipped": n_skipped, "empty": n_empty}


def _save_detection(det, item, writer, cfg, rle_codec) -> bool:
    """Class match + top-k + one RLE record; False when nothing is kept."""
    if det is None or len(det["scores"]) == 0:
        return False
    scores = np.asarray(det["scores"], np.float32)
    class_ids = np.asarray(det["class_ids"], np.int32)
    target = int(item.get("class_id", -1))
    # the threshold goes first: a matched detection below it must not block
    # the keep-all fallback
    valid = scores >= cfg.score_threshold
    if cfg.match_classes:
        matched = valid & (class_ids == target)
        pool = matched if matched.any() else valid
    else:
        pool = valid
    if not pool.any():
        return False
    ranked = np.where(pool, scores, -np.inf)
    order = np.argsort(-ranked)[:cfg.topk]
    order = order[ranked[order] > -np.inf]
    names = det.get("pred_names")
    writer.write({
        "image_id": item["image_id"],
        "object_masks": [rle_codec.encode(det["masks"][i]) for i in order],
        "scores": [float(scores[i]) for i in order],
        "pred_classes": [int(class_ids[i]) for i in order],
        "pred_names": [names[i] for i in order] if names else None,
        "class_code": item.get("class_code"),
    })
    return True


def run_labeling_batched(detection_fn, items, writer, cfg: LabelingConfig = LabelingConfig(),
                         region_scorer: Optional[Callable] = None, image_size: int = 640,
                         batch_size: int = 8, num_workers: int = 4) -> Dict[str, int]:
    """Stage 1 over batches, one batch behind: batch i + 1's images are
    loaded and its detector and scorer launched, and their results' copies to
    the host queued, before batch i's results are read and saved, so that
    the host's decoding, RLE encoding and writes overlap the device's work.
    Only the bit-packed masks, the scores, the validity and the scorer's
    class ids and probabilities leave the device."""
    from concurrent.futures import ThreadPoolExecutor

    from ...data.transforms import load_image, resize_image
    from ...utils import rle as rle_codec

    todo = [it for it in items if it["image_id"] not in writer]
    n_skipped = len(items) - len(todo)
    n_saved = n_empty = 0
    dev = detection_fn.device
    score_async = None
    if region_scorer is not None:
        score_async = getattr(region_scorer, "batched_async", None) or getattr(
            region_scorer, "batched", None)

    def load(item):
        image = load_image(item["file_name"])
        return None if image is None else resize_image(image, (image_size, image_size))

    def dispatch(chunk, images):
        """Launch one batch's device work and queue its results' copies."""
        nonlocal n_empty
        keep = [i for i, im in enumerate(images) if im is not None]
        n_empty += len(chunk) - len(keep)
        if not keep:
            return None
        batch = np.stack([images[i] for i in keep]).astype(np.uint8)
        if len(keep) < batch_size:  # one batch shape
            batch = np.concatenate([batch, np.zeros((batch_size - len(keep),) + batch.shape[1:],
                                                    np.uint8)])
        batch_dev = torch.from_numpy(batch).to(dev)
        out = detection_fn(batch_dev)
        down = {k: out[k] for k in ("masks_packed", "scores", "valid")}
        if score_async is not None:
            down["ids"], down["probs"] = (torch.as_tensor(v) for v in score_async(batch_dev,
                                                                                  out["masks"]))
        host = {k: v.to("cpu", non_blocking=True) for k, v in down.items()}
        ready = None
        if dev.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return {"chunk": chunk, "keep": keep, "batch_dev": batch_dev, "out": out,
                "host": host, "ready": ready}

    def drain(p):
        """Read one batch's results and save them."""
        nonlocal n_saved, n_empty
        if p["ready"] is not None:
            p["ready"].synchronize()
        host = p["host"]
        w = p["batch_dev"].shape[2]
        packed = host["masks_packed"].numpy()
        for bi, i in enumerate(p["keep"]):
            item = p["chunk"][i]
            scores = host["scores"][bi].float().numpy()
            valid = host["valid"][bi].numpy()
            if "ids" in host:
                class_ids, probs = host["ids"][bi].numpy(), host["probs"][bi].float().numpy()
                scores = scores * probs
            elif region_scorer is not None:
                class_ids, probs = region_scorer(p["batch_dev"][bi], p["out"]["masks"][bi])
                scores = scores * probs
            else:
                class_ids = np.full(len(scores), -1, np.int32)
            masks = np.unpackbits(packed[bi], axis=-1)[..., :w].astype(bool)
            det = {"masks": masks[valid], "scores": scores[valid],
                   "class_ids": np.asarray(class_ids, np.int32)[valid]}
            if _save_detection(det, item, writer, cfg, rle_codec):
                n_saved += 1
            else:
                n_empty += 1

    pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
    try:
        chunks = [todo[s:s + batch_size] for s in range(0, len(todo), batch_size)]
        futures = [pool.submit(load, it) for it in chunks[0]] if chunks else []
        pending = None
        for ci, chunk in enumerate(chunks):
            images = [f.result() for f in futures]
            if ci + 1 < len(chunks):  # the next batch's images load meanwhile
                futures = [pool.submit(load, it) for it in chunks[ci + 1]]
            current = dispatch(chunk, images)
            if pending is not None:
                drain(pending)  # batch i - 1's host work overlaps batch i
            pending = current
        if pending is not None:
            drain(pending)
    finally:
        pool.shutdown()
    writer.flush()
    return {"saved": n_saved, "skipped": n_skipped, "empty": n_empty}
