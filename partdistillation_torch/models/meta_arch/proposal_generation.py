"""Stage-2 pixel grouping: k-means "superpixel" part proposals from the
frozen backbone's features.

Counterpart of the JAX package's ``models/meta_arch/proposal_generation.py``
(the reference's ProposalGenerationModel and PixelGroupingModel):

  * the chosen Swin feature maps (res3 + res4), each bilinearly resized to
    the first one's 1/8 resolution and concatenated;
  * per image, k-means (k = 4) over the features inside the object mask,
    itself resized to 1/8 by nearest neighbour;
  * full-resolution labels: the nearest centroid ('dot' or 'l2') of the
    bilinearly upsampled features inside the full-resolution object mask;
    each cluster id gives one binary part mask.

The nearest-neighbour resize is ``nearest-exact`` (pixel centres, as
``jax.image.resize``); torch's ``nearest`` picks other pixels. The
full-resolution feature map stays in the backbone's dtype, and its products
with the f32 centroids are f32 (JAX promotes bf16 x f32 to f32); it is
built and labelled one image at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from ... import resolve_device
from ...ops.instance_post import as_bool_mask
from ...ops.kmeans import masked_kmeans
from ...utils.precision import full_f32
from ..layers import init_weights
from ..swin import SwinConfig, SwinTransformer
from .proposal import normalize_images

__all__ = ["ProposalGenerationConfig", "make_backbone", "make_generation_fn",
           "label_pixels", "resize_bilinear", "downsample_mask"]


@dataclasses.dataclass(frozen=True)
class ProposalGenerationConfig:
    swin: SwinConfig = SwinConfig()
    num_clusters: int = 4
    distance_metric: str = "dot"  # dot | l2 (labeling only; k-means is l2)


# The JAX package's defaults, which its CLI never changes: res3 at 1/8 and
# res4 resized to it, not normalised, 30 Lloyd iterations.
FEATURE_KEYS = ("res3", "res4")
KMEANS_ITERS = 30


def make_backbone(cfg: SwinConfig, device=None, seed: int = 0) -> SwinTransformer:
    """The bare Swin backbone on ``device`` (``cuda`` unless told otherwise),
    its weights drawn from ``seed``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        backbone = SwinTransformer(cfg)
    backbone.to_empty(device=dev)
    return init_weights(backbone, seed)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H', W', C) channel-last -> (B, h, w, C), bilinear at half-pixel
    centres (``jax.image.resize(..., "linear")`` when upsampling)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def downsample_mask(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W) bool -> (B, h, w) bool, nearest neighbour at pixel centres
    (``jax.image.resize(..., "nearest")``)."""
    return F.interpolate(mask.float()[:, None], size=(h, w), mode="nearest-exact")[:, 0] > 0.5


def label_pixels(feat_lo: torch.Tensor, centroids: torch.Tensor, h: int, w: int,
                 metric: str = "dot") -> torch.Tensor:
    """Nearest-centroid labels of one image at full resolution: the (h', w',
    D) feature map bilinearly upsampled to (h, w) in its dtype, its f32
    products with the (k, D) f32 centroids in full f32, 'dot' the largest
    product, 'l2' the largest 2ab - a^2 - b^2 -> (h, w) int64."""
    feat_hi = resize_bilinear(feat_lo[None], h, w)[0]
    with full_f32(feat_hi.device):
        ab = feat_hi.float() @ centroids.t()
    if metric == "dot":
        return ab.argmax(-1)
    aa = (feat_hi * feat_hi).sum(-1, keepdim=True)
    bb = (centroids * centroids).sum(-1)
    return (2.0 * ab - aa - bb).argmax(-1)


def make_generation_fn(cfg: ProposalGenerationConfig, backbone: SwinTransformer, device=None):
    """Returns ``gen_fn(batch, u) -> dict`` of batched tensors on ``device``
    (``cuda`` unless told otherwise): part_masks (B, k, H, W) bool,
    part_valid (B, k) bool, object_ratio (B,) f32.

    batch (numpy arrays or tensors): image (B, H, W, 3), object_mask
    (B, H, W) (the stage-1 object). u: (B, k) the k-means++ uniforms of each
    image (``ops.kmeans.seed_uniforms``).
    """
    dev = resolve_device(device)
    backbone = backbone.to(dev).eval()
    k = cfg.num_clusters

    def prepare_features(feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        base = feats[FEATURE_KEYS[0]]
        h, w = base.shape[1:3]
        return torch.cat([base] + [resize_bilinear(feats[key], h, w)
                                   for key in FEATURE_KEYS[1:]], dim=-1)

    def gen_fn(batch, u) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            images = torch.as_tensor(batch["image"], device=dev)
            obj_hi = as_bool_mask(torch.as_tensor(batch["object_mask"], device=dev))
            feat_lo = prepare_features(backbone(normalize_images(images)))
            b, h, w, d = feat_lo.shape
            obj_lo = downsample_mask(obj_hi, h, w).reshape(b, h * w)
            centroids, _ = masked_kmeans(feat_lo.reshape(b, h * w, d), obj_lo,
                                         torch.as_tensor(u, device=dev), KMEANS_ITERS)
            clusters = torch.arange(k, device=dev)[:, None, None]
            part_masks = torch.stack([
                (label_pixels(feat_lo[i], centroids[i], *obj_hi.shape[1:],
                              cfg.distance_metric)[None] == clusters) & obj_hi[i]
                for i in range(b)])
            # enough in-mask feature pixels for k-means (the reference needs
            # len(data) > k) and a non-empty part
            enough = obj_lo.sum(-1) > k
            return {"part_masks": part_masks,
                    "part_valid": part_masks.any(dim=(2, 3)) & enough[:, None],
                    "object_ratio": obj_hi.float().mean(dim=(1, 2))}

    return gen_fn
