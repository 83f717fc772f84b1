"""Dense-CRF mean-field inference, batched over images.

Counterpart of the JAX package's ``ops/dense_crf.py`` (no Pallas kernel lies
behind it: plain torch ops). The model is Krähenbühl and Koltun's dense CRF
with Potts compatibility; each mean-field update is

  Q_i(l) <- softmax_l( -U_i(l) + w_g * (G[Q](i,l) - Q_i(l)) + w_b * (B[Q](i,l) - Q_i(l)) )

with G a truncated separable Gaussian blur and B the joint-bilateral message.
The default bilateral filter (``bilateral_impl="conv"``) is a truncated
window at ``stride``-reduced resolution: the image and the values are
area-mean downsampled by ``stride`` (default ``round(sxy / 5)``), each cell
sums the exact Gaussian weights of every cell within 2.5 sigma, and the
message is scaled by ``stride**2`` and bilinearly upsampled. The window
weights depend on the image only, so ``dense_crf`` builds them once.

The JAX package applies the window by (2r+1)^2 shifted multiply-adds. Here
``_bilateral_conv_setup`` writes the weights of each cell row into a banded
matrix, (wl, ky * (wl + 2r)) per row of cells, so that one apply is one
batched product with the padded values' ky rows above and below, which are
one strided view. The products and the blur's convolution run inside
``utils.precision.full_f32``. ``bilateral_impl="grid"`` is the 5-D
bilateral grid (``bilateral_filter``), which no CLI selects.

Every function takes a leading batch axis: images (B, H, W, 3) in [0, 255],
values and unaries (B, H, W, L) channel-last, as the JAX package's (H, W, .)
with B in front.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.meta_arch.proposal_generation import resize_bilinear
from ..utils.precision import full_f32

__all__ = ["DenseCRFParams", "dense_crf", "mean_field_step", "bilateral_message_fn",
           "unary_from_masks", "gaussian_blur", "bilateral_filter", "bilateral_filter_conv"]


@dataclasses.dataclass(frozen=True)
class DenseCRFParams:
    gt_prob: float = 0.7
    iters: int = 10
    gauss_sxy: float = 3.0
    gauss_compat: float = 3.0
    bilateral_sxy: float = 20.0
    bilateral_srgb: float = 13.0
    bilateral_compat: float = 10.0
    # "conv" = the windowed filter at reduced resolution (default);
    # "grid" = the 5-D bilateral grid (exact colour resolution)
    bilateral_impl: str = "conv"
    # the window grid's cell size in pixels for "conv"; None = round(sxy / 5)
    bilateral_stride: Optional[int] = None


def _gauss_kernel_1d(sigma: float, device, dtype=torch.float32) -> torch.Tensor:
    radius = max(int(math.ceil(2.0 * sigma)), 1)
    x = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    return torch.exp(-0.5 * (x / sigma) ** 2)  # unnormalised: k(d) = exp(-d^2 / 2s^2)


def gaussian_blur(x: torch.Tensor, sigma: float, normalize: bool = False) -> torch.Tensor:
    """Separable Gaussian filter over the spatial axes of (B, H, W, C),
    zero-padded."""
    k = _gauss_kernel_1d(sigma, x.device, x.dtype)
    if normalize:
        k = k / k.sum()
    pad = (k.shape[0] - 1) // 2

    def conv_axis(arr, axis):
        moved = arr.movedim(axis, -1)
        flat = moved.reshape(-1, 1, moved.shape[-1])
        with full_f32(x.device):
            out = F.conv1d(flat, k.view(1, 1, -1), padding=pad)
        return out.reshape(moved.shape).movedim(-1, axis)

    return conv_axis(conv_axis(x, 1), 2)


def _splat_blur_slice(coords: torch.Tensor, values: torch.Tensor,
                      grid_shape: Tuple[int, ...]) -> torch.Tensor:
    """Multilinear splat of ``values`` (N, C) at fractional cell ``coords``
    (N, D) into a dense grid, a sigma = 1 cell blur along each axis (three
    taps), multilinear slice back -> (N, C)."""
    n, d = coords.shape
    c = values.shape[-1]
    dev = coords.device
    strides, total = [], 1
    for s in reversed(grid_shape):
        strides.append(total)
        total *= s
    strides = torch.tensor(list(reversed(strides)), dtype=torch.int64, device=dev)
    lo = torch.floor(coords)
    frac = coords - lo
    lo = lo.long()
    max_idx = torch.tensor([s - 1 for s in grid_shape], dtype=torch.int64, device=dev)

    corner_idx, corner_w = [], []
    for corner in range(1 << d):
        bits = torch.tensor([(corner >> k) & 1 for k in range(d)], dtype=torch.int64, device=dev)
        idx = torch.minimum(torch.clamp(lo + bits, min=0), max_idx)
        wgt = torch.where(bits == 1, frac, 1.0 - frac).prod(1)
        corner_idx.append((idx * strides).sum(1))
        corner_w.append(wgt)
    corner_idx = torch.stack(corner_idx)  # (2^D, N)
    corner_w = torch.stack(corner_w)  # (2^D, N)

    grid = values.new_zeros((total, c))
    grid.index_add_(0, corner_idx.reshape(-1), (corner_w[..., None] * values[None]).reshape(-1, c))
    grid = grid.reshape(*grid_shape, c)

    w0 = math.exp(-0.5)
    with full_f32(dev):
        for axis in range(d):
            s = grid.shape[axis]
            i = torch.arange(s, device=dev)
            diff = (i[:, None] - i[None, :]).abs()
            band = torch.where(diff == 0, 1.0, torch.where(diff == 1, w0, 0.0)).to(values.dtype)
            grid = torch.tensordot(grid, band, dims=([axis], [0])).movedim(-1, axis)
        flat = grid.reshape(total, c)
        return torch.einsum("kn,knc->nc", corner_w, flat[corner_idx])


def bilateral_filter(image: torch.Tensor, values: torch.Tensor, sxy: float,
                     srgb: float) -> torch.Tensor:
    """Joint-bilateral filtering of (B, H, W, C) ``values`` guided by
    (B, H, W, 3) ``image`` through a 5-D bilateral grid, one image at a time:
    the unnormalised message sum_j k(i, j) v_j."""
    b, h, w, c = values.shape
    gy = max(int(math.ceil(h / sxy)) + 2, 2)
    gx = max(int(math.ceil(w / sxy)) + 2, 2)
    gc = max(int(math.ceil(255.0 / srgb)) + 2, 2)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=values.device),
                            torch.arange(w, dtype=torch.float32, device=values.device),
                            indexing="ij")
    out = []
    for i in range(b):
        im = image[i]
        coords = torch.stack([
            torch.clamp(yy / sxy, 0.0, gy - 1.0),
            torch.clamp(xx / sxy, 0.0, gx - 1.0),
            torch.clamp(im[..., 0] / srgb, 0.0, gc - 1.0),
            torch.clamp(im[..., 1] / srgb, 0.0, gc - 1.0),
            torch.clamp(im[..., 2] / srgb, 0.0, gc - 1.0),
        ], dim=-1).reshape(-1, 5)
        out.append(_splat_blur_slice(coords, values[i].reshape(-1, c),
                                     (gy, gx, gc, gc, gc)).reshape(h, w, c))
    return torch.stack(out)


def _area_mean(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, H, W, C), H and W multiples of ``stride`` -> the mean of each
    stride x stride cell."""
    if stride == 1:
        return x
    b, h, w, c = x.shape
    return x.reshape(b, h // stride, stride, w // stride, stride, c).mean((2, 4))


def _bilateral_conv_setup(image: torch.Tensor, sxy: float, srgb: float,
                          stride: Optional[int] = None, truncate: float = 2.5):
    """The window weights of a batch of guide images, built once per image.

    Returns (band, geom): ``band`` (B, hl, wl, ky * (wl + 2r)) f32, row w of
    cell row h holding, at column dy * (wl + 2r) + w + dx, the weight
    exp(-(dy'^2 + dx'^2) / 2 s^2 - |c(h + dy', w + dx') - c(h, w)|^2 / 2 srgb^2)
    of the cell at offset (dy', dx') = (dy - r, dx - r) (cells outside the
    image hold the colour 0), zeros elsewhere; ``geom`` is (h, w, hl, wl,
    stride, r)."""
    b, h, w, _ = image.shape
    if stride is None:
        stride = max(1, int(round(sxy / 5.0)))
    ph, pw = (-h) % stride, (-w) % stride
    if ph or pw:  # the image's edge pixels repeat (JAX: mode="edge")
        image = F.pad(image.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate")
        image = image.permute(0, 2, 3, 1)
    img_lo = _area_mean(image, stride)
    hl, wl = img_lo.shape[1:3]

    s_lo = sxy / stride
    r = max(int(math.ceil(truncate * s_lo)), 1)
    k = 2 * r + 1
    wp = wl + 2 * r
    padded = F.pad(img_lo, (0, 0, r, r, r, r))  # zeros outside the image
    dx2 = torch.arange(-r, r + 1, dtype=image.dtype, device=image.device) ** 2
    inv2ss = 0.5 / (s_lo * s_lo)
    inv2sr = 0.5 / (srgb * srgb)

    band = image.new_zeros((b, hl, wl, k, wp))
    # the (w, dx) band of each (b, h, dy) block: column w + dx of row w
    sb = band.stride()
    diag = band.as_strided((b, hl, wl, k, k), (sb[0], sb[1], sb[2] + 1, sb[3], 1))
    for dy in range(k):
        window = padded[:, dy:dy + hl].unfold(2, k, 1)  # (B, hl, wl, 3, k)
        d2c = ((window - img_lo[..., None]) ** 2).sum(3)
        diag[:, :, :, dy] = torch.exp(-(float(dy - r) ** 2 + dx2) * inv2ss - d2c * inv2sr)
    return band.reshape(b, hl, wl, k * wp), (h, w, hl, wl, stride, r)


def _bilateral_conv_apply(values: torch.Tensor, band: torch.Tensor, geom) -> torch.Tensor:
    """Apply the window weights of ``_bilateral_conv_setup`` to (B, H, W, C)
    values: for each image and cell row h, band[h] (wl, ky (wl + 2r)) times
    the zero-padded cell values' rows h .. h + 2r, (ky (wl + 2r), C)."""
    h, w, hl, wl, stride, r = geom
    b, _, _, c = values.shape
    ph, pw = hl * stride - h, wl * stride - w
    if ph or pw:
        values = F.pad(values, (0, 0, 0, pw, 0, ph))
    # zero padding zeroes the contributions from outside the image outright
    pv = F.pad(_area_mean(values, stride), (0, 0, r, r, r, r)).contiguous()
    wp = wl + 2 * r
    rows = pv.as_strided((b, hl, (2 * r + 1) * wp, c), (pv.stride(0), wp * c, c, 1))
    with full_f32(values.device):
        msg = torch.stack([torch.bmm(band[i], rows[i]) for i in range(b)])
    msg = msg * float(stride * stride)
    if stride > 1:
        msg = resize_bilinear(msg, hl * stride, wl * stride)
    return msg[:, :h, :w]


def bilateral_filter_conv(image: torch.Tensor, values: torch.Tensor, sxy: float,
                          srgb: float, stride: Optional[int] = None,
                          truncate: float = 2.5) -> torch.Tensor:
    """Joint-bilateral filtering of (B, H, W, C) ``values`` guided by
    (B, H, W, 3) ``image`` as a truncated window at ``stride``-reduced
    resolution: the unnormalised message sum_j k(i, j) v_j, like
    ``bilateral_filter``."""
    band, geom = _bilateral_conv_setup(image, sxy, srgb, stride, truncate)
    return _bilateral_conv_apply(values, band, geom)


def unary_from_masks(masks: torch.Tensor, valid: torch.Tensor, gt_prob: float) -> torch.Tensor:
    """Part masks -> unary -log probabilities (B, H, W, T + 1).

    masks (B, T, H, W) bool (or float, thresholded at 0.5), valid (B, T):
    the valid masks merge into one label image (background 0, mask t label
    t + 1, a later mask over an earlier one), and each pixel's label gets
    probability ``gt_prob``, the others share the rest (pydensecrf's
    ``unary_from_labels``)."""
    b, t, h, w = masks.shape
    if masks.dtype != torch.bool:
        masks = masks > 0.5
    m = masks & valid.bool()[:, :, None, None]
    label = torch.zeros((b, h, w), dtype=torch.int64, device=masks.device)
    for i in range(t):
        label = torch.where(m[:, i], i + 1, label)
    n_labels = t + 1
    p_other = (1.0 - gt_prob) / (n_labels - 1)
    onehot = F.one_hot(label, n_labels).float()
    probs = onehot * gt_prob + (1.0 - onehot) * p_other
    return -torch.log(probs)


def bilateral_message_fn(image: torch.Tensor, params: DenseCRFParams):
    """The bilateral message q -> B[q] of ``params.bilateral_impl`` for the
    guide images (B, H, W, 3); "conv" builds the window weights here, once."""
    if params.bilateral_impl == "conv":
        band, geom = _bilateral_conv_setup(image, params.bilateral_sxy, params.bilateral_srgb,
                                           params.bilateral_stride)
        return lambda q: _bilateral_conv_apply(q, band, geom)
    if params.bilateral_impl == "grid":
        return lambda q: bilateral_filter(image, q, params.bilateral_sxy, params.bilateral_srgb)
    raise ValueError(f"unknown bilateral_impl {params.bilateral_impl!r}")


def mean_field_step(q: torch.Tensor, log_unary: torch.Tensor, bilat,
                    params: DenseCRFParams) -> torch.Tensor:
    """One mean-field update of Q (B, H, W, L) from the log-probabilities -U
    and the bilateral message ``bilat``."""
    m_gauss = gaussian_blur(q, params.gauss_sxy) - q  # k(i, i) = 1 taken out
    m_bilat = bilat(q) - q
    logits = log_unary + params.gauss_compat * m_gauss + params.bilateral_compat * m_bilat
    return torch.softmax(logits, dim=-1)


def dense_crf(image: torch.Tensor, unary: torch.Tensor,
              params: DenseCRFParams = DenseCRFParams()) -> torch.Tensor:
    """Mean-field dense CRF: image (B, H, W, 3) in [0, 255], unary
    (B, H, W, L) -log p -> the refined label probabilities Q (B, H, W, L)."""
    log_unary = -unary.float()
    bilat = bilateral_message_fn(image.float(), params)
    q = torch.softmax(log_unary, dim=-1)
    for _ in range(params.iters):
        q = mean_field_step(q, log_unary, bilat, params)
    return q
