"""Deformable-attention bilinear sampling: the P-folded kernel
(``csrc/msda_folded.cu``) and the per-tap kernel (``csrc/msda_taps.cu``),
each with its plain version.

Counterpart of the JAX package's ``ops/msda_pallas.py``:

- ``msda_folded`` samples every level of one MSDeformAttn call in one launch
  of the P-folded kernel, reading the value tensor in the (B, S, M, D) layout
  that the value projection emits and the locations and weights as
  ``MSDeformAttn`` makes them. ``sample_level_folded`` is the one-level case
  of the same launcher, in the JAX package's ``sample_level_folded`` layout.
- ``sample_level`` is the per-tap function of the JAX package's
  ``sample_level``, whose two variants ("expand" and "sel") compute the same
  function and differ only in how the TPU assembles it; one kernel serves
  both.

Numerics, kernels and plain versions alike: pixel = loc * size - 0.5
(align_corners=False), f32 corner weights w_y * w_x * attw, corners outside
the map read zero, f32 accumulation over corners, points and levels, one
rounding to the value dtype at the end (as the JAX package's
``_ms_deform_attn_pallas_folded`` accumulates). The plain versions gather
the four corners; the JAX package's dense hat matrix computes the same
function and exists only because a TPU has no fast gather.

With a ``band`` (``ops/ms_deform_attn.msda_band_table``, encoder
self-attention: queries = pixels) the function is the JAX package's
``banded`` sampling: a corner outside its query's band of rows (and, in a
2-D plan, columns) of the sampling level reads zero, as a corner off the map
does. ``msda_folded_banded_plain`` and ``msda_folded_banded_grouped_plain``
are its plain version and its kernel order; the kernel's banded variant is a
separate instantiation that reads the bounds table, so the dense path reads
none.

``msda_folded_grouped_plain`` is the P-folded kernel's algorithm in PyTorch:
the same function summed in the kernel's order (per-group f32 partials over
taps g, g + G, ..., then a fixed pairwise sum of the groups), each corner
added by the kernel's fused multiply-add rounded once, so that the kernel
returns its result bit for bit. ``msda_lane_plan`` picks the lane layout
both kernels read corner rows with (``csrc/msda.cuh``).

CPU tensors take the plain version, differentiated by autograd. CUDA
tensors take the kernel (bf16 values). ``msda_folded``'s gradient there is
the backward kernel's (``csrc/msda_folded_bwd.cu``, ``msda_folded_backward``;
an addition of the port: the JAX package's ``custom_vjp`` differentiates an
XLA composition): dvalue accumulated in f32 and rounded once to value's
dtype, dloc in f32, dattw in the weights' dtype. ``msda_folded_backward_plain``
is that algorithm in PyTorch. The one-level and per-tap wrappers stay
differentiable through the VJP of their plain versions recomputed from the
saved inputs. All three route as the op ``msda`` (``ops/autograd.route``).
The launch counters (``ops/autograd.LAUNCHES``): ``msda_folded`` every
launch of the P-folded kernel, from either wrapper (``msda_folded_banded``
those of them with a band); ``msda_folded_bwd`` every call of the backward
kernel (``msda_folded_bwd_banded`` those with a band); ``msda_taps`` those
of the per-tap kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..utils.native_lib import launch
from .autograd import count, route

__all__ = ["msda_folded", "msda_folded_plain", "msda_folded_grouped_plain",
           "msda_folded_banded_plain", "msda_folded_banded_grouped_plain",
           "msda_folded_backward", "msda_folded_backward_plain",
           "sample_level_folded", "sample_level_folded_plain", "sample_level",
           "sample_level_plain", "msda_lane_plan"]


def _corner_terms(x, y, h: int, w: int, bounds=None, x_major: bool = False):
    """The four bilinear corners of pixel coordinates x, y on an h x w map,
    in the order (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1),
    each as (row, w_y * w_x, its derivative by x, its derivative by y): row
    y * W + x (or, with ``x_major``, x * H + y) of the corner clamped into
    the map, and every term 0 for a corner that reads zero: one outside rows
    [ylo, yhi) and columns [xlo, xhi), ``bounds`` = (ylo, yhi, xlo, xhi)
    each broadcast against x (a band), by default the whole map. floor's
    derivative is taken as 0, as autograd takes it."""
    ylo, yhi, xlo, xhi = (0, h, 0, w) if bounds is None else bounds
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    terms = []
    for yi, wy, sy in ((y0, 1.0 - fy, -1.0), (y0 + 1, fy, 1.0)):
        for xi, wx, sx in ((x0, 1.0 - fx, -1.0), (x0 + 1, fx, 1.0)):
            on = ((yi >= ylo) & (yi < yhi) & (xi >= xlo) & (xi < xhi)).float()
            yc, xc = yi.clamp(0, h - 1), xi.clamp(0, w - 1)
            row = xc * h + yc if x_major else yc * w + xc
            terms.append((row, wy * wx * on, sx * wy * on, sy * wx * on))
    return terms


def _corners(v, x, y, attw, h: int, w: int, x_major: bool = False, bounds=None):
    """The four corners of ``_corner_terms``, each as (v[corner],
    w_y * w_x * attw) in f32: v (BM, H*W, D), x, y, attw (BM, ...) f32.
    Returns four pairs of (BM, ..., D) rows and (BM, ..., 1) weights."""
    bm, d = v.shape[0], v.shape[-1]
    # gathered from an f32 copy, so that the VJP scatter-adds v's gradient in
    # f32 (a bf16 scatter-add rounds at every tap, in no fixed order) and
    # rounds it once
    vf = v.float()
    corners = []
    for row, wgt, _, _ in _corner_terms(x, y, h, w, bounds, x_major):
        taps = torch.gather(vf, 1, row.reshape(bm, -1, 1).expand(-1, -1, d))
        corners.append((taps.reshape(*x.shape, d), (wgt * attw).unsqueeze(-1)))
    return corners


def _bilinear_f32(v, x, y, attw, h: int, w: int, x_major: bool = False, bounds=None):
    """Sum over the four corners of ``_corners`` in f32: (BM, ..., D)."""
    (v0, w0), (v1, w1), (v2, w2), (v3, w3) = _corners(v, x, y, attw, h, w, x_major, bounds)
    return v0 * w0 + v1 * w1 + v2 * w2 + v3 * w3


def _fmaf(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CUDA's ``fmaf(a, b, acc)`` on f32 tensors: a * b + acc rounded once to
    f32. The product of two f32 is exact in f64; the f64 sum is made round
    to odd (TwoSum gives its error, which picks the neighbour with an odd
    last bit), and rounding that to f32 is the exact sum's rounding."""
    c, p = acc.double(), a.double() * b.double()
    s = c + p
    bb = s - c
    err = (c - (s - bb)) + (p - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.full_like(s, float("inf")).copysign(err)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def msda_lane_plan(d: int, aligned: bool = True) -> dict:
    """How both sampling kernels spread a corner row of D channels over a
    warp (``csrc/msda.cuh``): ``vec`` channels per load (4, an 8-byte load,
    where D % 4 == 0 and the map is 8-byte ``aligned``; else 1),
    ``group_lanes`` lanes per tap (a power of two) and ``groups`` =
    32 / group_lanes taps sampled by one load instruction."""
    if not 1 <= d <= 128:
        raise ValueError(f"msda_lane_plan: head dim {d} (1..128)")
    vec = 4 if d % 4 == 0 and aligned else 1
    group_lanes = min(32, 1 << (-(-d // vec) - 1).bit_length())
    return {"vec": vec, "group_lanes": group_lanes, "groups": 32 // group_lanes}


def _check_shapes(value, spatial_shapes, sampling_locations, attention_weights, band=None):
    b, s, m, _ = value.shape
    _, lq, _, levels, p, _ = sampling_locations.shape
    if levels != len(spatial_shapes) or s != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value length {s} / levels {levels} do not match "
                         f"spatial shapes {tuple(spatial_shapes)}")
    if (sampling_locations.shape[0] != b or sampling_locations.shape[2] != m
            or tuple(attention_weights.shape) != (b, lq, m, levels, p)):
        raise ValueError("sampling_locations must be (B, Lq, M, L, P, 2) and "
                         "attention_weights (B, Lq, M, L, P) for value (B, S, M, D)")
    if band is not None:
        if lq != s:
            raise ValueError(f"banded sampling requires queries == pixels (Lq {lq} != S {s})")
        if tuple(band.shape) != (s, levels, 4) or band.dtype != torch.int32:
            raise ValueError(f"band must be int32 ({s}, {levels}, 4), got "
                             f"{band.dtype} {tuple(band.shape)}")


def _level_inputs(value, sampling_locations, attention_weights):
    b, s, m, d = value.shape
    _, lq, _, levels, p, _ = sampling_locations.shape
    val = value.permute(0, 2, 1, 3).reshape(b * m, s, d)
    loc = sampling_locations.float().permute(0, 2, 3, 4, 1, 5).reshape(
        b * m, levels, p, lq, 2)
    attw = attention_weights.float().permute(0, 2, 3, 4, 1).reshape(b * m, levels, p, lq)
    return val, loc, attw


def _levels(spatial_shapes, loc, band):
    """Per level: (lvl, h, w, row start, x, y pixel coordinates, the band's
    per-query (ylo, yhi, xlo, xhi) or None)."""
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        x = loc[:, lvl, ..., 0] * w - 0.5
        y = loc[:, lvl, ..., 1] * h - 0.5
        bounds = None if band is None else band[:, lvl].long().unbind(-1)
        yield lvl, h, w, start, x, y, bounds
        start += h * w


def msda_folded_plain(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                      sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                      band: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the P-folded kernel over all levels: value (B, S, M, D),
    sampling_locations (B, Lq, M, L, P, 2) in [0, 1] as (x, y),
    attention_weights (B, Lq, M, L, P) -> (B, Lq, M * D) in value's dtype.
    ``band``: the banded function (``msda_folded_banded_plain``)."""
    _check_shapes(value, spatial_shapes, sampling_locations, attention_weights, band)
    b, s, m, d = value.shape
    lq = sampling_locations.shape[1]
    val, loc, attw = _level_inputs(value, sampling_locations, attention_weights)
    out = None
    for lvl, h, w, start, x, y, bounds in _levels(spatial_shapes, loc, band):
        part = _bilinear_f32(val[:, start:start + h * w], x, y, attw[:, lvl], h, w,
                             bounds=bounds).sum(1)
        out = part if out is None else out + part
    return out.to(value.dtype).reshape(b, m, lq, d).permute(0, 2, 1, 3).reshape(b, lq, m * d)


def msda_folded_grouped_plain(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                              sampling_locations: torch.Tensor,
                              attention_weights: torch.Tensor,
                              band: Optional[torch.Tensor] = None,
                              aligned: bool = True) -> torch.Tensor:
    """The P-folded kernel's algorithm in PyTorch: the function of
    ``msda_folded_plain`` summed in the kernel's order and rounding, which
    the kernel matches bit for bit. Tap t of a (query, head), level-major
    (t = l * P + p), goes to group t % G (G = ``msda_lane_plan(D,
    aligned)["groups"]``, the layout the kernel takes for a value that is,
    or with ``aligned=False`` is not, 8-byte aligned); each group's f32
    partial adds its taps in order and each tap's four corners in order,
    each corner by one fused multiply-add (``_fmaf``); the groups' partials
    are summed pairwise in f32 (0 + 1, 2 + 3, ..., then pairs of those) and
    rounded once to value's dtype. ``band``: the banded kernel's order
    (``msda_folded_banded_grouped_plain``)."""
    _check_shapes(value, spatial_shapes, sampling_locations, attention_weights, band)
    b, s, m, d = value.shape
    _, lq, _, levels, p, _ = sampling_locations.shape
    groups = msda_lane_plan(d, aligned)["groups"]
    val, loc, attw = _level_inputs(value, sampling_locations, attention_weights)
    partial = [torch.zeros((b * m, lq, d), dtype=torch.float32, device=value.device)
               for _ in range(groups)]
    for lvl, h, w, start, x, y, bounds in _levels(spatial_shapes, loc, band):
        corners = _corners(val[:, start:start + h * w], x, y, attw[:, lvl], h, w,
                           bounds=bounds)
        for pt in range(p):
            g = (lvl * p + pt) % groups
            for rows, wgt in corners:
                partial[g] = _fmaf(partial[g], wgt[:, pt], rows[:, pt])
    while len(partial) > 1:
        partial = [partial[i] + partial[i + 1] for i in range(0, len(partial), 2)]
    out = partial[0].to(value.dtype)
    return out.reshape(b, m, lq, d).permute(0, 2, 1, 3).reshape(b, lq, m * d)


def msda_folded_banded_plain(value, spatial_shapes, sampling_locations, attention_weights,
                             band: torch.Tensor) -> torch.Tensor:
    """Plain version of the banded sampling (the JAX package's ``banded``
    mode): ``msda_folded_plain`` with every corner outside its query's band
    (``band``, ``ops/ms_deform_attn.msda_band_table``) reading zero. Lq must
    equal S."""
    return msda_folded_plain(value, spatial_shapes, sampling_locations, attention_weights,
                             band=band)


def msda_folded_banded_grouped_plain(value, spatial_shapes, sampling_locations,
                                     attention_weights, band: torch.Tensor,
                                     aligned: bool = True) -> torch.Tensor:
    """The banded kernel's order and rounding (``msda_folded_grouped_plain``
    with the band): the banded kernel equals it bit for bit."""
    return msda_folded_grouped_plain(value, spatial_shapes, sampling_locations,
                                     attention_weights, band=band, aligned=aligned)


def msda_folded_backward_plain(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                               sampling_locations: torch.Tensor,
                               attention_weights: torch.Tensor, grad: torch.Tensor,
                               band: Optional[torch.Tensor] = None,
                               needs=(True, True, True)) -> tuple:
    """The backward kernel's algorithm in PyTorch, without autograd: the
    gradients (dvalue, dloc, dattw) of ``msda_folded_plain(value,
    spatial_shapes, sampling_locations, attention_weights, band)`` at
    ``grad`` (B, Lq, M * D). Per tap and corner c, dot_c = <g, v_c> in f32;
    dattw = sum_c w_c dot_c; dloc = (W, H) * attw * sum_c (dw_c/dx, dw_c/dy)
    dot_c; dvalue[v_c] += attw * w_c * g, summed in f32 and rounded once to
    value's dtype. dloc is f32, dattw in the weights' dtype; a gradient whose
    entry in ``needs`` is false is None."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    _check_shapes(value, shapes, sampling_locations, attention_weights, band)
    b, s, m, d = value.shape
    _, lq, _, levels, p, _ = sampling_locations.shape
    val, loc, attw = _level_inputs(value, sampling_locations, attention_weights)
    vf = val.float()
    g = grad.float().reshape(b, lq, m, d).permute(0, 2, 1, 3).reshape(b * m, 1, lq, d)
    dval = torch.zeros_like(vf) if needs[0] else None
    dloc = torch.zeros_like(loc)
    dattw = torch.zeros_like(attw)
    for lvl, h, w, start, x, y, bounds in _levels(shapes, loc, band):
        a = attw[:, lvl]
        dw = torch.zeros_like(x)
        dx = torch.zeros_like(x)
        dy = torch.zeros_like(x)
        for row, wgt, dwdx, dwdy in _corner_terms(x, y, h, w, bounds):
            index = (row + start).reshape(b * m, -1, 1).expand(-1, -1, d)
            dot = (torch.gather(vf, 1, index).reshape(*x.shape, d) * g).sum(-1)
            dw = dw + wgt * dot
            dx = dx + dwdx * dot
            dy = dy + dwdy * dot
            if dval is not None:
                dval.scatter_add_(1, index, ((wgt * a).unsqueeze(-1) * g).reshape(b * m, -1, d))
        dattw[:, lvl] = dw
        dloc[:, lvl, ..., 0] = w * (a * dx)
        dloc[:, lvl, ..., 1] = h * (a * dy)
    out = (
        None if dval is None
        else dval.to(value.dtype).reshape(b, m, s, d).permute(0, 2, 1, 3).contiguous(),
        dloc.reshape(b, m, levels, p, lq, 2).permute(0, 4, 1, 2, 3, 5).contiguous(),
        dattw.to(attention_weights.dtype).reshape(b, m, levels, p, lq).permute(
            0, 4, 1, 2, 3).contiguous())
    return tuple(t if need else None for t, need in zip(out, needs))


def _check_kernel_operands(fn: str, value, loc, attw, band) -> None:
    """Raises unless the P-folded kernels (forward and backward) take these
    operands: CUDA tensors, all contiguous on value's device, value bf16,
    loc f32, the weights f32 or bf16, the band int32; D <= 128, L <= 8."""
    if value.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {value.device}")
    checks = [("value", value, (torch.bfloat16,)), ("locations", loc, (torch.float32,)),
              ("weights", attw, (torch.float32, torch.bfloat16))]
    if band is not None:
        checks.append(("band", band, (torch.int32,)))
    for name, t, dtypes in checks:
        if t.dtype not in dtypes or t.device != value.device or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous "
                             f"{' or '.join(map(str, dtypes))} on {value.device}")
    d, levels = value.shape[-1], loc.shape[3]
    if d > 128 or levels > 8:
        raise ValueError(f"{fn}: head dim {d} (<= 128), levels {levels} (<= 8)")


def _folded_kernel(value, spatial_shapes, loc, attw, pixel: bool, band=None) -> torch.Tensor:
    """One launch of the P-folded kernel: value (B, S, M, D) bf16, loc
    (B, Lq, M, L, P, 2) f32, attw (B, Lq, M, L, P) f32 or bf16, all
    contiguous -> (B, Lq, M * D) bf16. With ``band`` (int32 on the same
    device) the banded variant."""
    _check_kernel_operands("msda_folded", value, loc, attw, band)
    b, s, m, d = value.shape
    _, lq, _, levels, p, _ = loc.shape
    out = torch.empty((b, lq, m * d), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    if loc.data_ptr() % 8:  # the kernel reads each (x, y) as one float2
        loc = loc.clone()
    plan = msda_lane_plan(d, aligned=value.data_ptr() % 8 == 0)
    shapes = (ctypes.c_int * (2 * levels))(*[int(v) for hw in spatial_shapes for v in hw])
    launch("pd_msda_folded", value.device, value.data_ptr(), loc.data_ptr(), attw.data_ptr(),
           out.data_ptr(), b, s, lq, m, d, levels, p, ctypes.addressof(shapes),
           int(attw.dtype == torch.float32), int(pixel), plan["vec"], plan["group_lanes"],
           None if band is None else band.data_ptr())
    count("msda_folded")
    if band is not None:
        count("msda_folded_banded")
    return out


def msda_folded(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                band: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deformable sampling of every level in one launch: value (B, S, M, D)
    with S = sum of H_l * W_l, sampling_locations (B, Lq, M, L, P, 2) in
    [0, 1] as (x, y), attention_weights (B, Lq, M, L, P) -> (B, Lq, M * D)
    in value's dtype; with ``band`` (``ops/ms_deform_attn.msda_band_table``,
    Lq == S) the banded function. CPU tensors take the plain version; CUDA
    tensors the kernel (bf16 value; the locations are taken in f32),
    differentiated by the backward kernel (``msda_folded_backward``)."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    _check_shapes(value, shapes, sampling_locations, attention_weights, band)
    # the kernels take the locations in f32, and both operands contiguous
    return route("msda", _msda_plain, _msda_kernel, value,
                 sampling_locations.float().contiguous(), attention_weights.contiguous(),
                 shapes=shapes, band=band, backward=_msda_backward)


def _msda_plain(value, loc, attw, shapes, band):
    return msda_folded_plain(value, shapes, loc, attw, band)


def _msda_kernel(value, loc, attw, shapes, band):
    return _folded_kernel(value, shapes, loc, attw, pixel=False, band=band)


def _msda_backward(grad, needs, value, loc, attw, shapes, band):
    return msda_folded_backward(value, shapes, loc, attw, grad, band, needs=needs)


def msda_folded_backward(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                         grad: torch.Tensor, band: Optional[torch.Tensor] = None,
                         needs=(True, True, True)) -> tuple:
    """The gradients (dvalue, dloc, dattw) of ``msda_folded`` at ``grad``
    (B, Lq, M * D) by the backward kernel (``csrc/msda_folded_bwd.cu``; the
    algorithm of ``msda_folded_backward_plain``): CUDA tensors as the forward
    kernel takes them, value bf16, the locations f32, the weights f32 or
    bf16; dvalue bf16, dloc f32, dattw in the weights' dtype. A gradient whose
    entry in ``needs`` is false is not computed and is None. One call counts
    as one launch of ``msda_folded_bwd`` (``ops/autograd.LAUNCHES``)."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    _check_shapes(value, shapes, sampling_locations, attention_weights, band)
    loc = sampling_locations.float().contiguous()
    attw = attention_weights.contiguous()
    _check_kernel_operands("msda_folded_backward", value, loc, attw, band)
    b, s, m, d = value.shape
    _, lq, _, levels, p, _ = loc.shape
    grad = grad.to(value.dtype).contiguous()
    if tuple(grad.shape) != (b, lq, m * d) or grad.device != value.device:
        raise ValueError(f"msda_folded_backward: grad must be ({b}, {lq}, {m * d}) on "
                         f"{value.device}, got {tuple(grad.shape)}")

    def empty(need, like, dtype):
        return torch.empty(like.shape, dtype=dtype, device=value.device) if need else None

    dvalue = empty(needs[0], value, value.dtype)
    dacc = empty(needs[0], value, torch.float32)
    dloc = empty(needs[1], loc, torch.float32)
    dattw = empty(needs[2], attw, attw.dtype)
    if value.numel() == 0 or lq == 0:
        for t in (dvalue, dloc, dattw):
            if t is not None:
                t.zero_()
        return dvalue, dloc, dattw
    if loc.data_ptr() % 8:  # the kernel reads each (x, y) as one float2
        loc = loc.clone()
    aligned = value.data_ptr() % 8 == 0 and grad.data_ptr() % 8 == 0
    plan = msda_lane_plan(d, aligned=aligned)
    shape_arr = (ctypes.c_int * (2 * levels))(*[v for hw in shapes for v in hw])

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch("pd_msda_folded_bwd", value.device, value.data_ptr(), loc.data_ptr(),
           attw.data_ptr(), grad.data_ptr(), ptr(dvalue), ptr(dacc), ptr(dloc), ptr(dattw),
           b, s, lq, m, d, levels, p, ctypes.addressof(shape_arr),
           int(attw.dtype == torch.float32), plan["vec"], plan["group_lanes"], ptr(band))
    count("msda_folded_bwd")
    if band is not None:
        count("msda_folded_bwd_banded")
    return dvalue, dloc, dattw


def sample_level_folded_plain(v_sd, x, y, attw, h: int, w: int) -> torch.Tensor:
    """Plain version of the one-level P-folded sampling: v_sd (BM, H*W, D)
    y-major; x, y (BM, P, N) pixel coordinates (align_corners=False); attw
    (BM, P, N) -> (BM, N, D) in v_sd's dtype."""
    return _bilinear_f32(v_sd, x.float(), y.float(), attw.float(), h, w).sum(1).to(v_sd.dtype)


def _sample_level_folded_kernel(v_sd, x, y, attw, h: int, w: int) -> torch.Tensor:
    bm, hw, d = v_sd.shape
    _, p, n = x.shape
    if hw != h * w or tuple(y.shape) != (bm, p, n) or tuple(attw.shape) != (bm, p, n):
        raise ValueError(f"sample_level_folded: v_sd (BM, {h}*{w}, D) and x, y, attw "
                         f"(BM, P, N) expected, got {tuple(v_sd.shape)}, {tuple(x.shape)}")
    loc = torch.stack([x.float(), y.float()], -1).permute(0, 2, 1, 3).reshape(bm, n, 1, 1, p, 2)
    a = attw.float().permute(0, 2, 1).reshape(bm, n, 1, 1, p)
    out = _folded_kernel(v_sd.reshape(bm, hw, 1, d), ((h, w),), loc.contiguous(),
                         a.contiguous(), pixel=True)
    return out.reshape(bm, n, d)


def sample_level_folded(v_sd, x, y, attw, h: int, w: int) -> torch.Tensor:
    """One level of P-folded sampling in the JAX package's layout:
    (BM, N, D) = sum_p attw_p * bilinear(v_sd, x_p, y_p), with v_sd
    (BM, H*W, D) y-major and x, y, attw (BM, P, N). CPU tensors take the
    plain version; CUDA tensors one launch of the P-folded kernel."""
    return route("msda", sample_level_folded_plain, _sample_level_folded_kernel, v_sd, x, y,
                 attw, h=h, w=w)


def sample_level_plain(v_whd, x, y, attw, h: int, w: int) -> torch.Tensor:
    """Plain version of the per-tap sampling: v_whd (BM, W, H*D) x-major;
    x, y (BM, N) pixel coordinates; attw (BM, N) -> (BM, N, D) in v_whd's
    dtype."""
    bm = v_whd.shape[0]
    v = v_whd.reshape(bm, w * h, v_whd.shape[-1] // h)
    return _bilinear_f32(v, x.float(), y.float(), attw.float(), h, w,
                         x_major=True).to(v_whd.dtype)


def _sample_level_kernel(v_whd, x, y, attw, h: int, w: int) -> torch.Tensor:
    if v_whd.device.type != "cuda":
        raise ValueError(f"sample_level: unsupported device {v_whd.device}")
    bm, n = x.shape
    d = v_whd.shape[-1] // h
    if (v_whd.dtype != torch.bfloat16 or tuple(v_whd.shape) != (bm, w, h * d)
            or not v_whd.is_contiguous() or d > 128):
        raise ValueError(f"sample_level: v_whd must be contiguous bf16 ({bm}, {w}, {h}*D), "
                         f"D <= 128")
    xs, ys, a = (t.float().contiguous() for t in (x, y, attw))
    if tuple(ys.shape) != (bm, n) or tuple(a.shape) != (bm, n):
        raise ValueError(f"sample_level: x, y, attw must be ({bm}, {n})")
    out = torch.empty((bm, n, d), dtype=v_whd.dtype, device=v_whd.device)
    if out.numel() == 0:
        return out
    plan = msda_lane_plan(d, aligned=v_whd.data_ptr() % 8 == 0)
    launch("pd_msda_taps", v_whd.device, v_whd.data_ptr(), xs.data_ptr(), ys.data_ptr(),
           a.data_ptr(), out.data_ptr(), bm, n, h, w, d, plan["vec"], plan["group_lanes"])
    count("msda_taps")
    return out


def sample_level(v_whd, x, y, attw, h: int, w: int) -> torch.Tensor:
    """Per-tap weighted bilinear sampling of one level in the JAX package's
    layout: (BM, N, D) = attw * bilinear(v_whd, x, y), with v_whd (BM, W, H*D)
    x-major and x, y, attw (BM, N). CPU tensors take the plain version."""
    return route("msda", sample_level_plain, _sample_level_kernel, v_whd, x, y, attw, h=h, w=w)
