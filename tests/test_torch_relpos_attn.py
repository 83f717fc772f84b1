"""Attention with decomposed relative positions (``ops/relpos_attention``),
its plain version on the CPU, against upstream's ViTDet attention written
out here as detectron2 computes it: ``(q * scale) @ k^T``, then
``add_decomposed_rel_pos`` (two einsums of the unscaled q with the gathered
tables), softmax, ``@ v``. Windowed shapes come from a padded grid, whose
zero tokens are keys that nothing masks; global shapes attend over a whole
grid. Forward and the gradients of q, k, v and both tables from float64
inputs: upstream computes in float64, the op in float32 as it does on the
card (its logits and rel_h / rel_w), so each result is held to a relative
gap of 1e-5, a few float32 roundings, where dropping the tables moves the
output by more than 1e-2."""

import pytest
import torch

from partdistillation_torch.models.vit_utils import add_decomposed_rel_pos, window_partition
from partdistillation_torch.ops import relpos_attention as ra


def upstream_attention(q, k, v, rel_pos_h, rel_pos_w, size, scale):
    """detectron2's ``Attention.forward`` after the qkv split, with
    ``get_rel_pos`` for tables of 2 S - 1 rows."""
    h, w = size
    attn = (q * scale) @ k.transpose(-2, -1)
    qc = torch.arange(h)[:, None] - torch.arange(h)[None, :] + (h - 1)
    wc = torch.arange(w)[:, None] - torch.arange(w)[None, :] + (w - 1)
    rh, rw = rel_pos_h[qc], rel_pos_w[wc]
    b, _, dim = q.shape
    r_q = q.reshape(b, h, w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = (attn.view(b, h, w, h, w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(b, h * w, h * w)
    return attn.softmax(dim=-1) @ v


def _qkv_from_grid(g, b, h, w, c, heads, window):
    """q, k, v (B' heads, N, D) of a qkv projection over a (B, H, W, C)
    grid, split into zero-padded windows first when ``window`` is set."""
    x = torch.randn(b, h, w, c, generator=g, dtype=torch.float64)
    if window:
        x, _ = window_partition(x, window)
    bb, gh, gw, _ = x.shape
    wqkv = torch.randn(3 * c, c, generator=g, dtype=torch.float64) / c ** 0.5
    bias = torch.randn(3 * c, generator=g, dtype=torch.float64)
    qkv = (x @ wqkv.T + bias).reshape(bb, gh * gw, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = (t.reshape(bb * heads, gh * gw, c // heads) for t in qkv.unbind(0))
    return q, k, v, (gh, gw)


CASES = [  # (batch, H, W, channels, heads, window)
    ("window_padded", 2, 5, 7, 16, 2, 3),
    ("window_exact", 1, 8, 8, 16, 4, 4),
    ("global_square", 2, 6, 6, 32, 2, 0),
    ("global_wide", 1, 4, 9, 16, 2, 0),
]


@pytest.mark.parametrize("name,b,h,w,c,heads,window", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_upstream(name, b, h, w, c, heads, window):
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    q, k, v, size = _qkv_from_grid(g, b, h, w, c, heads, window)
    if window:
        # padded tokens: the qkv bias alone, keys that no mask removes
        assert size == (window, window) and (w % window or h % window or name.endswith("exact"))
    d = c // heads
    th = torch.randn(2 * size[0] - 1, d, generator=g, dtype=torch.float64) * 0.5
    tw = torch.randn(2 * size[1] - 1, d, generator=g, dtype=torch.float64) * 0.5
    gout = torch.randn(q.shape, generator=g, dtype=torch.float64)
    scale = d ** -0.5

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, th, tw)]
        out = fn(*leaves, size, scale)
        out.backward(gout)
        return out.detach(), [t.grad for t in leaves]

    out, grads = run(ra.relpos_attention)
    ref, ref_grads = run(upstream_attention)
    assert _gap(out, ref) < 1e-5
    for name_, a, r in zip(("q", "k", "v", "rel_pos_h", "rel_pos_w"), grads, ref_grads):
        assert _gap(a, r) < 1e-5, name_
    # the bias matters at these shapes: without the tables the output moves
    flat = upstream_attention(q, k, v, torch.zeros_like(th), torch.zeros_like(tw), size, scale)
    assert _gap(flat, ref) > 1e-2


def _gap(a, r) -> float:
    return float((a.double() - r).norm() / r.norm())


def ports_vit_utils_attention(q, k, v, rel_pos_h, rel_pos_w, size, scale):
    """The same attention through the port's ``vit_utils.add_decomposed_rel_pos``
    (held to the JAX package's helper by ``test_torch_slice14_models``)."""
    attn = (q * scale) @ k.transpose(-2, -1)
    attn = add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, size, size)
    return attn.softmax(dim=-1) @ v


@pytest.mark.parametrize("name,b,h,w,c,heads,window", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_the_ports_vit_utils(name, b, h, w, c, heads, window):
    """The op's plain version against ``vit_utils``' decomposed bias, forward
    and every gradient, at the same shapes and limit as upstream's."""
    g = torch.Generator().manual_seed(sum(map(ord, name)) + 1)
    q, k, v, size = _qkv_from_grid(g, b, h, w, c, heads, window)
    d = c // heads
    th = torch.randn(2 * size[0] - 1, d, generator=g, dtype=torch.float64) * 0.5
    tw = torch.randn(2 * size[1] - 1, d, generator=g, dtype=torch.float64) * 0.5
    gout = torch.randn(q.shape, generator=g, dtype=torch.float64)
    runs = []
    for fn in (ra.relpos_attention, ports_vit_utils_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, th, tw)]
        out = fn(*leaves, size, d ** -0.5)
        out.backward(gout)
        runs.append([out.detach()] + [t.grad for t in leaves])
    for name_, a, r in zip(("out", "q", "k", "v", "rel_pos_h", "rel_pos_w"), *runs):
        assert _gap(a, r) < 1e-5, name_


def test_core_takes_the_tables_rows():
    """``decomposed_rel_pos`` then the core equal the whole op; rel_h and
    rel_w hold q R_h and q R_w of the unscaled q, in f32."""
    g = torch.Generator().manual_seed(7)
    s, d = 4, 8
    q, k, v = (torch.randn(3, s * s, d, generator=g) for _ in range(3))
    th, tw = (torch.randn(2 * s - 1, d, generator=g) for _ in range(2))
    rel_h, rel_w = ra.decomposed_rel_pos(q, th, tw, (s, s))
    assert rel_h.dtype == rel_w.dtype == torch.float32
    assert tuple(rel_h.shape) == tuple(rel_w.shape) == (3, s * s, s)
    # query (1, 2) against key row 3: table row 1 - 3 + s - 1
    torch.testing.assert_close(rel_h[:, 1 * s + 2, 3], q[:, 1 * s + 2] @ th[1 - 3 + s - 1])
    torch.testing.assert_close(rel_w[:, 1 * s + 2, 0], q[:, 1 * s + 2] @ tw[2 - 0 + s - 1])
    torch.testing.assert_close(ra.relpos_attention_core_plain(q, k, v, rel_h, rel_w, 0.3),
                               ra.relpos_attention(q, k, v, th, tw, (s, s), 0.3))


def test_plan_and_refusals():
    assert ra.relpos_attention_plan(4096, 64, 64, 64) == {
        "bn": 64, "bm": 128, "bm_bwd": 64, "warps_fwd": 8, "warps_q": 8, "warps_kv": 4}
    assert ra.relpos_attention_plan(196, 14, 14, 64)["bn"] == 16
    with pytest.raises(ValueError):
        ra.relpos_attention_plan(196, 14, 15, 64)
    with pytest.raises(ValueError):
        ra.relpos_attention_plan(129 * 2, 2, 129, 64)
    with pytest.raises(ValueError):
        ra.decomposed_rel_pos(torch.zeros(1, 16, 4), torch.zeros(5, 4), torch.zeros(7, 4),
                              (4, 4))
