"""Slice 4's algorithms on the CPU against the JAX package: the plain version
of the masked-attention forward's split-and-merge (``masked_attention_split_plain``)
and of the LN -> MLP kernel (``ln_mlp_kernel_numerics``, what the redesigned
GEMM kernel computes), and the wrappers' pure-Python choice of tiles and
splits for the card.

Inputs come from one numpy generator and go to both packages; the JAX
functions reach their Pallas kernels in interpret mode. Tolerances: max |err|
within 1e-5 of max |reference| in f32 (the Pallas MLP uses a polynomial erf,
|err| <= 1.5e-7, and sums in another order) and 2^-6 in bf16 (the bf16
roundings of the normalised rows, the hidden and the output land on
neighbouring values); the log-sum-exp within 1e-5 of max |o| of the f32
``logsumexp`` of the same masked scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.ops import fused_attention as jfa
from partdistillation_tpu.ops import fused_mlp as jfm
from partdistillation_torch.ops import fused_attention as pfa
from partdistillation_torch.ops import fused_mlp as pfm


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a)


def _within(out, ref, rel):
    out, ref = _np(out), np.asarray(ref, np.float32)
    err = np.abs(out - ref).max()
    assert np.isfinite(err) and err <= rel * np.abs(ref).max(), err


def _attn_inputs(rng, b, h, nq, nk, d, mask_heads):
    q = rng.normal(size=(b, h, nq, d)).astype(np.float32) * d ** -0.5
    k, v = (rng.normal(size=(b, h, nk, d)).astype(np.float32) for _ in range(2))
    mask = rng.random((b, mask_heads, nq, nk)) < 0.6
    return q, k, v, mask


def _masks(kind, rng, b, mh, nq, nk, n_split):
    mask = rng.random((b, mh, nq, nk)) < 0.6
    if kind == "all_blocked_rows":
        mask[:, :, :4] = True
    elif kind == "split_wholly_blocked":
        # half the rows see keys of the last split only; every other split
        # is wholly blocked for them
        last = nk * (n_split - 1) // n_split
        mask[:, :, : nq // 2, :last] = True
        mask[:, :, :2] = True  # and all-blocked rows
    return mask


# (K, splits, mask heads, mask kind): key counts that the splits do not
# divide, one split, a split per key, wholly blocked splits, all-blocked
# rows, shared and per-head masks
SPLIT_CASES = [(150, 4, 1, "all_blocked_rows"), (150, 4, 4, "all_blocked_rows"),
               (37, 5, 1, "split_wholly_blocked"), (37, 5, 4, "split_wholly_blocked"),
               (96, 1, 1, "all_blocked_rows"), (7, 7, 4, "random"),
               (200, 3, 1, "random")]


@pytest.mark.parametrize("nk,n_split,mh,kind", SPLIT_CASES)
def test_split_plain_matches_pallas_interpret(nk, n_split, mh, kind):
    rng = np.random.default_rng(nk + n_split + mh)
    b, h, nq, d = 2, 4, 20, 32
    q, k, v, _ = _attn_inputs(rng, b, h, nq, nk, d, mh)
    mask = _masks(kind, rng, b, mh, nq, nk, n_split)
    jm = jnp.asarray(mask)
    neg = jnp.where(jm & ~jnp.all(jm, -1, keepdims=True), jnp.float32(-1e9), 0.0)
    ref = jfa._fused_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), neg, 128,
                                interpret=True)
    out, lse = pfa.masked_attention_split_plain(_t(q), _t(k), _t(v), _t(mask), n_split)
    _within(out, ref, 1e-5)
    _within(out, pfa.masked_attention_plain(_t(q), _t(k), _t(v), _t(mask)), 1e-5)
    eff = mask & ~mask.all(-1, keepdims=True)
    logits = torch.matmul(_t(q), _t(k).transpose(-1, -2)).masked_fill(_t(eff), float("-inf"))
    err = np.abs(_np(lse) - _np(torch.logsumexp(logits, -1))).max()
    assert err <= 1e-5 * np.abs(np.asarray(ref)).max(), err


def _mlp_inputs(rng, n, c):
    f = 4 * c
    return [rng.normal(size=s).astype(np.float32) * m + o for s, m, o in (
        ((n, c), 2.0, 0.5), ((c,), 0.3, 1.0), ((c,), 0.1, 0.0),
        ((c, f), c ** -0.5, 0.0), ((f,), 0.1, 0.0), ((f, c), f ** -0.5, 0.0),
        ((c,), 0.1, 0.0))]


# Swin-L's widths 192 / 384 / 768 / 1536 scaled down by 8, token counts off
# every tile (64, 128)
MLP_CASES = [(37, 24), (130, 48), (77, 96), (19, 192)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("add_residual", [True, False])
@pytest.mark.parametrize("n,c", MLP_CASES)
def test_mlp_plain_matches_pallas_interpret(n, c, add_residual, dtype):
    args = _mlp_inputs(np.random.default_rng(n * c), n, c)
    jargs = [jnp.asarray(a, dtype=dtype) for a in args]
    ref = jfm._fwd_pallas(*jargs, eps=1e-5, token_tile=16, add_residual=add_residual,
                          interpret=True)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    x, g, be, w1, b1, w2, b2 = [_t(np.asarray(a, np.float32)).to(tdt) for a in jargs]
    # the port takes nn.Linear layout: w1 (4C, C), w2 (C, 4C)
    out = pfm.fused_ln_mlp(x, g, be, w1.t().contiguous(), b1, w2.t().contiguous(), b2,
                           add_residual=add_residual)
    assert out.dtype == tdt and out.shape == (n, c)
    _within(out, np.asarray(ref, np.float32), 1e-5 if dtype == "float32" else 2.0 ** -6)


# the main path's shapes at B=2, 640^2: the MLP's tokens and widths at res2..res5
MLP_MAIN = [(51200, 192), (12800, 384), (3200, 768), (800, 1536)]
ATTN_MAIN = [400, 1600, 6400]  # the decoder's key counts: strides 32 / 16 / 8


@pytest.mark.parametrize("n,c", MLP_MAIN)
def test_mlp_grids_fill_the_card(n, c):
    plan = pfm.mlp_plan(n, c, 4 * c)
    assert min(plan["tiles1"], plan["tiles2"]) >= pfm.SM_COUNT
    # a wide column tile only where it divides the width
    assert (4 * c) % plan["bn1"] == 0 and c % plan["bn2"] == 0


@pytest.mark.parametrize("nk", ATTN_MAIN)
def test_masked_attention_grid_fills_the_card(nk):
    plan = pfa.masked_attention_plan(2, 8, 200, nk, 32)
    # all eight heads in one CTA: the shared mask is read once per (image, query, key)
    assert plan["group"] == 8
    assert plan["ctas"] >= 2 * pfa.SM_COUNT


@pytest.mark.parametrize("b,h,nq,nk,d", [(2, 8, 200, 400, 32), (2, 8, 200, 6400, 32),
                                         (1, 4, 5, 3, 16), (2, 8, 70, 129, 64),
                                         (1, 6, 33, 1000, 128), (3, 1, 17, 65, 32)])
def test_masked_attention_plan_covers_every_key_once(b, h, nq, nk, d):
    plan = pfa.masked_attention_plan(b, h, nq, nk, d)
    g, tps, ns = plan["group"], plan["tiles_per_split"], plan["n_split"]
    tiles = -(-nk // 32)
    assert h % g == 0 and g * d <= 256 and g <= 8
    # no split is empty and together they cover every key tile
    assert (ns - 1) * tps < tiles <= ns * tps
