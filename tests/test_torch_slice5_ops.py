"""Slice 5's algorithms on the CPU against the JAX package: the plain version
of the redesigned masked-attention backward (``masked_attention_bwd_split_plain``:
one pass per (query tile, key block), dQ partials per key block, dK and dV
partials per query split, summed in order) against the Pallas backward
kernel in interpret mode, and the wrappers' pure-Python grids for the card:
the backward's partition of the (query, key) pairs and the window kernel's
grouping of windows that share a bias block.

Inputs come from one numpy generator and go to both packages. Tolerances:
max |err| within 1e-5 of max |reference| in f32 (P = exp(s - lse) against
the Pallas softmax, D = rowsum(g o) against rowsum(P dP), sums in another
order) and 2^-6 in bf16 (bf16 P, dS and gradients land on neighbouring
values; D reads the bf16 output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.ops import fused_attention as jfa
from partdistillation_torch.ops import fused_attention as pfa


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else a)


def _within(out, ref, rel):
    out, ref = _np(out), np.asarray(ref, np.float32)
    err = np.abs(out - ref).max()
    assert np.isfinite(err) and err <= rel * np.abs(ref).max(), err


def _inputs(rng, b, h, nq, nk, d, mh, kind):
    q = rng.normal(size=(b, h, nq, d)).astype(np.float32) * d ** -0.5
    k, v = (rng.normal(size=(b, h, nk, d)).astype(np.float32) for _ in range(2))
    g = rng.normal(size=(b, h, nq, d)).astype(np.float32)
    mask = rng.random((b, mh, nq, nk)) < 0.6
    if kind == "all_blocked_rows":
        mask[:, :, :5] = True
    elif kind == "block_blocked":
        # a whole key block and a whole query split see nothing unblocked
        mask[:, :, :, :40] = True
        mask[:, :, 100:140, 40:] = True
    return q, k, v, g, mask


def _plan(b, h, nq, nk, d, key_sub, q_split):
    """``masked_attention_bwd_plan``'s fields for a forced partition."""
    tiles = -(-nq // 16)
    tps = -(-tiles // q_split)
    return {"keys_per_block": 16 * key_sub, "q_tiles_per_split": tps,
            "q_split": -(-tiles // tps), "key_blocks": -(-nk // (16 * key_sub))}


# (Q, K, mask heads, mask kind, forced (key_sub, q_split) or None for the
# wrapper's plan): ragged Q = 200 and K = 129, shared and per-head masks,
# all-blocked rows, blocked key blocks and query splits, one tile, many splits
BWD_CASES = [(200, 129, 1, "all_blocked_rows", None), (200, 129, 4, "all_blocked_rows", None),
             (200, 129, 1, "block_blocked", (2, 4)), (200, 129, 4, "random", (1, 13)),
             (37, 300, 1, "all_blocked_rows", (4, 1)), (16, 16, 4, "random", None),
             (5, 3, 1, "random", (1, 1)), (200, 400, 1, "all_blocked_rows", (2, 7))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk,mh,kind,forced", BWD_CASES)
def test_bwd_split_plain_matches_pallas_interpret(nq, nk, mh, kind, forced, dtype):
    rng = np.random.default_rng(nq * 7 + nk + mh)
    b, h, d = 2, 4, 32
    q, k, v, g, mask = _inputs(rng, b, h, nq, nk, d, mh, kind)
    jm = jnp.asarray(mask)
    neg = jnp.where(jm & ~jnp.all(jm, -1, keepdims=True), jnp.float32(-1e9), 0.0)
    jq, jk, jv, jg = (jnp.asarray(a, dtype=dtype) for a in (q, k, v, g))
    ref = jfa._fused_bwd_pallas(jq, jk, jv, neg, jg, 128, interpret=True)
    # the backward's other inputs, the forward's output and f32 lse, from JAX
    out = jfa._fused_fwd_pallas(jq, jk, jv, neg, 128, interpret=True)
    logits = jnp.einsum("bhqd,bhkd->bhqk", jq, jk, preferred_element_type=jnp.float32)
    lse = jax.nn.logsumexp(logits + neg, axis=-1)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tq, tk, tv, tg, out = (_t(np.asarray(a, np.float32)).to(tdt) for a in (jq, jk, jv, jg, out))
    eff = _t(mask & ~mask.all(-1, keepdims=True)).to(torch.uint8)
    plan = _plan(b, h, nq, nk, d, *forced) if forced else None
    got = pfa.masked_attention_bwd_split_plain(tq, tk, tv, eff, out, _t(lse), tg, plan)
    for a, r in zip(got, ref):
        assert a.dtype == tdt
        _within(a, r, 1e-5 if dtype == "float32" else 2.0 ** -6)


def test_bwd_split_plain_matches_the_plain_backward():
    """At the wrapper's plan on a main-path shape (cut to K = 400), the split
    algorithm and the unsplit plain backward agree in f32."""
    rng = np.random.default_rng(5)
    q, k, v, g, mask = _inputs(rng, 2, 8, 200, 400, 32, 1, "all_blocked_rows")
    tq, tk, tv, tg, tm = map(_t, (q, k, v, g, mask))
    out, lse = pfa.masked_attention_split_plain(tq, tk, tv, tm, 1)
    eff = (tm & ~tm.all(-1, keepdim=True)).to(torch.uint8)
    got = pfa.masked_attention_bwd_split_plain(tq, tk, tv, eff, out, lse, tg)
    for a, r in zip(got, pfa.masked_attention_bwd_plain(tq, tk, tv, tm, tg)):
        _within(a, r.numpy(), 1e-5)


MAIN_KEYS = [400, 1600, 6400]  # the decoder's key counts at 640^2: strides 32 / 16 / 8


@pytest.mark.parametrize("nk", MAIN_KEYS)
def test_bwd_grid_fills_the_card(nk):
    plan = pfa.masked_attention_bwd_plan(2, 8, 200, nk, 32)
    assert plan["group"] == 8  # all heads per CTA: the shared mask tile is read once
    assert plan["ctas"] >= 2 * pfa.SM_COUNT
    assert plan["key_sub"] * 32 <= 64  # dK and dV fit a thread's registers


def _covered(plan, nq, nk):
    """How many CTAs of ``plan`` take each (query, key) pair, as the kernel
    indexes them: CTA (key block, split) takes keys [16 ks kb, 16 ks (kb+1))
    and query tiles [split tps, (split + 1) tps) of 16 rows."""
    seen = np.zeros((nq, nk), np.int64)
    keys, rows = plan["keys_per_block"], 16 * plan["q_tiles_per_split"]
    for kb in range(plan["key_blocks"]):
        for split in range(plan["q_split"]):
            seen[split * rows:(split + 1) * rows, kb * keys:(kb + 1) * keys] += 1
    return seen


@pytest.mark.parametrize("b,h,nq,nk,d", [(2, 8, 200, 400, 32), (2, 8, 200, 1600, 32),
                                         (2, 8, 200, 6400, 32), (1, 4, 5, 3, 16),
                                         (2, 8, 70, 129, 64), (1, 6, 33, 1000, 128),
                                         (3, 1, 17, 65, 32)])
def test_bwd_plan_covers_every_pair_once(b, h, nq, nk, d):
    plan = pfa.masked_attention_bwd_plan(b, h, nq, nk, d)
    g, ks = plan["group"], plan["key_sub"]
    assert h % g == 0 and g * d <= 256 and g <= 8 and ks in (1, 2, 4)
    assert ks == 1 or ks * d <= 64
    assert (_covered(plan, nq, nk) == 1).all()
    tiles = -(-nq // 16)
    # no split is empty
    assert (plan["q_split"] - 1) * plan["q_tiles_per_split"] < tiles
    assert plan["ctas"] == b * (h // g) * plan["key_blocks"] * plan["q_split"]


# window attention (Bw, H, P) at Swin-L's four stages, B=2 at 640^2, unshifted
# (one bias group) and shifted (a group per window position); then ragged
# groups and tiny shapes
WINDOW_CASES = [(392, 6, 1), (392, 6, 196), (98, 12, 1), (98, 12, 49), (32, 24, 1),
                (32, 24, 16), (8, 48, 1), (8, 48, 4), (21, 3, 3), (6, 3, 1), (8, 2, 8)]


@pytest.mark.parametrize("bw,h,p", WINDOW_CASES)
def test_window_plan_takes_every_item_once_and_each_bias_block_in_one_run(bw, h, p):
    plan = pfa.window_attention_plan(bw, h, p)
    per = bw // p
    assert plan["ctas"] == min(bw * h, pfa.SM_COUNT)
    seen = np.zeros((bw, h), np.int64)
    fetches, n_ctas = 0, 0
    for items in pfa.window_attention_work(plan, h):
        n_ctas += 1
        assert items  # every CTA has work
        blocks = [(hh, w // per) for w, hh in items]
        runs = [blk for i, blk in enumerate(blocks) if i == 0 or blk != blocks[i - 1]]
        assert len(runs) == len(set(runs))  # each bias block in one run: fetched once
        fetches += len(runs)
        for w, hh in items:
            seen[w, hh] += 1
    assert n_ctas == plan["ctas"]
    assert (seen == 1).all()
    # every (group, head) block once, plus at most one refetch per CTA boundary
    assert fetches <= h * p + n_ctas - 1


def test_window_plan_shares_bias_blocks_along_a_run():
    # res2 unshifted: one bias block per head for 392 windows, so each CTA
    # fetches one or two blocks for its ~18 items; res2 shifted: groups of two
    plan = pfa.window_attention_plan(392, 6, 1)
    for items in pfa.window_attention_work(plan, 6):
        assert len({hh for _, hh in items}) <= 2
    with pytest.raises(ValueError):
        pfa.window_attention_plan(10, 2, 3)
