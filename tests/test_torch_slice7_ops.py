"""Slice 7's algorithms on the CPU against the JAX package: the two launches
of the redesigned window attention + output projection in PyTorch
(``window_attention_proj_split_plain``: the token-major attention, then the
f32 projection with b added last) against the Pallas ``_fwd_kernel_attn_proj``
in interpret mode, and the LayerNorm's plain version against the JAX
package's ``fused_layer_norm`` at the width of each geometry the kernel's
plan picks; and the wrappers' pure-Python plans for the card
(``window_attention_proj_plan``, ``layer_norm_plan``) at every main-path
shape and at ragged cases.

Inputs come from one numpy generator and go to both packages. Tolerances
(f32): max |err| within 1e-5 of max |reference| (sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.ops import fused_attention as jfa
from partdistillation_tpu.ops.layer_norm import fused_layer_norm as j_layer_norm
from partdistillation_torch.ops import fused_attention as pfa
from partdistillation_torch.ops import fused_mlp as pfm
from partdistillation_torch.ops import layer_norm as pln
from partdistillation_torch.utils.native_lib import SM_COUNT

TOL = 1e-5

# (Bw, H, D, N, C, P) of the window kernels on the main path (B=2, 640^2,
# C = H x D), unshifted and shifted, then ragged cases
MAIN_WINDOW = [(392, 6, 32, 144, 192, 1), (392, 6, 32, 144, 192, 196),
               (98, 12, 32, 144, 384, 1), (98, 12, 32, 144, 384, 49),
               (32, 24, 32, 144, 768, 1), (32, 24, 32, 144, 768, 16),
               (8, 48, 32, 144, 1536, 1), (8, 48, 32, 144, 1536, 4)]
RAGGED_WINDOW = [(6, 3, 16, 49, 48, 3), (4, 3, 16, 16, 48, 1), (4, 2, 24, 16, 80, 1),
                 (1, 1, 16, 7, 16, 1)]
# LayerNorm rows x C on the main path
MAIN_LN = [(51200, 192), (12800, 384), (12800, 768), (3200, 768), (3200, 1536),
           (800, 1536), (800, 3072)]


def _close(out, ref, tol=TOL):
    out = np.asarray(out.detach() if isinstance(out, torch.Tensor) else out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert scale > 0 and err <= tol * scale, (err, scale)


@pytest.mark.parametrize("case", MAIN_WINDOW + RAGGED_WINDOW)
def test_window_attention_proj_plan(case):
    bw, h, d, n, c, p = case
    plan = pfa.window_attention_proj_plan(bw, h, d, n, c, p)
    # the attention launch: one CTA per SM, or one per (window, head) item
    assert plan["ctas"] == min(bw * h, SM_COUNT)
    assert plan["ctas"] == pfa.window_attention_plan(bw, h, p)["ctas"]
    # the projection: Bw*N rows, the MLP GEMM's column tile
    assert plan["rows"] == bw * n
    assert plan["bn"] == pfm._column_tile(bw * n, c) and plan["bn"] in (64, 96, 128)
    assert plan["tiles"] == -(-bw * n // 128) * -(-c // plan["bn"])


def test_window_attention_proj_plan_main_path_tiles():
    """Every main-path GEMM has a CTA for each SM of the card, and the
    attention launch a persistent CTA on each."""
    for bw, h, d, n, c, p in MAIN_WINDOW:
        plan = pfa.window_attention_proj_plan(bw, h, d, n, c, p)
        assert plan["ctas"] == SM_COUNT
        assert plan["tiles"] >= SM_COUNT


def test_window_attention_proj_plan_rejects_ragged_groups():
    with pytest.raises(ValueError):
        pfa.window_attention_proj_plan(6, 2, 16, 16, 32, 4)


def _window_inputs(groups, c, seed, b=8, h=3, d=16, n=24):
    rng = np.random.default_rng(seed)
    qt, kt, vt = (rng.normal(size=(b, h, d, n)).astype(np.float32) for _ in range(3))
    bias = rng.normal(size=(groups, h, n, n)).astype(np.float32)
    bias[..., :5] -= 100.0  # shift-mask-like blocked pairs
    w = (rng.normal(size=(h * d, c)) * (h * d) ** -0.5).astype(np.float32)  # flax layout
    bb = rng.normal(size=(c,)).astype(np.float32) * 0.1
    return qt, kt, vt, bias, w, bb


def _port(qt, kt, vt, bias, w, b):
    return [torch.from_numpy(np.array(a)) for a in (qt, kt, vt, bias, w.T, b)]


@pytest.mark.parametrize("c", [48, 40])
@pytest.mark.parametrize("groups", [1, 4])
def test_split_plain_matches_pallas_interpret(groups, c):
    args = _window_inputs(groups, c, seed=groups + c)
    ref = jfa._attn_proj_fwd_pallas(*map(jnp.asarray, args), 0.25, interpret=True)
    port = _port(*args)
    out = pfa.window_attention_proj_split_plain(*port, scale=0.25)
    assert out.shape == (8, 24, c)
    _close(out, ref)
    _close(out, pfa.window_attention_proj_plain(*port, scale=0.25))


@pytest.mark.parametrize("groups", [1, 4])
def test_tokens_plain_is_the_window_attention_token_major(groups):
    """The attention launch's plain version: row w*N + i, columns h*D.. of
    head h, against the JAX package's window attention reference."""
    qt, kt, vt, bias, _, _ = _window_inputs(groups, 48, seed=7)
    a = pfa.window_attention_tokens_plain(*_port(qt, kt, vt, bias, np.zeros((1, 1)),
                                                 np.zeros(1))[:4], scale=0.25)
    full = np.repeat(bias, 8 // groups, axis=0)
    ref = np.asarray(jfa.attention_reference_t(*map(jnp.asarray, (qt, kt, vt, full)), 0.25))
    assert a.shape == (8 * 24, 3 * 16)
    _close(a, ref.transpose(0, 3, 1, 2).reshape(8 * 24, 3 * 16))


def test_split_plain_without_bias_vector():
    qt, kt, vt, bias, w, _ = _window_inputs(4, 48, seed=3)
    ref = jfa.window_attention_proj_reference(*map(jnp.asarray, (qt, kt, vt, bias, w)), None,
                                              0.25)
    port = _port(qt, kt, vt, bias, w, np.zeros(1, np.float32))[:5]
    _close(pfa.window_attention_proj_split_plain(*port, None, scale=0.25), ref)


@pytest.mark.parametrize("rows,c", MAIN_LN)
def test_layer_norm_plan_main_path(rows, c):
    """bf16 on the main path: the vector variant, three 16-byte chunks a
    lane at C <= 768 with several rows a warp below C = 768, and every
    chunk of a row covered once."""
    plan = pln.layer_norm_plan(rows, c, torch.bfloat16, True)
    want_lanes = {192: 8, 384: 16}.get(c, 32)
    want_loads = {1536: 6, 3072: 12}.get(c, 3)
    assert plan == {"lanes": want_lanes, "loads": want_loads}
    assert plan["lanes"] * plan["loads"] * 8 == c  # no idle chunk


RAGGED_LN = [(7, 196, torch.bfloat16, True, False),    # C % 8 != 0: scalar
             (7, 196, torch.float32, True, True),      # C % 4 == 0
             (7, 198, torch.float32, True, False),     # C % 4 != 0
             (7, 768, torch.bfloat16, False, False),   # unaligned base
             (7, 8, torch.bfloat16, True, True),       # one chunk: one lane a row
             (7, 40, torch.bfloat16, True, True),      # 5 chunks
             (7, 3072, torch.float32, True, True),     # 24 chunks a lane
             (7, 4096, torch.bfloat16, True, False),   # beyond 12 chunks a lane
             (7, 8192, torch.float32, True, False)]    # beyond 24 chunks a lane


@pytest.mark.parametrize("rows,c,dtype,aligned,vector", RAGGED_LN)
def test_layer_norm_plan_ragged(rows, c, dtype, aligned, vector):
    plan = pln.layer_norm_plan(rows, c, dtype, aligned)
    lanes, loads = plan["lanes"], plan["loads"]
    if not vector:
        assert plan == {"lanes": 32, "loads": 0}
        return
    vec = 8 if dtype == torch.bfloat16 else 4
    assert lanes & (lanes - 1) == 0 and lanes <= 32
    assert loads in pln._LN_LOADS[dtype]
    # the lanes' chunks cover the row, and one chunk fewer a lane would not
    assert lanes * loads * vec >= c > (lanes * loads - lanes) * vec or lanes == 1


# one C for each geometry the plan picks (lanes x loads), and the scalar
# variant's widths
LN_WIDTHS = [8, 40, 192, 384, 768, 1536, 3072, 196, 4096]


@pytest.mark.parametrize("c", LN_WIDTHS)
def test_layer_norm_plain_matches_jax(c):
    rng = np.random.default_rng(c)
    x = (rng.normal(size=(37, c)) * 2.0 + 0.5).astype(np.float32)
    scale = rng.normal(size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    ref = j_layer_norm(*map(jnp.asarray, (x, scale, bias)))
    out = pln.fused_layer_norm(*map(torch.from_numpy, (x, scale, bias)))
    _close(out, ref)
