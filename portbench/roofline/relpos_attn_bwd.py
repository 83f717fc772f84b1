"""ViTDet's attention backward (``ops/relpos_attention``'s
``relpos_attn_bwd_kv_kernel`` and ``relpos_attn_bwd_q_kernel``), at the
blocks of ``relpos_attn.py``. Operations as ``masked_attn_bwd.py`` counts
them: dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q, 2 N^2 D each per
unit (the recomputation of P is not counted). Bytes: q, k, v, the output
and its gradient read and dq, dk, dv written, in bf16; the f32 log-sum-exp;
the tables' rows, q R_h (N x S) and q R_w, read and their gradients written,
in f32."""

from portbench.roofline.relpos_attn import units

KERNELS = ("relpos_attn_bwd_",)
EXCLUDE = ()


def work(cfg: dict, traffic: dict):
    nbytes = flops = 0
    for u, s, d in units(cfg, traffic):
        n = s * s
        flops += u * 8 * n * n * d
        nbytes += u * (8 * n * d * 2 + n * 4 + 2 * 2 * n * s * 4)
    return nbytes, flops
