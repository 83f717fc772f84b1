"""Swin's window attention forward (#3, ``csrc/window_attention.cu``): per
block, windows of N = ws^2 tokens, heads of D channels; QK^T and PV are
2 N^2 D operations each per (window, head). Bytes: q, k, v and the output in
bf16, and the f32 additive bias once (one (heads, N, N) block, or one per
window with the shift mask)."""

from portbench.reference.model import stage_sizes

KERNELS = ("window_attn_kernel",)
EXCLUDE = ("proj",)


def work(cfg: dict, traffic: dict):
    sw = cfg["model"]["swin"]
    ws, b = sw["window_size"], traffic["batch"]
    n = ws * ws
    nbytes = flops = 0
    for side, depth, heads, i in zip(stage_sizes(cfg["image_size"], cfg["model"]), sw["depths"],
                                     sw["num_heads"], range(len(sw["depths"]))):
        d = sw["embed_dim"] * 2 ** i // heads
        hp = -(-side // ws) * ws
        nw = (hp // ws) ** 2
        for blk in range(depth):
            shifted = blk % 2 == 1 and side > ws
            flops += 4 * n * n * d * heads * nw * b
            nbytes += 4 * b * nw * heads * d * n * 2 + (nw if shifted else 1) * heads * n * n * 4
    return nbytes, flops
