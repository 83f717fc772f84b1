"""ViTDet's attention with decomposed relative positions, forward
(``ops/relpos_attention``'s ``relpos_attn_fwd_kernel``): per block, each
(window or image, head) attends over N = S^2 tokens of an S x S grid (S the
window, or the image's token grid in a global block), heads of D channels.
Operations, the published attention's whatever implements it: QK^T and PV,
2 N^2 D each, and the two table products q R_h and q R_w, 2 N S D each.
Bytes: q, k, v and the output in bf16, and the two tables' rows in f32."""

KERNELS = ("relpos_attn_fwd_kernel",)
EXCLUDE = ()


def units(cfg: dict, traffic: dict):
    """(attention units, grid side S, head width D) of each block."""
    g = cfg["model"]["vitdet"]
    b, heads = traffic["batch"], g["num_heads"]
    side, ws = cfg["image_size"] // g["patch_size"], g["window_size"]
    windows = (-(-side // ws)) ** 2
    for i in range(g["depth"]):
        if i in g["window_block_indexes"]:
            yield b * windows * heads, ws, g["embed_dim"] // heads
        else:
            yield b * heads, side, g["embed_dim"] // heads


def work(cfg: dict, traffic: dict):
    nbytes = flops = 0
    for u, s, d in units(cfg, traffic):
        n = s * s
        flops += u * (4 * n * n * d + 2 * 2 * n * s * d)
        nbytes += u * 4 * n * d * 2 + 2 * (2 * s - 1) * d * 4
    return nbytes, flops
