"""The decoder's masked cross-attention backward (#5,
``csrc/masked_attention_bwd.cu``): per layer, Q queries against the K pixels
of the layer's feature level (levels cycle from the coarsest), heads of D
channels. Operations: dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q,
2 Q K D each per head (the recomputation of P is not counted). Bytes: q, k,
v, the output and its gradient in bf16, the f32 log-sum-exp, the boolean
block mask (one byte a pair), and dq, dk, dv in bf16."""

from portbench.reference.model import level_shapes

KERNELS = ("masked_attn_bwd",)
EXCLUDE = ()


def work(cfg: dict, traffic: dict):
    dc = cfg["model"]["decoder"]
    b, q, heads = traffic["batch"], dc["num_queries"], dc["num_heads"]
    d = dc["hidden_dim"] // heads
    levels = level_shapes(cfg["image_size"], cfg["model"])
    nbytes = flops = 0
    for i in range(dc["dec_layers"]):
        h, w = levels[i % dc["num_feature_levels"]]
        k = h * w
        flops += 8 * q * k * d * heads * b
        nbytes += (b * heads * (3 * q * d + 2 * k * d) * 2 + b * heads * q * 4 + b * q * k
                   + b * heads * (q * d + 2 * k * d) * 2)
    return nbytes, flops
