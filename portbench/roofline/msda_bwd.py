"""The deformable sampling's backward (#7', ``csrc/msda_folded_bwd.cu``:
the taps' kernel, the clearing of its f32 scratch and the rounding of it
into dvalue, all named ``msda_folded_bwd*``), once per encoder layer of the
pixel decoder over its levels' S tokens, queries = pixels. The least work of
the op, whatever implements it: value, the output gradient and dvalue in
bf16 (B S M D each), the locations and dloc in f32 (B S M L P 2 each), the
weights and dattw in bf16 (B S M L P each) and the band table (S L int32 x
4), each moved once; 16 D operations a tap (four corners, a dot product and
an axpy of D channels each)."""

from portbench.reference.model import level_shapes

KERNELS = ("msda_folded_bwd",)
EXCLUDE = ()


def work(cfg: dict, traffic: dict):
    pd = cfg["model"]["pixel_decoder"]
    b, m, p = traffic["batch"], pd["n_heads"], pd["n_points"]
    d = pd["conv_dim"] // m
    levels = level_shapes(cfg["image_size"], cfg["model"])
    s, n_lvl = sum(h * w for h, w in levels), len(levels)
    taps = b * s * m * n_lvl * p
    nbytes = 3 * b * s * m * d * 2 + 2 * taps * 2 * 4 + 2 * taps * 2 + s * n_lvl * 16
    layers = pd["transformer_layers"]
    return layers * nbytes, layers * 16 * d * taps
