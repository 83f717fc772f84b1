#!/usr/bin/env python3
"""Bit-for-bit digests of kernel outputs on seeded inputs, to show that two
trees compute the same bits: the LN -> MLP kernel (``csrc/fused_mlp.cu``,
with and without the residual) and the window attention
(``csrc/window_attention.cu``) at every main-path shape (B=2, 640^2, bf16).

Prints one JSON line per (kernel, shape) with the SHA-256 of the output's
bytes and writes the lines to ``--out``. ``--root`` imports the package from
another checkout (an unpacked older commit); ``--against FILE`` compares
with an earlier run's file and exits 1 if any digest differs. Inputs come
from a CUDA generator seeded by ``--seed``, so every tree sees the same
inputs. Run from the repository root on one GPU:
``python3 tools/torch_kernel_digests.py --root DIR --out A.jsonl``, then
``python3 tools/torch_kernel_digests.py --out B.jsonl --against A.jsonl``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from torch_kernel_breakdown import MLP_SHAPES, WINDOW_SHAPES  # noqa: E402


def digest(t) -> str:
    import torch

    torch.cuda.synchronize()
    raw = t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose partdistillation_torch is run")
    ap.add_argument("--out", required=True, help="file for the JSON lines")
    ap.add_argument("--against", help="an earlier run's file to compare with")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_digests: no CUDA device", file=sys.stderr)
        return 2
    from partdistillation_torch.ops import fused_attention as fa
    from partdistillation_torch.ops import fused_mlp as fm

    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(bf)

    lines = []
    for n, c in MLP_SHAPES:
        f = 4 * c
        a = (randn(n, c), randn(c, scale=0.5) + 1.0, randn(c, scale=0.1),
             randn(f, c, scale=c ** -0.5), randn(f, scale=0.1),
             randn(c, f, scale=f ** -0.5), randn(c, scale=0.1))
        for res in (True, False):
            lines.append({"kernel": "fused_ln_mlp", "shape": [n, c], "add_residual": res,
                          "sha256": digest(fm.fused_ln_mlp(*a, add_residual=res))})
    for bw, h, d, p in WINDOW_SHAPES:
        qt, kt, vt = (randn(bw, h, d, 144) for _ in range(3))
        bias = torch.randn((p, h, 144, 144), generator=g, device="cuda")
        lines.append({"kernel": "fused_window_attention", "shape": [bw, h, d, 144, p],
                      "sha256": digest(fa.fused_window_attention(qt, kt, vt, bias,
                                                                 d ** -0.5))})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    for x in lines:
        print(json.dumps(x), flush=True)
    if args.against:
        theirs = [json.loads(x) for x in Path(args.against).read_text().splitlines()]
        differ = [a for a, b in zip(lines, theirs) if a != b]
        if differ or len(theirs) != len(lines):
            print(json.dumps({"same_bits": False, "differ": differ}), flush=True)
            return 1
        print(json.dumps({"same_bits": True, "outputs": len(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
