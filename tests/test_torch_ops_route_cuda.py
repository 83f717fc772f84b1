"""The swap to plain versions on the card covers every model: a ViTDet-L
block (``models/vitdet._Block`` at ViTDet-L's widths, bf16, 1024 x 1024:
a 64 x 64 token grid), window and global, forward and backward. Without
the swap one step of the block launches the LayerNorm (#1), the fused
LN -> MLP (#2) and the relative-position attention (#10), forward and
backward; under ``chip_smoke.plain_versions`` it launches none of them,
since the route in ``ops/`` decides for every importer of a wrapper.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On the card: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_ops_route_cuda.py``.
"""

import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels have no CPU mode)")


@pytest.mark.parametrize("window", [True, False])
def test_vitdet_block_under_the_swap_launches_no_kernel(cuda, window):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    from partdistillation_torch.models.vitdet import _Block, vitdet_large_config

    cfg = vitdet_large_config(dtype=torch.bfloat16)
    block = _Block(cfg, drop_path=0.0, window=window).cuda()
    block.attn.reset_parameters_with(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    side = cfg.img_size // cfg.patch_size
    x = torch.randn((1, side, side, cfg.embed_dim), generator=g, device="cuda")
    x = x.to(torch.bfloat16).requires_grad_()

    def step():
        block.zero_grad(set_to_none=True)
        out = block(x)
        out.float().square().mean().backward()
        torch.cuda.synchronize()
        return out

    cs.reset_launches()
    out_k = step()
    launched = cs.launch_counts()
    assert {k: launched[k] for k in ("layer_norm", "fused_ln_mlp", "relpos_attention",
                                     "relpos_attention_bwd")} == {
        "layer_norm": 1, "fused_ln_mlp": 1, "relpos_attention": 1, "relpos_attention_bwd": 1}
    cs.reset_launches()
    with cs.plain_versions():
        out_p = step()
    assert set(cs.launch_counts().values()) == {0}, cs.launch_counts()
    assert x.grad is not None and torch.isfinite(x.grad.float()).all()
    gap = (out_k.float() - out_p.float()).norm() / out_p.float().norm()
    assert gap < 2e-2, gap.item()
