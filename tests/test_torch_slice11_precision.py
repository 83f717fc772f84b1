"""Full f32 precision in the port's f32 stages (``utils/precision.py``).

- ``full_f32`` turns both TF32 flags off inside and gives the caller's
  values back on exit, also when the body raises;
- under ``TORCH_ALLOW_TF32_CUBLAS_OVERRIDE=1`` it raises for a CUDA device
  and not for the CPU (in a subprocess: the variable is read per call);
- every f32 product and convolution of the f32 stages enters it, with both
  flags off inside, while the caller has both on: the k-means distances,
  Lloyd sums and dot labels, stage 2's full-resolution labels, stage 4's
  classifier scores, the dCRF's blur and window apply, the CLIP crops and
  an f32 CLIP tower; the bf16 tower does not.
A CPU run cannot show TF32 itself; ``test_torch_slice11_precision_cuda.py``
does, on the card.
"""

import contextlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from partdistillation_torch.utils import precision

ROOT = Path(__file__).resolve().parent.parent
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@contextlib.contextmanager
def _caller_flags(matmul, cudnn):
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("flags", FLAGS)
def test_full_f32_pins_and_restores_the_flags(flags):
    with _caller_flags(*flags):
        with precision.full_f32("cpu"):
            assert _flags() == (False, False)
        assert _flags() == flags
        with pytest.raises(ZeroDivisionError):
            with precision.full_f32(torch.device("cpu")):
                assert _flags() == (False, False)
                1 / 0
        assert _flags() == flags


@pytest.mark.parametrize("value,raises", [("1", True), ("0", False), ("", False)])
def test_tf32_override_refused_on_cuda_only(value, raises):
    code = (
        "import torch\n"
        "from partdistillation_torch.utils.precision import full_f32\n"
        "with full_f32('cpu'):\n"
        "    pass\n"
        "try:\n"
        "    with full_f32(torch.device('cuda')):\n"
        "        pass\n"
        "except RuntimeError as e:\n"
        "    print('refused:', e)\n")
    env = {"PATH": "/usr/bin:/bin", "TORCH_ALLOW_TF32_CUBLAS_OVERRIDE": value,
           "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert ("refused: TORCH_ALLOW_TF32_CUBLAS_OVERRIDE" in proc.stdout) == raises, proc.stdout


def _sites():
    """(name, module whose ``full_f32`` the site calls, the call)."""
    from partdistillation_torch.models import clip_vit
    from partdistillation_torch.models.meta_arch import labeling, part_ranking
    from partdistillation_torch.models.meta_arch import proposal_generation as pg
    from partdistillation_torch.ops import dense_crf, kmeans, resize

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 40, 6, generator=g)
    mask = torch.ones(2, 40, dtype=torch.bool)
    c = torch.randn(2, 3, 6, generator=g)
    image = torch.rand(1, 24, 28, 3, generator=g) * 255
    q = torch.softmax(torch.randn(1, 24, 28, 3, generator=g), -1)
    band, geom = dense_crf._bilateral_conv_setup(image, 8.0, 13.0)
    masks = torch.zeros(1, 2, 24, 28, dtype=torch.bool)
    masks[0, 0, 3:9, 4:20] = True
    tower = clip_vit.CLIPVisionTower(clip_vit.CLIPVisionTowerConfig(
        image_size=16, patch_size=8, hidden_size=16, num_layers=1, num_heads=2,
        intermediate_size=32, projection_dim=8), device="cpu")
    return [
        ("pairwise_sqdist", kmeans, lambda: kmeans.pairwise_sqdist(x, c)),
        ("lloyd", kmeans, lambda: kmeans.lloyd(x, mask, c, iters=2)),
        ("assign_labels_dot", kmeans, lambda: kmeans.assign_labels(x[0], c[0], "dot")),
        ("stage2_labels", pg, lambda: pg.label_pixels(x[0].reshape(5, 8, 6), c[0], 10, 16)),
        ("rank_scores", part_ranking,
         lambda: part_ranking.classifier_scores(x[0], c[0], "l2")),
        ("dcrf_blur", dense_crf, lambda: dense_crf.gaussian_blur(q, 3.0)),
        ("dcrf_apply", dense_crf, lambda: dense_crf._bilateral_conv_apply(q, band, geom)),
        ("resize", resize, lambda: resize.resize(q[0], 7, 9, resize.keys_cubic_kernel)),
        ("clip_crops", labeling, lambda: labeling.crop_regions(image, masks, 16)),
        ("clip_tower_f32", clip_vit, lambda: tower(torch.randn(2, 16, 16, 3))),
    ]


@pytest.mark.parametrize("index", range(10))
def test_every_f32_site_computes_in_full_f32(index, monkeypatch):
    name, module, call = _sites()[index]
    seen = []
    real = precision.full_f32

    @contextlib.contextmanager
    def spy(device):
        with real(device):
            seen.append(_flags())
            yield

    monkeypatch.setattr(module, "full_f32", spy)
    with _caller_flags(True, True):
        out = call()
        assert _flags() == (True, True)
    assert seen and all(f == (False, False) for f in seen), (name, seen)
    assert all(torch.isfinite(t).all() for t in (out if isinstance(out, tuple) else (out,))
               if t.is_floating_point())


def test_bf16_clip_tower_leaves_the_flags_alone(monkeypatch):
    from partdistillation_torch.models import clip_vit

    entered = []
    monkeypatch.setattr(clip_vit, "full_f32", lambda device: entered.append(device))
    tower = clip_vit.CLIPVisionTower(clip_vit.CLIPVisionTowerConfig(
        image_size=16, patch_size=8, hidden_size=16, num_layers=1, num_heads=2,
        intermediate_size=32, projection_dim=8, dtype=torch.bfloat16), device="cpu")
    out = tower(torch.randn(2, 16, 16, 3))
    assert out.dtype == torch.bfloat16 and entered == []
    assert torch.isfinite(out.float()).all()
