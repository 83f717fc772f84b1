"""The port's f32 stages on the card with TF32 turned on for the whole
process through both flags (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), as a user's process may have them:

- the Lloyd fit against the CPU's at the bank's chunk and at stage 2's
  batch, seeds 0-2: within ``chip_smoke``'s limits (centroids 5e-7);
- stage 2's full-resolution labels (``label_pixels``) and stage 4's
  classifier scores against the CPU's on the same inputs: labels equal,
  scores within 1e-5 of their scale;
- the dCRF at the CLI's parameters on two 640^2 images against the CPU
  within phase 12's limits, and its planted fault (the colour term dropped)
  outside them;
- with ``TORCH_ALLOW_TF32_CUBLAS_OVERRIDE=1`` the k-means and the dCRF
  refuse to run on the card (a subprocess).

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On the card: ``python -m pytest --noconftest -p no:cacheprovider -s
tests/test_torch_slice11_precision_cuda.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.cuda


@pytest.fixture
def tf32_process():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the TF32 flags act on the card only)")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", ["rank_chunk", "propose_batch"])
def test_lloyd_matches_the_cpu_with_tf32_on(tf32_process, shape, seed):
    cs = _smoke()
    fit = cs.kmeans_card_vs_cpu(seed, *cs.KMEANS_SHAPES[shape])
    print(json.dumps({"shape": shape, "seed": seed, "fit": fit}))
    assert fit["ok"], fit
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_stage2_labels_and_rank_scores_match_the_cpu_with_tf32_on(tf32_process):
    from partdistillation_torch.models.meta_arch.part_ranking import classifier_scores
    from partdistillation_torch.models.meta_arch.proposal_generation import label_pixels

    g = torch.Generator().manual_seed(0)
    feat = torch.randn(40, 40, 1152, generator=g)
    cents = torch.randn(4, 1152, generator=g)
    want = label_pixels(feat, cents, 320, 320)
    got = label_pixels(feat.cuda(), cents.cuda(), 320, 320).cpu()
    assert torch.equal(got, want)
    feats = torch.randn(200, 256, generator=g)
    bank = torch.randn(8, 256, generator=g)
    for metric in ("dot", "l2"):
        want = classifier_scores(feats, bank, metric)
        got = classifier_scores(feats.cuda(), bank.cuda(), metric).cpu()
        diff = float((got - want).abs().max())
        print(json.dumps({"metric": metric, "max_abs_diff": diff}))
        assert diff <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dcrf_matches_the_cpu_with_tf32_on(tf32_process, seed):
    cs = _smoke()
    _, _, crf = cs.front_check_inputs(seed)
    check = cs.dcrf_card_vs_cpu(*crf)
    print(json.dumps({"seed": seed, "dcrf": check}))
    assert check["sound"]["ok"], check
    assert not check["colour_dropped"]["ok"], check


def test_tf32_override_is_refused_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    code = (
        "import torch\n"
        "from partdistillation_torch.ops.dense_crf import dense_crf\n"
        "from partdistillation_torch.ops.kmeans import lloyd\n"
        "x = torch.randn(1, 64, 8, device='cuda')\n"
        "calls = (lambda: lloyd(x, torch.ones(1, 64, dtype=torch.bool, device='cuda'),\n"
        "                       x[:, :4].clone()),\n"
        "         lambda: dense_crf(torch.rand(1, 32, 32, 3, device='cuda') * 255,\n"
        "                           torch.rand(1, 32, 32, 3, device='cuda')))\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "        print('ran')\n"
        "    except RuntimeError as e:\n"
        "        print('refused:', e)\n")
    env = dict(os.environ, TORCH_ALLOW_TF32_CUBLAS_OVERRIDE="1", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 2 and all(
        line.startswith("refused: TORCH_ALLOW_TF32_CUBLAS_OVERRIDE") for line in lines), lines
