"""The k-means stages on the card: the Lloyd fit against the CPU's, the
bit packing of device masks, and one ``propose`` batch through ``run.main``.

- At the bank's chunk (64 classes x 4096 rows x 256, k = 8, 30 iterations,
  ragged masks) and at stage 2's batch (2 images x 6400 rows x 1152, k = 4),
  from the same k-means++ seeding, at seeds 0-2: labels agree on >= 99.9 %
  of the valid rows and the centroids within 5e-7 (``chip_smoke``'s
  limits); the mask ignored in the update, and the points and initial
  centroids rounded to TF32 (what TF32 products did to them; the fit itself
  runs in full f32 whatever the TF32 flags say), each fail the same check. Each case prints its readings (run with ``-s`` to see them).
- ``pack_bits`` on the card equals ``np.packbits``.
- ``propose`` at its full-size default (Swin-L bf16, B = 2) over
  ``chip_smoke.cli_dataset`` with a stage-1 store of each image's proposal
  union: one batch launches each kernel ``chip_smoke.PER_PROPOSE_FORWARD``
  times.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false. On the card: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_slice10_kmeans_cuda.py``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from partdistillation_torch.utils.bitpack import pack_bits

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", ["rank_chunk", "propose_batch"])
def test_lloyd_on_the_card_matches_the_cpu(cuda, shape, seed):
    cs = _smoke()
    fit = cs.kmeans_card_vs_cpu(seed, *cs.KMEANS_SHAPES[shape])
    planted = {fault: cs.kmeans_card_vs_cpu(seed, *cs.KMEANS_SHAPES[shape], fault=fault)
               for fault in cs.KMEANS_FAULTS}
    print(json.dumps({"shape": shape, "seed": seed, "fit": fit, "planted": planted}))
    assert fit["ok"], fit
    assert not any(f["ok"] for f in planted.values()), planted


def test_pack_bits_on_the_card(cuda):
    x = np.random.default_rng(0).random((2, 32, 640, 640)) < 0.3
    got = pack_bits(torch.from_numpy(x).cuda()).cpu().numpy()
    np.testing.assert_array_equal(got, np.packbits(x, axis=-1))


def test_propose_full_width_one_batch(cuda, tmp_path, capsys):
    cs = _smoke()
    from partdistillation_torch import run

    ov = cs.cli_dataset(str(tmp_path), 0)
    cs.stage1_store(str(tmp_path))
    cs.reset_launches()
    run.main(["propose", "--allow-random-init", "--set", *ov, "data.batch_size=2",
              "data.debug_limit=2"])
    res = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")][-1]
    assert res["stage"] == "propose" and 0 < res["saved"] <= 2
    assert cs.launch_counts() == cs.PER_PROPOSE_FORWARD
