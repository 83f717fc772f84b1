"""The train step's spans on the card: a full-width unfrozen stage-3 step
(``chip_smoke.train_config`` with the trunk trained and Swin's plain window
attention, as the supervised benchmark cell runs it) traced for two steps.

- Each of the trunk's four plain-VJP spans (``bwd.layer_norm``,
  ``bwd.ln_mlp``, ``bwd.window_attn``, ``bwd.msda``) holds device time.
- ``backward_by_scope``'s four forward parts (backbone, pixel decoder,
  decoder, criterion) hold at least 95 % of the ``backward`` scope's device
  time; Swin's three spans fit in the backbone's part and the sampling's in
  the pixel decoder's.

Marked ``cuda``: skips where ``torch.cuda.is_available()`` is false. On the
card: ``python -m pytest --noconftest -p no:cacheprovider -s
tests/test_torch_train_spans_cuda.py`` (``-s`` prints the readings).
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
TRUNK_SPANS = ("bwd.layer_norm", "bwd.ln_mlp", "bwd.window_attn")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels have no CPU mode)")


def test_unfrozen_step_backward_by_part_and_op(cuda, tmp_path):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.models.meta_arch.proposal import make_loss_fn
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter
    from partdistillation_torch.utils.profiling import summarize_trace, trace_steps

    cfg = cs.train_config()
    seg = dataclasses.replace(cfg.segmenter, freeze_backbone=False, freeze_pixel_decoder=False)
    cfg = dataclasses.replace(cfg, segmenter=seg)
    model = MaskFormerSegmenter(seg, device="cuda", seed=0)
    trainer = Trainer(make_loss_fn(cfg, model, device="cuda"), model, OptimizerConfig(),
                      device="cuda", seed=0)
    batch = cs.synthetic_train_batch(np.random.default_rng(0), cs.BATCH_SIZE, cs.IMAGE_SIZE)
    trace_steps(lambda: trainer.train_step(batch), str(tmp_path), steps=2)
    _, detail = summarize_trace(str(tmp_path), steps=2, return_detail=True)
    by_span, parts = detail["device_by_span"], detail["backward_by_scope"]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "backward_by_scope": parts,
                      "bwd_ms": {k: v for k, v in by_span.items() if k.startswith("bwd.")},
                      "backward_ms": by_span["backward"]}))
    for name in TRUNK_SPANS + ("bwd.msda",):
        assert by_span.get(name, 0.0) > 0.0, name
    four = sum(parts.get(k, 0.0) for k in ("backbone", "pixel_decoder", "transformer_decoder",
                                            "criterion"))
    assert four >= 0.95 * by_span["backward"], (four, by_span["backward"])
    assert sum(by_span[k] for k in TRUNK_SPANS) <= parts["backbone"]
    assert by_span["bwd.msda"] <= parts["pixel_decoder"]
