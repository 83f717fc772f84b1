"""The port's boundary: it imports neither JAX nor the JAX package, names no
JAX-package file, never builds its kernels when used on the CPU, runs its
entry points on CUDA unless told otherwise, and never falls back from a
kernel to its plain version for a tensor that is not on the CPU."""

import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "partdistillation_torch"


def _port_modules():
    import partdistillation_torch

    return ["partdistillation_torch"] + [
        m.name for m in pkgutil.walk_packages(partdistillation_torch.__path__,
                                              "partdistillation_torch.")]


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'partdistillation_tpu'))\n"
        "print(len(new), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_port_file_names_the_jax_package():
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert len(files) >= 20
    banned = ("partdistillation_tpu", "import jax", "from jax", "import flax", "from flax")
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if any(word in p.read_text() for word in banned)]
    assert offenders == []


def test_every_module_imports():
    for name in _port_modules():
        importlib.import_module(name)


def test_plain_versions_on_cpu_never_build_kernels():
    from partdistillation_torch.ops.layer_norm import fused_layer_norm
    from partdistillation_torch.utils import native_lib

    fused_layer_norm(torch.ones(2, 8), torch.ones(8), torch.zeros(8))
    assert native_lib._lib is None
    assert fused_layer_norm.launches == 0


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from partdistillation_torch import resolve_device

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _tiny_cfg():
    from partdistillation_torch.models.meta_arch.proposal import ProposalModelConfig
    from partdistillation_torch.models.pixel_decoder import PixelDecoderConfig
    from partdistillation_torch.models.segmenter import SegmenterConfig
    from partdistillation_torch.models.swin import SwinConfig
    from partdistillation_torch.models.transformer_decoder import TransformerDecoderConfig

    return ProposalModelConfig(
        segmenter=SegmenterConfig(
            swin=SwinConfig(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 1, 2, 2),
                            window_size=4),
            pixel_decoder=PixelDecoderConfig(conv_dim=32, mask_dim=32, transformer_layers=1,
                                             transformer_ffn_dim=32, n_heads=4, n_points=1),
            decoder=TransformerDecoderConfig(hidden_dim=32, num_queries=4, num_heads=4,
                                             dim_feedforward=32, dec_layers=1, mask_dim=32)),
        test_topk=4)


def test_entry_points_raise_without_cuda_unless_cpu(monkeypatch):
    from partdistillation_torch.models.meta_arch.proposal import make_inference_fn
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    _no_cuda(monkeypatch)
    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError):
        MaskFormerSegmenter(cfg.segmenter)
    model = MaskFormerSegmenter(cfg.segmenter, device="cpu")
    with pytest.raises(RuntimeError):
        make_inference_fn(cfg, model)
    infer = make_inference_fn(cfg, model, device="cpu")
    out = infer({"image": np.zeros((1, 32, 32, 3), np.uint8),
                 "part_masks": np.ones((1, 1, 32, 32), bool),
                 "part_labels": np.zeros((1, 1), np.int32),
                 "part_valid": np.ones((1, 1), bool),
                 "object_masks": np.ones((1, 1, 32, 32), bool),
                 "object_valid": np.ones((1, 1), bool)})
    assert out["pred_masks"].shape == (1, 4, 32, 32)


def test_train_entry_points_raise_without_cuda_unless_cpu(monkeypatch):
    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.models.meta_arch.proposal import make_loss_fn
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    _no_cuda(monkeypatch)
    cfg = _tiny_cfg()
    model = MaskFormerSegmenter(cfg.segmenter, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_loss_fn(cfg, model)
    loss_fn = make_loss_fn(cfg, model, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(loss_fn, model, OptimizerConfig())
    trainer = Trainer(loss_fn, model, OptimizerConfig(), device="cpu")
    metrics = trainer.train_step({"image": np.zeros((1, 32, 32, 3), np.uint8),
                                  "masks": np.ones((1, 2, 32, 32), bool),
                                  "valid": np.array([[True, False]])})
    assert trainer.step == 1 and np.isfinite(metrics["total_loss"])
    assert metrics.keys() >= {"loss_ce", "loss_mask", "loss_dice", "grad_norm"}


@pytest.mark.parametrize("kind", ["pixel_decoder_type", "decoder_type"])
def test_unported_heads_raise(kind):
    """Every head of the JAX package is ported; a name outside them raises."""
    import dataclasses

    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    cfg = dataclasses.replace(_tiny_cfg().segmenter, **{kind: "vit_adapter"})
    with pytest.raises(ValueError, match="options"):
        MaskFormerSegmenter(cfg, device="cpu")


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("op", ["layer_norm", "mlp", "window", "masked", "masked_fwd_lse",
                                "masked_bwd", "window_proj", "msda_folded",
                                "sample_level_folded", "sample_level"])
def test_wrappers_refuse_non_cpu_tensors_they_cannot_launch_on(op):
    """A tensor that is not on the CPU never gets the plain version: here a
    meta tensor, which no kernel takes, raises instead of falling back."""
    from partdistillation_torch.ops import fused_attention as fa
    from partdistillation_torch.ops import fused_mlp as fm
    from partdistillation_torch.ops import layer_norm as ln
    from partdistillation_torch.ops import msda_sampling as ms

    f32 = torch.float32
    calls = {
        "layer_norm": lambda: ln.fused_layer_norm(_meta(4, 8), _meta(8), _meta(8)),
        "mlp": lambda: fm.fused_ln_mlp(_meta(4, 16), _meta(16), _meta(16), _meta(64, 16),
                                       _meta(64), _meta(16, 64), _meta(16)),
        "window": lambda: fa.fused_window_attention(_meta(2, 1, 16, 16), _meta(2, 1, 16, 16),
                                                    _meta(2, 1, 16, 16),
                                                    _meta(1, 1, 16, 16, dtype=torch.float32)),
        "masked": lambda: fa.fused_masked_attention(_meta(1, 1, 4, 16), _meta(1, 1, 8, 16),
                                                    _meta(1, 1, 8, 16)),
        "masked_fwd_lse": lambda: fa.masked_attention_fwd_lse(
            _meta(1, 1, 4, 16), _meta(1, 1, 8, 16), _meta(1, 1, 8, 16)),
        "masked_bwd": lambda: fa.fused_masked_attention_bwd(
            _meta(1, 1, 4, 16), _meta(1, 1, 8, 16), _meta(1, 1, 8, 16),
            _meta(1, 1, 4, 8, dtype=torch.uint8), _meta(1, 1, 4, 16),
            _meta(1, 1, 4, dtype=torch.float32), _meta(1, 1, 4, 16)),
        "window_proj": lambda: fa.fused_window_attention_proj(
            _meta(2, 1, 16, 16), _meta(2, 1, 16, 16), _meta(2, 1, 16, 16),
            _meta(1, 1, 16, 16, dtype=f32), _meta(16, 16), _meta(16)),
        "msda_folded": lambda: ms.msda_folded(_meta(1, 6, 2, 32), ((2, 3),),
                                              _meta(1, 4, 2, 1, 2, 2, dtype=f32),
                                              _meta(1, 4, 2, 1, 2)),
        "sample_level_folded": lambda: ms.sample_level_folded(
            _meta(2, 6, 32), *[_meta(2, 3, 5, dtype=f32)] * 3, 2, 3),
        "sample_level": lambda: ms.sample_level(_meta(2, 3, 2 * 32),
                                                *[_meta(2, 5, dtype=f32)] * 3, 2, 3),
    }
    with pytest.raises(ValueError, match="unsupported device"):
        calls[op]()


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero with no result line on a CPU-only box, and
    in a directory that holds nothing else of the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                              text=True, timeout=120, env={"PATH": "/usr/bin:/bin",
                                                          "PYTHONNOUSERSITE": "1"})
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
