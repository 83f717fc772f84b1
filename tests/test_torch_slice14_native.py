"""The port's host library (``csrc_host/``, built with ``g++`` at first use)
against its plain versions and the JAX package on the CPU.

- the RLE codec (``utils/rle.py``): ``encode``'s bytes equal the numpy
  codec's (``encode_plain``) and the JAX package's ``utils/rle.encode`` on
  random masks of many densities and shapes and on edge masks (empty, full,
  one pixel, a corner, a column, 1 x N, N x 1, 0 x N, a checkerboard, a
  non-bool mask; at 0 x N the JAX package's C++ and numpy codecs disagree,
  and the port keeps its numpy codec's empty counts); ``decode`` gives the
  mask back; ``area`` and ``iou_matrix`` equal the numpy and JAX values exactly (the IoU is a ratio
  of integers in f64); a store written by the port reads back;
- a build failure raises naming ``g++`` (no numpy fallback);
- ``ops/native.ms_deform_attn_cpu`` against the port's plain MSDA
  (``ops/ms_deform_attn.ms_deform_attn`` on CPU tensors) and JAX's
  composition at 1e-5, with taps off the map on every side, a zero
  attention weight and single-pixel levels; it refuses mismatched shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_torch.ops.ms_deform_attn import ms_deform_attn
from partdistillation_torch.ops.native import ms_deform_attn_cpu
from partdistillation_torch.utils import native_lib
from partdistillation_torch.utils import rle
from partdistillation_tpu.ops import ms_deform_attn as jmsda
from partdistillation_tpu.utils import rle as jrle


def _edge_masks():
    out = {"empty": np.zeros((9, 7), bool), "full": np.ones((9, 7), bool)}
    m = np.zeros((9, 7), bool)
    m[4, 3] = True
    out["one-pixel"] = m
    m = np.zeros((9, 7), bool)
    m[0, 0] = m[-1, -1] = True
    out["corners"] = m
    m = np.zeros((9, 7), bool)
    m[:, 2] = True
    out["column"] = m
    out["row-1xN"] = np.random.RandomState(1).rand(1, 33) < 0.5
    out["col-Nx1"] = np.random.RandomState(2).rand(33, 1) < 0.5
    out["zero-size"] = np.zeros((0, 5), bool)
    out["checkerboard"] = (np.indices((16, 13)).sum(0) % 2).astype(bool)
    out["uint8-values"] = (np.random.RandomState(3).rand(12, 10) < 0.4).astype(np.uint8)
    return out


EDGES = _edge_masks()


@pytest.mark.parametrize("name", list(EDGES))
def test_edge_masks_encode_like_numpy_and_jax(name):
    mask = EDGES[name]
    got = rle.encode(mask)
    assert got == rle.encode_plain(mask)
    assert got["counts"] == jrle._compress_counts(jrle._mask_to_runs(mask))
    if mask.size:  # a 0 x N mask: the JAX package's C++ codec writes "0", its numpy ""
        assert got["counts"] == jrle.encode(mask)["counts"]
    np.testing.assert_array_equal(rle.decode(got), mask.astype(np.uint8))
    assert rle.area(got) == rle.area_plain(got) == int(mask.astype(bool).sum())


@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 0.5, 0.97, 1.0])
@pytest.mark.parametrize("shape", [(64, 64), (375, 500), (31, 7)])
def test_random_masks_encode_like_numpy_and_jax(shape, density):
    rng = np.random.default_rng(int(density * 100) + shape[0])
    masks = rng.random((3,) + shape) < density
    blobs = np.zeros(shape, bool)  # long runs: multi-group deltas in the counts
    blobs[shape[0] // 4: 3 * shape[0] // 4, shape[1] // 3:] = True
    for m in [*masks, blobs]:
        got = rle.encode(m)
        assert got == rle.encode_plain(m) == {"size": list(shape),
                                              "counts": jrle.encode(m)["counts"]}
        np.testing.assert_array_equal(rle.decode(got), m)
        np.testing.assert_array_equal(rle.decode_plain(got), m)
        assert rle.area(got) == int(m.sum())
        # str counts (a store's json) decode the same
        assert rle.area({"size": got["size"], "counts": got["counts"].decode()}) == int(m.sum())


def test_iou_matrix_equals_numpy_and_jax():
    rng = np.random.default_rng(4)
    masks = [rng.random((40, 30)) < p for p in (0.1, 0.5, 0.9)] + [
        np.zeros((40, 30), bool), np.ones((40, 30), bool)]
    dets = [rle.encode(m) for m in masks]
    gts = [rle.encode(m) for m in masks[::-1]] + [rle.encode(masks[1] & masks[2])]
    got = rle.iou_matrix(dets, gts)
    np.testing.assert_array_equal(got, rle.iou_matrix_plain(dets, gts))
    np.testing.assert_array_equal(got, jrle.iou_matrix(dets, gts))
    assert got.shape == (5, 6) and got[4, 0] == 1.0 and got[3, 1] == 0.0
    assert rle.iou_matrix(dets, []).shape == (5, 0)
    # raw count lists take the numpy path
    raw = [{"size": [2, 2], "counts": [1, 2, 1]}]
    np.testing.assert_array_equal(rle.iou_matrix(raw, raw), [[1.0]])
    np.testing.assert_array_equal(rle.decode(raw[0]), [[0, 1], [1, 0]])


def test_invalid_counts_raise():
    with pytest.raises(ValueError, match="sum"):
        rle.decode({"size": [4, 4], "counts": rle.encode(np.ones((3, 3), bool))["counts"]})
    with pytest.raises(ValueError, match="HxW"):
        rle.encode(np.zeros((2, 2, 2), bool))


def test_store_round_trip(tmp_path):
    from partdistillation_torch.data.pseudo_store import PseudoLabelStore, ShardWriter

    rng = np.random.default_rng(5)
    masks = [rng.random((20, 24)) < 0.4 for _ in range(3)]
    with ShardWriter(str(tmp_path / "store"), 0, 1) as w:
        w.write({"image_id": "a", "part_masks": [rle.encode(m) for m in masks]})
    rec = PseudoLabelStore(str(tmp_path / "store")).get("a")
    for r, m in zip(rec["part_masks"], masks):
        assert r["counts"] == rle.encode_plain(m)["counts"]
        np.testing.assert_array_equal(rle.decode(r), m)


def test_failed_build_names_gxx(tmp_path, monkeypatch):
    monkeypatch.setattr(native_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native_lib.build_host_library()
    (tmp_path / "bin").mkdir()
    fake = tmp_path / "bin" / "g++"
    fake.write_text("#!/bin/sh\necho 'fake compiler error' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*fake compiler error"):
        native_lib.build_host_library()
    assert not list((tmp_path / "build").glob("libpd_host_*"))


LEVELS = ((8, 6), (4, 3), (1, 1))


def _msda_inputs(seed, b=2, q=7, m=2, d=4, p=3):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in LEVELS)
    value = rng.standard_normal((b, s, m, d)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (b, q, m, len(LEVELS), p, 2)).astype(np.float32)
    loc[0, 0, 0, 0, 0] = (-0.2, 0.5)   # off the left edge
    loc[0, 0, 0, 0, 1] = (1.2, 0.5)    # off the right edge
    loc[0, 1, 0, 0, 0] = (0.5, -0.2)   # above
    loc[0, 1, 0, 0, 1] = (0.5, 1.2)    # below
    loc[1, 0, 1, 1, 0] = (0.0, 0.0)    # the corner
    weights = rng.random((b, q, m, len(LEVELS), p)).astype(np.float32)
    weights[1, 2, 0, 0, 0] = 0.0
    return value, loc, weights


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ms_deform_attn_cpu_matches_plain_and_jax(seed):
    value, loc, weights = _msda_inputs(seed)
    got = ms_deform_attn_cpu(torch.from_numpy(value), LEVELS, torch.from_numpy(loc),
                             torch.from_numpy(weights))
    plain = ms_deform_attn(torch.from_numpy(value), LEVELS, torch.from_numpy(loc),
                           torch.from_numpy(weights))
    want = np.asarray(jmsda.ms_deform_attn(jnp.asarray(value), LEVELS, jnp.asarray(loc),
                                           jnp.asarray(weights)))
    assert got.shape == (2, 7, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_ms_deform_attn_cpu_refuses_what_it_cannot_take():
    value, loc, weights = map(torch.from_numpy, _msda_inputs(0))
    with pytest.raises(ValueError, match="do not sum"):
        ms_deform_attn_cpu(value, ((8, 6), (4, 3), (2, 1)), loc, weights)
    with pytest.raises(ValueError, match="do not fit"):
        ms_deform_attn_cpu(value, LEVELS, loc[:, :, :1], weights)
    with pytest.raises(ValueError, match="CPU"):
        ms_deform_attn_cpu(value.to("meta"), LEVELS, loc, weights)
