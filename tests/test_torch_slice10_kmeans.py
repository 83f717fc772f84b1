"""Stage 4's and stage 2's k-means on the CPU: the port's ``ops/kmeans.py``
and ``evaluation/clustering.py`` against the JAX package's.

- The port's Lloyd loop, started from the JAX package's own k-means++
  centroids (``_kmeans_pp_init`` with the same key), against JAX's
  ``masked_kmeans``: centroids within 1e-5 of max |JAX|, labels equal, for
  ragged masks, an empty cluster, all points equal and a batch of point sets
  of different masks.
- The port's seeding (inverse CDF over the k-means++ weights from explicit
  uniforms) picks valid rows only and distinct rows while any distance is
  positive, and falls back to uniform over the valid rows when every
  distance is 0.
- ``assign_labels`` 'l2' and 'dot' against JAX's.
- ``ClusteringModule``: the reservoir buffers and counts equal JAX's bit for
  bit for the same stream; the few-sample classes' centroids equal JAX's bit
  for bit; the bank is the same under chunk sizes 1 and 64; with JAX's
  per-class seeding patched in, the bank matches JAX's ``evaluate()`` within
  1e-5 of max |JAX|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partdistillation_tpu.evaluation.clustering import ClusteringModule as JClustering
from partdistillation_tpu.ops import kmeans as jkm
from partdistillation_torch.evaluation.clustering import SEED, ClusteringModule
from partdistillation_torch.ops import kmeans as pkm

ITERS = 30


def _close(got, want, rel, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


def _blobs(rng, n, d, k, spread=0.3):
    centers = rng.randn(k, d) * 4
    return (centers[rng.randint(0, k, n)] + rng.randn(n, d) * spread).astype(np.float32)


def _cases():
    rng = np.random.RandomState(0)
    ragged = _blobs(rng, 96, 8, 5)
    ragged_mask = rng.rand(96) < 0.6
    ragged[~ragged_mask] += 50.0  # invalid rows far away: they must not pull a centroid
    # three distinct values for five clusters: the seeding repeats a point,
    # and a repeated centroid owns no row (argmin takes the first of a tie)
    few = np.repeat(rng.randn(3, 4).astype(np.float32) * 3, [10, 7, 5], axis=0)
    equal = np.tile(rng.randn(1, 6).astype(np.float32), (40, 1))
    batch = np.stack([_blobs(rng, 64, 8, 4) for _ in range(3)])
    batch_mask = np.stack([np.arange(64) < n for n in (64, 37, 9)])
    return {
        "ragged": (ragged[None], ragged_mask[None], 5),
        "empty_cluster": (few[None], np.ones((1, 22), bool), 5),
        "all_equal": (equal[None], np.ones((1, 40), bool), 4),
        "batched": (batch, batch_mask, 4),
    }


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_lloyd_matches_jax_from_jax_seeding(case):
    x, mask, k = CASES[case]
    keys = jax.random.split(jax.random.PRNGKey(7), x.shape[0])
    init, want_c, want_l = [], [], []
    for b in range(x.shape[0]):
        xb, mb = jnp.asarray(x[b]), jnp.asarray(mask[b])
        init.append(np.asarray(jkm._kmeans_pp_init(xb, mb, k, keys[b])))
        c, lab = jkm.masked_kmeans(xb, mb, k, keys[b], iters=ITERS)
        want_c.append(np.asarray(c))
        want_l.append(np.asarray(lab))
    got_c, got_l = pkm.lloyd(torch.from_numpy(x), torch.from_numpy(mask),
                             torch.from_numpy(np.stack(init)), ITERS)
    assert got_c.dtype == torch.float32 and got_l.dtype == torch.int32
    _close(got_c.numpy(), np.stack(want_c), 1e-5, "centroids")
    np.testing.assert_array_equal(got_l.numpy(), np.stack(want_l))
    if case == "empty_cluster":
        assert len(np.unique(got_l.numpy()[mask])) < k
    if case == "all_equal":
        assert (got_l.numpy() == 0).all()
        _close(got_c.numpy(), np.broadcast_to(x[:, :1], got_c.shape), 1e-6)  # a mean of equals


def _uniforms(seed, b, k):
    return torch.from_numpy(np.random.RandomState(seed).random_sample((b, k)).astype(np.float32))


def _row_of(x, c):
    """Index of the row of x equal to c (-1 if none)."""
    hits = np.nonzero((x == c).all(-1))[0]
    return int(hits[0]) if len(hits) else -1


@pytest.mark.parametrize("seed", range(4))
def test_seeding_picks_distinct_valid_rows(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 50, 6).astype(np.float32)
    mask = rng.rand(3, 50) < 0.3
    mask[:, 7] = True
    k = 6
    cents = pkm.kmeans_pp_init(torch.from_numpy(x), torch.from_numpy(mask),
                               _uniforms(seed, 3, k)).numpy()
    for b in range(3):
        rows = [_row_of(x[b], c) for c in cents[b]]
        assert all(r >= 0 and mask[b, r] for r in rows), rows
        if mask[b].sum() >= k:
            assert len(set(rows)) == k, rows


def test_seeding_falls_back_to_uniform_when_every_distance_is_zero():
    # valid rows: two distinct values; invalid rows: other values
    x = np.zeros((1, 30, 3), np.float32)
    x[0, :] = np.arange(30, dtype=np.float32)[:, None]
    x[0, 0:10] = 1.0
    x[0, 10:20] = 2.0
    mask = np.zeros((1, 30), bool)
    mask[0, :20] = True
    cents = pkm.kmeans_pp_init(torch.from_numpy(x), torch.from_numpy(mask),
                               _uniforms(0, 1, 5)).numpy()[0]
    # both values are drawn first (positive distance), then uniform over the valid rows
    assert {float(v) for v in cents[:2, 0]} == {1.0, 2.0}
    assert set(cents[:, 0].tolist()) <= {1.0, 2.0}
    # all valid rows equal: every centroid is that row
    x2 = np.concatenate([np.full((1, 8, 3), 5.0, np.float32),
                         np.arange(12, dtype=np.float32).reshape(1, 4, 3)], axis=1)
    mask2 = np.array([[True] * 8 + [False] * 4])
    c2 = pkm.kmeans_pp_init(torch.from_numpy(x2), torch.from_numpy(mask2), _uniforms(1, 1, 4))
    assert (c2.numpy() == 5.0).all()


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_assign_labels_matches_jax(metric):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 11, 16).astype(np.float32)
    cents = rng.randn(5, 16).astype(np.float32)
    want = np.asarray(jkm.assign_labels(jnp.asarray(x), jnp.asarray(cents), metric))
    got = pkm.assign_labels(torch.from_numpy(x), torch.from_numpy(cents), metric)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_seed_uniforms_depend_on_the_id_only():
    a = pkm.seed_uniforms(0, [3, 9, "n01440764_1"], 8)
    b = pkm.seed_uniforms(0, ["n01440764_1", 9], 8)
    assert a.shape == (3, 8) and a.dtype == np.float32 and ((0 <= a) & (a < 1)).all()
    np.testing.assert_array_equal(a[2], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(pkm.seed_uniforms(1, [9], 8)[0], a[1])


# ---------------------------------------------------------------- ClusteringModule


NUM_OBJ, DIM, K, CAP = 12, 8, 3, 32


def _stream(seed=0, batches=6, b=4, q=10):
    """Feature batches over a few classes: class 2 overflows the reservoir,
    class 5 has exactly K features (too few), class 7 a handful."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(batches):
        feats = _blobs(rng, b * q, DIM, 4).reshape(b, q, DIM)
        valid = rng.rand(b, q) < 0.7
        classes = np.array([2, 7 if i % 2 else 2, 9, 2], np.int32)
        if i == 0:
            classes[2] = 5
            valid[2] = False
            valid[2, :K] = True
        out.append(({"feats": feats, "valid": valid}, classes))
    return out


@pytest.fixture(scope="module")
def stream():
    return _stream()


def _fill(module, stream):
    for outputs, classes in stream:
        module.process(outputs, classes)
    return module


def test_reservoir_buffers_equal_jax(stream):
    got = _fill(ClusteringModule(NUM_OBJ, DIM, K, capacity_per_class=CAP, device="cpu"), stream)
    want = _fill(JClustering(NUM_OBJ, DIM, K, capacity_per_class=CAP), stream)
    assert got._seen == want._seen and got._seen[2] > CAP
    assert set(got._feats) == set(want._feats)
    for c in want._feats:
        np.testing.assert_array_equal(got._feats[c], want._feats[c])


def _jax_seed(module, seed):
    """The port's per-chunk seeding replaced by JAX's: class c seeded by
    ``_kmeans_pp_init`` with ``split(PRNGKey(seed), C)[c]``, as JAX's
    ``evaluate()`` keys it."""
    keys = jax.random.split(jax.random.PRNGKey(seed), module.num_object_classes)

    def seed_fn(x, mask, classes):
        init = [np.asarray(jkm._kmeans_pp_init(jnp.asarray(x[i].numpy()),
                                               jnp.asarray(mask[i].numpy()), module.k,
                                               keys[int(c)]))
                for i, c in enumerate(classes)]
        return torch.from_numpy(np.stack(init))

    return seed_fn


def test_bank_matches_jax_evaluate_with_jax_seeding(stream):
    port = _fill(ClusteringModule(NUM_OBJ, DIM, K, capacity_per_class=CAP, device="cpu"), stream)
    port._seed = _jax_seed(port, SEED)
    want = _fill(JClustering(NUM_OBJ, DIM, K, capacity_per_class=CAP), stream).evaluate()
    got = port.evaluate()
    assert got.shape == want.shape == (NUM_OBJ, K, DIM) and got.dtype == np.float32
    clustered = port.counts() > K
    assert clustered.sum() == 3  # classes 2, 7 and 9
    _close(got[clustered], want[clustered], 1e-5, "clustered classes")
    np.testing.assert_array_equal(got[~clustered], want[~clustered])


def test_few_sample_classes_equal_jax_bit_for_bit(stream):
    got = _fill(ClusteringModule(NUM_OBJ, DIM, K, capacity_per_class=CAP, device="cpu"),
                stream).evaluate()
    want = _fill(JClustering(NUM_OBJ, DIM, K, capacity_per_class=CAP), stream).evaluate()
    few = np.ones(NUM_OBJ, bool)
    few[[2, 7, 9]] = False
    assert few[5]  # exactly K features: too few
    np.testing.assert_array_equal(got[few], want[few])
    np.testing.assert_array_equal(
        got[few], np.random.RandomState(0).randn(few.sum(), K, DIM).astype(np.float32))


def test_bank_does_not_depend_on_the_chunk_size(stream):
    banks = [_fill(ClusteringModule(NUM_OBJ, DIM, K, capacity_per_class=CAP, kmeans_chunk=n,
                                    device="cpu"), stream).evaluate() for n in (1, 64)]
    np.testing.assert_array_equal(banks[0], banks[1])
    assert np.isfinite(banks[0]).all()
