"""Parity of the port's DenseIndex (sessionsimilaritysearch_tpu_torch/index
/dense.py) with the JAX DenseIndex on the same rows: every combination of
metric, storage dtype and score dtype, with streaming adds in three batches,
a multi-chunk scan, k beyond the filled rows, row masks and reconstruction.

Tolerances: float32 scores agree to 1e-5 (sums in another order);
bfloat16 storage or scores to two bf16 ulps of the per-query scale (both
sides round to bf16, at places that can differ by one ulp). The port's ids
must reach value-recall 1.0 at the same tolerance against the rows it
stores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.index.dense import DenseIndex as JaxDenseIndex
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
from sessionsimilaritysearch_tpu_torch.ops import mips
from sessionsimilaritysearch_tpu_torch.ops.topk import value_recall_at_k

DIM, CAP, CHUNK = 32, 600, 256
BATCHES = (200, 150, 100)  # 450 rows: two full chunks and a ragged one
BF16_TOL = 2 * 2.0**-8
COMBOS = [
    (metric, dtype, score_dtype)
    for metric in ("cos", "ip")
    for dtype in ("float32", "bfloat16")
    for score_dtype in ("float32", "bfloat16")
]


def _pair(metric, dtype, score_dtype):
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((sum(BATCHES), DIM)).astype(np.float32)
    queries = rng.standard_normal((20, DIM)).astype(np.float32)
    j = JaxDenseIndex(DIM, CAP, metric=metric, dtype=getattr(jnp, dtype),
                      chunk_size=CHUNK, score_dtype=getattr(jnp, score_dtype))
    t = DenseIndex(DIM, CAP, device="cpu", metric=metric,
                   dtype=getattr(torch, dtype), chunk_size=CHUNK,
                   score_dtype=getattr(torch, score_dtype))
    start = 0
    for m in BATCHES:
        j.add(rows[start: start + m])
        t.add(rows[start: start + m])
        start += m
    tol = 1e-5 if dtype == score_dtype == "float32" else BF16_TOL
    return j, t, queries, tol


def _check(j_res, t_res, t, queries, k, tol, mask=None):
    (Dj, Ij), (Dt, It) = j_res, t_res
    assert Dt.shape == It.shape == (len(queries), k)
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    missing = It < 0
    np.testing.assert_array_equal(missing, Ij < 0)
    assert np.isneginf(Dt[missing]).all()
    scale = np.abs(Dj[~missing]).max()
    np.testing.assert_allclose(Dt[~missing], Dj[~missing],
                               atol=tol * scale, rtol=0)
    # value-recall against the rows as the port stores them (live rows only
    # under a mask, with ids renumbered into that subset)
    stored = t.reconstruct_batch(np.arange(t.ntotal))
    ids = It[:, : int((~missing).sum(axis=1).min())]
    if mask is not None:
        assert mask[It[~missing]].all()  # filtered rows never rank
        stored = stored[mask]
        ids = (np.cumsum(mask) - 1)[ids]
    q = queries
    if t.metric == "cos":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    assert value_recall_at_k(ids, q, stored, ids.shape[1], rel_tol=tol) == 1.0


@pytest.mark.parametrize("metric,dtype,score_dtype", COMBOS)
class TestDenseIndexParity:
    def test_search_streamed(self, metric, dtype, score_dtype):
        j, t, queries, tol = _pair(metric, dtype, score_dtype)
        assert t.ntotal == j.ntotal == sum(BATCHES)
        _check(j.search(queries, 10), t.search(queries, 10), t, queries, 10, tol)

    def test_search_k_beyond_size(self, metric, dtype, score_dtype):
        j, t, queries, tol = _pair(metric, dtype, score_dtype)
        k = 500  # > 450 rows: 50 missing slots per query
        Dt, It = t.search(queries, k)
        assert (It[:, 450:] == -1).all() and (It[:, :450] >= 0).all()
        _check(j.search(queries, k), (Dt, It), t, queries, k, tol)

    def test_search_row_mask(self, metric, dtype, score_dtype):
        j, t, queries, tol = _pair(metric, dtype, score_dtype)
        mask = np.random.default_rng(1).random(t.ntotal) < 0.4
        _check(j.search(queries, 10, row_mask=mask),
               t.search(queries, 10, row_mask=mask), t, queries, 10, tol,
               mask=mask)
        # a capacity-length mask means the same
        full = np.zeros(CAP, bool)
        full[: t.ntotal] = mask
        np.testing.assert_array_equal(t.search(queries, 10, row_mask=full)[1],
                                      t.search(queries, 10, row_mask=mask)[1])

    def test_reconstruct_batch(self, metric, dtype, score_dtype):
        j, t, _, tol = _pair(metric, dtype, score_dtype)
        ids = [0, 199, 200, 449, 7]
        got = t.reconstruct_batch(ids)
        assert got.dtype == np.float32 and got.shape == (5, DIM)
        # bf16: the two sides normalize in bf16 and may differ by one ulp
        atol = 1e-6 if dtype == "float32" else 2.0**-8 * np.abs(got).max()
        np.testing.assert_allclose(got, j.reconstruct_batch(ids), atol=atol, rtol=0)


def test_empty_index_returns_missing_slots():
    t = DenseIndex(DIM, CAP, device="cpu")
    D, I = t.search(np.ones((3, DIM), np.float32), 4)
    assert (I == -1).all() and np.isneginf(D).all()


def test_capacity_and_bounds():
    t = DenseIndex(DIM, 10, device="cpu")
    t.add(np.ones((10, DIM), np.float32))
    with pytest.raises(ValueError):
        t.add(np.ones((1, DIM), np.float32))
    with pytest.raises(IndexError):
        t.reconstruct_batch([10])
    with pytest.raises(ValueError):
        t.search(np.ones((2, DIM), np.float32), 3, row_mask=np.ones(7, bool))
    assert mips.launch_count == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("kw", [{"metric": "l2"}, {"quantize": "int8"},
                                {"center": "auto"}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DenseIndex(DIM, CAP, device="cpu", **kw)


@pytest.mark.parametrize("call", ["remove_ids", "range_search", "merge_from",
                                  "snapshot", "save"])
def test_unported_methods_raise(call):
    t = DenseIndex(DIM, CAP, device="cpu")
    args = {"remove_ids": ([0],), "range_search": (np.ones((1, DIM)), 0.5),
            "merge_from": (t,), "snapshot": (), "save": ("x",)}[call]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(t, call)(*args)
