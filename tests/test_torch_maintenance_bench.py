"""The port's maintenance bench
(``sessionsimilaritysearch_tpu_torch.examples.maintenance_bench``): its
``--tiny`` run writes every key of JAX's report (``platform`` ->
``device``); on shared seeded rows (4,096 x 128, queries and radii as the
script draws them) the port's ``DenseIndex.range_search``, its depths
counted by the script's own swap, scans JAX ``DenseIndex``'s depth sequence
at each radius, and its hits are a numpy f64 oracle's up to rows within
1e-5 of the radius; ``merge_from`` and ``remove_ids`` return JAX's row
counts; and no removed id comes back from a one-shard
``ShardedDenseIndex``. JAX's 2^20-row script is not run."""

import json

import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.index.dense import DenseIndex as JaxDenseIndex
from sessionsimilaritysearch_tpu_torch.examples import maintenance_bench
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
from sessionsimilaritysearch_tpu_torch.index.sharded import ShardedDenseIndex
from sessionsimilaritysearch_tpu_torch.parallel import create_mesh

N, D, RQ, MERGE_N, REMOVE_N = 4096, 128, 16, 512, 256
RADII = [name for name, _ in maintenance_bench.radii(D)]
JAX_KEYS = ["N", "D", "K", "query_batch", "capacity", "search_unmasked",
            "search_row_mask_50pct", "range_easy", "range_moderate", "range_hostile",
            "merge_from", "search_after_merge", "remove_ids", "search_after_remove",
            "sharded_search_before_remove", "sharded_remove_ids",
            "sharded_search_after_remove", "platform"]
ORACLE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small tensors through many ops: one intra-op thread per suite worker
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _unit(rng, n):
    x = rng.standard_normal((n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(0)
    return {"corpus": _unit(rng, N), "queries": _unit(rng, RQ), "merge": _unit(rng, MERGE_N),
            "victims": np.random.default_rng(1).choice(N, size=2 * REMOVE_N, replace=False)}


def test_tiny_run_writes_jax_keys(tmp_path):
    out = tmp_path / "bench.json"
    rec = maintenance_bench.main(["--device", "cpu", "--tiny", "--out", str(out), "--iters", "2"])
    want = ["device" if k == "platform" else k for k in JAX_KEYS]
    assert list(rec) == want
    assert list(json.loads(out.read_text())) == want
    assert rec["device"] == "cpu" and rec["capacity"] == rec["N"] + 2 * (1 << 12)
    assert rec["merge_from"]["rows"] == 1 << 12
    assert rec["remove_ids"]["rows"] == rec["sharded_remove_ids"]["rows"] == 1 << 12
    assert rec["range_hostile"]["depths"][-1] == rec["N"]  # driven to the corpus size
    for name in RADII:
        depths = rec[f"range_{name}"]["depths"]
        assert depths[0] == 128 and all(b == 2 * a or b == rec["N"]
                                        for a, b in zip(depths, depths[1:]))


@pytest.fixture(scope="module")
def ranges(rows):
    """Each radius's depth sequence in JAX (the script's own swap of the
    instance's search) and in the port (``counted_range_search``)."""
    jidx = JaxDenseIndex(dim=D, capacity=N + 2 * MERGE_N, metric="cos")
    jidx.add(rows["corpus"])
    tidx = DenseIndex(D, N + 2 * MERGE_N, metric="cos", device="cpu")
    tidx.add(rows["corpus"])
    out = {}
    for name, radius in maintenance_bench.radii(D):
        depths = []
        orig = jidx.search

        def counting_search(q, k, _o=orig, _d=depths, **kw):
            _d.append(k)
            return _o(q, k, **kw)

        jidx.search = counting_search
        try:
            jidx.range_search(rows["queries"], radius)
        finally:
            jidx.search = orig
        (lims, Dr, Ir), tdepths, _ = maintenance_bench.counted_range_search(
            tidx, rows["queries"], radius)
        out[name] = {"radius": radius, "jax": depths, "port": tdepths, "lims": lims, "D": Dr,
                     "I": Ir}
    assert "search" not in vars(tidx)  # the swap is undone
    return {"ranges": out, "jax": jidx, "port": tidx}


@pytest.mark.parametrize("name", RADII)
def test_range_depths_equal_jax(ranges, name):
    r = ranges["ranges"][name]
    assert r["port"] == r["jax"], (name, r["port"], r["jax"])


@pytest.mark.parametrize("name", RADII)
def test_range_hits_f64_oracle(ranges, rows, name):
    r = ranges["ranges"][name]
    idx = ranges["port"]
    stored = idx._buf[: idx.ntotal].double().numpy()
    q = rows["queries"].astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = q @ stored.T
    radius, lims = r["radius"], r["lims"]
    for i in range(RQ):
        got = set(r["I"][lims[i]: lims[i + 1]].tolist())
        want = set(np.nonzero(s[i] >= radius)[0].tolist())
        for j in got ^ want:
            assert abs(s[i, j] - radius) <= ORACLE_TOL, (name, i, j, s[i, j], radius)
        hits = r["D"][lims[i]: lims[i + 1]]
        assert (np.diff(hits) <= 0).all()  # best first
    if name == "hostile":
        assert np.diff(lims).mean() > N / 4


def test_merge_and_remove_counts_equal_jax(ranges, rows):
    jidx, tidx = ranges["jax"], ranges["port"]
    jsrc = JaxDenseIndex(dim=D, capacity=MERGE_N, metric="cos")
    jsrc.add(rows["merge"])
    tsrc = DenseIndex(D, MERGE_N, metric="cos", device="cpu")
    tsrc.add(rows["merge"])
    v = rows["victims"]
    jcounts = [jidx.merge_from(jsrc), jidx.merge_from(jsrc),
               jidx.remove_ids(v[:REMOVE_N]), jidx.remove_ids(v[REMOVE_N:])]
    tcounts = [tidx.merge_from(tsrc), tidx.merge_from(tsrc),
               tidx.remove_ids(v[:REMOVE_N]), tidx.remove_ids(v[REMOVE_N:])]
    assert tcounts == jcounts == [MERGE_N, MERGE_N, REMOVE_N, REMOVE_N]
    assert tidx.ntotal == jidx.ntotal == N + 2 * MERGE_N - 2 * REMOVE_N


def test_sharded_one_shard_never_returns_removed_ids(rows):
    sidx = ShardedDenseIndex(D, N, create_mesh(devices=[torch.device("cpu")]), chunk_size=N)
    sidx.add(rows["corpus"])
    v = rows["victims"]
    assert [sidx.remove_ids(v[:REMOVE_N]), sidx.remove_ids(v[REMOVE_N:])] == \
        [REMOVE_N, REMOVE_N]
    # the removed rows' own content as queries: their ids must not return,
    # and every other id is stable (the row's own content finds it first)
    _, I = sidx.search(rows["corpus"][v[:64]], 20)
    assert not set(I.ravel().tolist()) & set(v.tolist())
    keep = np.setdiff1d(np.arange(N), v)[:64]
    _, I = sidx.search(rows["corpus"][keep], 5)
    np.testing.assert_array_equal(I[:, 0], keep)
