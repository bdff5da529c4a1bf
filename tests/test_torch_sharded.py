"""Parity of the port's sharded dense serving (``parallel/mesh.py``,
``parallel/collectives.py``, ``index/sharded.py``) with the JAX package on
the same rows: the port's mesh is 8 CPU shards, JAX's the 8 virtual CPU
devices of ``tests/conftest.py``.

Tolerances, as the unsharded parity tests (``test_torch_index.py``,
``test_torch_int8.py``) hold them: float32 scores to 1e-5 of the per-query
scale; bfloat16 storage to two bf16 ulps; int8x8 to 1e-5 (the JAX side
multiplies by the query scale before its selection, the port after). Ids
are equal wherever a slot's JAX value is more than the tolerance from its
neighbours; elsewhere the port's ids reach value-recall 1.0 against the
rows it stores (int8x8: and the query codes it ranks with). Ties across shards resolve to the lower shard, so rows
duplicated on three shards give JAX's ids exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.index import sharded as jsh
from sessionsimilaritysearch_tpu.index.sharded import ShardedDenseIndex as JaxSharded
from sessionsimilaritysearch_tpu.parallel import collectives as jcol
from sessionsimilaritysearch_tpu.parallel import create_mesh as jax_mesh
from sessionsimilaritysearch_tpu_torch.index import sharded as tsh
from sessionsimilaritysearch_tpu_torch.index.sharded import ShardedDenseIndex
from sessionsimilaritysearch_tpu_torch.ops import mips, mips_int8
from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize, value_recall_at_k
from sessionsimilaritysearch_tpu_torch.parallel import collectives as tcol
from sessionsimilaritysearch_tpu_torch.parallel import create_mesh

DIM, CAP, CHUNK = 24, 1024, 32  # 128 rows per shard: four chunks each
BATCHES = (256, 192, 64)        # 512 rows, streamed in whole stripes
BF16_TOL = 2 * 2.0**-8
TOL = 1e-5
CONFIGS = {  # name -> (JAX kwargs, port kwargs, tolerance)
    "f32": ({}, {}, TOL),
    "bf16": ({"dtype": jnp.bfloat16}, {"dtype": torch.bfloat16}, BF16_TOL),
    "int8": ({"quantize": "int8"}, {"quantize": "int8"}, BF16_TOL),
    "int8x8": ({"quantize": "int8x8"}, {"quantize": "int8x8"}, TOL),
}


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counts = (mips.launch_count, mips_int8.launch_count)
    yield
    assert (mips.launch_count, mips_int8.launch_count) == counts


def _meshes(n=8):
    return (jax_mesh(shape=(n,), devices=jax.devices()[:n]),
            create_mesh(devices=[torch.device("cpu")] * n))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((sum(BATCHES), DIM)).astype(np.float32)
    queries = (rows[:12] + 0.5 * rng.standard_normal((12, DIM))).astype(np.float32)
    return rows, queries


def _pair(name, rows, n=8, metric="cos", sides="jax+port"):
    """The JAX and the port index of ``name`` on ``n`` shards, streamed the
    same rows; a side left out of ``sides`` is None."""
    jkw, tkw, tol = CONFIGS[name]
    jm, tm = _meshes(n)
    j = (JaxSharded(DIM, CAP, jm, metric=metric, chunk_size=CHUNK, **jkw)
         if "jax" in sides else None)
    t = (ShardedDenseIndex(DIM, CAP, tm, metric=metric, chunk_size=CHUNK, **tkw)
         if "port" in sides else None)
    start = 0
    for m in BATCHES:
        for idx in (j, t):
            if idx is not None:
                idx.add(rows[start: start + m])
        start += m
    return j, t, tol


@pytest.fixture(scope="module")
def built(data):
    """One JAX and one port index per configuration, built once (the tests
    that use it do not change them)."""
    return {name: _pair(name, data[0]) for name in CONFIGS}


def _distinct(D, tol):
    """Slots whose value is more than ``tol`` from both neighbours."""
    gap = np.abs(np.diff(D, axis=1)) > tol
    left = np.concatenate([np.ones((D.shape[0], 1), bool), gap], axis=1)
    right = np.concatenate([gap, np.ones((D.shape[0], 1), bool)], axis=1)
    return left & right


def _check(j_res, t_res, tol, t=None, queries=None, mask=None):
    """The port's (D, I) against JAX's: the same missing slots, values to
    ``tol`` of the per-query scale, ids equal where the values are
    distinct, and value-recall 1.0 against the port's stored rows."""
    (Dj, Ij), (Dt, It) = (np.asarray(x) for x in j_res), t_res
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    missing = It < 0
    np.testing.assert_array_equal(missing, Ij < 0)
    assert np.isneginf(Dt[missing]).all()
    if (~missing).any():
        scale = np.abs(Dj[~missing]).max()
        np.testing.assert_allclose(Dt[~missing], Dj[~missing], atol=tol * scale, rtol=0)
        sure = _distinct(np.where(missing, -1e30, Dj), tol * scale) & ~missing
        np.testing.assert_array_equal(It[sure], Ij[sure])
    if t is not None:
        live = np.flatnonzero(t._host_ids.reshape(-1) >= 0)
        gids = np.sort(t._host_ids.reshape(-1)[live])
        if mask is not None:
            gids = gids[mask[gids]]
        stored = t.reconstruct_batch(gids)
        pos = np.searchsorted(gids, It)  # ids -> rows of ``stored``
        kk = int((~missing).sum(axis=1).min())
        q = queries / np.linalg.norm(queries, axis=1, keepdims=True) \
            if t.metric == "cos" else queries
        if t.quantize == "int8x8":  # ranked against the query codes x scales
            q8, qs = mips_int8.quantize_rows_int8(
                l2_normalize(torch.from_numpy(queries).bfloat16()).bfloat16())
            q = (q8.double() * qs.double()[:, None]).numpy()
        if kk:
            assert value_recall_at_k(pos[:, :kk], q, stored, kk, rel_tol=tol) == 1.0


# --- the mesh and the collectives


def test_create_mesh_and_shard_corpus_match_jax(data):
    rows, _ = data
    jm, tm = _meshes()
    assert dict(tm.shape) == dict(jm.shape) == {"data": 8}
    assert tm.local_shards() == list(range(8)) and not tm.distributed
    shards = tcol.shard_corpus(rows, tm)
    jsc = jcol.shard_corpus(jnp.asarray(rows), jm)
    jparts = sorted(jsc.addressable_shards, key=lambda s: s.index[0].start)
    assert len(shards) == len(jparts) == 8
    for got, want in zip(shards, jparts):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.data))
    m2 = create_mesh(shape=(4, 2), axis_names=("data", "model"),
                     devices=[torch.device("cpu")] * 8)
    assert dict(m2.shape) == {"data": 4, "model": 2} and len(m2.shard_devices()) == 4
    with pytest.raises(ValueError):
        create_mesh(shape=(9,), devices=[torch.device("cpu")] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            create_mesh()  # one shard per card: none here, and no CPU fallback


@pytest.mark.parametrize("case", ["plain", "valid_and_mask", "int8x8", "k_beyond_rows"])
def test_sharded_topk_matches_jax(data, case):
    rows, queries = data
    jm, tm = _meshes()
    k, kw, jkw = 7, {}, {}
    q, c = queries, rows
    if case == "valid_and_mask":
        valid = np.array([64, 0, 17, 64, 1, 40, 64, 33])
        mask = np.random.default_rng(3).random(512) < 0.6
        kw = dict(valid_per_shard=valid, row_mask=[torch.from_numpy(m) for m in
                                                   mask.reshape(8, 64)])
        jkw = dict(valid_per_shard=jax.device_put(jnp.asarray(valid, jnp.int32)),
                   row_mask=jnp.asarray(mask))
    elif case == "int8x8":
        from sessionsimilaritysearch_tpu.index.dense import _quantize_rows_int8

        cq, cs = (np.array(x) for x in _quantize_rows_int8(jnp.asarray(rows)))
        qq, qs = (np.array(x) for x in _quantize_rows_int8(jnp.asarray(queries)))
        q, c = qq, cq
        kw = dict(corpus_scales=tcol.shard_corpus(cs, tm), query_scales=torch.from_numpy(qs))
        jkw = dict(corpus_scales=jcol.shard_corpus(jnp.asarray(cs)[:, None], jm)[:, 0],
                   query_scales=jnp.asarray(qs))
    elif case == "k_beyond_rows":
        c, k = rows[:64], 12  # 8 rows per shard
    got = tcol.sharded_topk(torch.from_numpy(q), tcol.shard_corpus(c, tm), k, tm,
                            chunk_size=CHUNK, **kw)
    want = jcol.sharded_topk(jnp.asarray(q), jcol.shard_corpus(jnp.asarray(c), jm), k, jm,
                             chunk_size=CHUNK, **jkw)
    _check(want, (got[0].numpy(), got[1].numpy()), TOL)


def test_tie_across_shards_resolves_to_jax_id():
    # shards 3 and 6 repeat shard 0's rows at the same slots: every score of
    # shard 0 appears three times, bit for bit, and both packages rank the
    # copies by shard
    rng = np.random.default_rng(7)
    rows = rng.standard_normal((8, 16, DIM)).astype(np.float32)
    rows[3] = rows[0]
    rows[6] = rows[0]
    q = (rows[0, :5] + 0.1 * rng.standard_normal((5, DIM))).astype(np.float32)
    rows = rows.reshape(-1, DIM)
    jm, tm = _meshes()
    j = JaxSharded(DIM, 128, jm, metric="ip", chunk_size=16)
    t = ShardedDenseIndex(DIM, 128, tm, metric="ip", chunk_size=16)
    j.add(rows)
    t.add(rows)
    Dj, Ij = j.search(q, 12)
    Dt, It = t.search(q, 12)
    np.testing.assert_array_equal(It, Ij)
    np.testing.assert_allclose(Dt, Dj, atol=TOL * np.abs(Dj).max(), rtol=0)
    # each query's nearest row, three times: shard 0's copy first
    np.testing.assert_array_equal(It[:, :3] // 16, [[0, 3, 6]] * 5)


# --- the host plans, array for array


def test_plan_sharded_removal_and_positions_match_jax():
    rng = np.random.default_rng(2)
    ndev, rows = 4, 50
    host = np.full((ndev, rows), -1, np.int64)
    fills = np.array([50, 31, 0, 12])
    ids = rng.permutation(200)
    cursor = 0
    for s in range(ndev):
        host[s, : fills[s]] = ids[cursor: cursor + fills[s]]
        cursor += fills[s]
    present = host[host >= 0]
    gone = rng.choice(present, 20, replace=False)
    for a, b in zip(tsh.plan_sharded_removal(host, fills, gone),
                    jsh.plan_sharded_removal(host, fills, gone)):
        np.testing.assert_array_equal(a, b)
    look = rng.choice(present, 30, replace=False)
    np.testing.assert_array_equal(tsh.global_id_positions(host, fills, look),
                                  jsh.global_id_positions(host, fills, look))
    with pytest.raises(ValueError, match="not present"):
        tsh.plan_sharded_removal(host, fills, [present.max() + 1])
    with pytest.raises(KeyError):
        tsh.global_id_positions(host, fills, [present.max() + 1])


# --- ShardedDenseIndex


@pytest.mark.parametrize("name", list(CONFIGS))
def test_streamed_search_matches_jax(built, data, name):
    j, t, tol = built[name]
    _, queries = data
    assert t.ntotal == j.ntotal == 512 and t._fill.tolist() == j._fill.tolist()
    np.testing.assert_array_equal(t._host_ids, j._host_ids)
    _check(j.search(queries, 10), t.search(queries, 10), tol, t, queries)
    Dd, Id = t.search(queries, 10, out="device")
    assert isinstance(Dd, torch.Tensor) and Id.dtype == torch.int64


@pytest.mark.parametrize("name", ["f32", "bf16", "int8x8"])
def test_gid_row_mask_and_range_search_match_jax(built, data, name):
    j, t, tol = built[name]
    _, queries = data
    mask = np.random.default_rng(1).random(t._next_id) < 0.5
    _check(j.search(queries, 10, row_mask=mask), t.search(queries, 10, row_mask=mask),
           tol, t, queries, mask)
    radius = float(np.sort(j.search(queries[:1], 30)[0][0])[-20])
    jl, jd, ji = j.range_search(queries, radius, k0=8)
    tl, td, ti = t.range_search(queries, radius, k0=8)
    scale = np.abs(jd).max()
    for r in range(len(queries)):
        js, ts = slice(jl[r], jl[r + 1]), slice(tl[r], tl[r + 1])
        # rows within the tolerance of the radius may fall either side
        sure_j = set(ji[js][np.abs(jd[js] - radius) > tol * scale].tolist())
        sure_t = set(ti[ts][np.abs(td[ts] - radius) > tol * scale].tolist())
        assert sure_j <= set(ti[ts].tolist()) and sure_t <= set(ji[js].tolist())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reconstruct_matches_jax(built, name):
    j, t, _ = built[name]
    ids = [0, 255, 256, 511, 77]
    got = t.reconstruct_batch(ids)
    assert got.dtype == np.float32 and got.shape == (5, DIM)
    # bf16: the two sides normalize in bf16 and may differ by one ulp
    atol = 2.0**-8 * np.abs(got).max() if name == "bf16" else 1e-6
    np.testing.assert_allclose(got, j.reconstruct_batch(ids), atol=atol, rtol=0)
    np.testing.assert_array_equal(t.reconstruct(77), got[4])
    with pytest.raises(KeyError):
        t.reconstruct_batch([512])


@pytest.mark.parametrize("name", ["f32", "int8x8"])
def test_remove_ids_keeps_ids_stable_and_matches_jax(data, name):
    rows, queries = data
    j, t, tol = _pair(name, rows)
    rng = np.random.default_rng(4)
    for gone in (rng.choice(512, 60, replace=False), np.arange(0, 64)):
        gone = np.setdiff1d(gone, np.flatnonzero(~np.isin(np.arange(512),
                                                          t._host_ids[t._host_ids >= 0])))
        assert t.remove_ids(gone) == j.remove_ids(gone) == gone.size
        np.testing.assert_array_equal(t._fill, j._fill)
        np.testing.assert_array_equal(t._host_ids, j._host_ids)
        Dt, It = t.search(queries, 10)
        assert not np.isin(It, gone).any()
        _check(j.search(queries, 10), (Dt, It), tol, t, queries)
    # survivors keep their ids: a stored row finds itself under its old id
    keep = np.array([100, 300, 511])
    np.testing.assert_array_equal(t.search(rows[keep], 1)[1][:, 0], keep)
    with pytest.raises(ValueError, match="not present"):
        t.remove_ids([0])
    # freed capacity refills with fresh ids
    t.add(rows[:64])
    j.add(rows[:64])
    np.testing.assert_array_equal(t._host_ids, j._host_ids)
    _check(j.search(queries, 10), t.search(queries, 10), tol, t, queries)


def test_a_shard_emptied_by_removals(data):
    rows, queries = data
    j, t, tol = _pair("f32", rows)
    shard0 = t._host_ids[0, : t._fill[0]].copy()
    t.remove_ids(shard0)
    j.remove_ids(shard0)
    assert t._fill[0] == 0
    Dt, It = t.search(queries, 10)
    _check(j.search(queries, 10), (Dt, It), tol, t, queries)
    assert not np.isin(It, shard0).any()
    # an index with nothing in it: missing slots, no launch
    empty = ShardedDenseIndex(DIM, CAP, _meshes()[1])
    D, I = empty.search(queries, 4)
    assert (I == -1).all() and np.isneginf(D).all()


def test_add_refuses_ragged_stripes_and_overflow(data):
    rows, _ = data
    t = ShardedDenseIndex(DIM, 64, _meshes()[1])
    with pytest.raises(ValueError, match="divisible"):
        t.add(rows[:5])
    t.add(rows[:64])
    with pytest.raises(ValueError, match="full"):
        t.add(rows[:8])
    with pytest.raises(ValueError, match="divide"):
        ShardedDenseIndex(DIM, 60, _meshes()[1])
    with pytest.raises(ValueError):
        ShardedDenseIndex(DIM, 64, _meshes()[1], metric="l2")


def test_state_dict_round_trip(built, data):
    _, t, tol = built["int8x8"]
    _, queries = data
    fresh = ShardedDenseIndex(DIM, CAP, t.mesh, chunk_size=CHUNK, quantize="int8x8")
    fresh.load_state(t.state_dict())
    np.testing.assert_array_equal(fresh.search(queries, 10)[1], t.search(queries, 10)[1])
    assert set(t.state_dict()) == {"buf", "ids", "scales", "size", "fills", "next_id",
                                   "host_ids"}


@pytest.mark.parametrize("name", ["f32", "bf16", "int8x8"])
@pytest.mark.parametrize("direction", ["jax8_to_port4", "port4_to_jax8", "port8_to_port8"])
def test_snapshots_across_packages_and_shard_counts(data, name, direction, tmp_path):
    rows, queries = data
    path = str(tmp_path / "s.npz")
    gone = np.arange(3, 512, 7)[:64]  # 64 rows: the rest divide over 4 and 8 shards
    if direction == "jax8_to_port4":
        j, _, tol = _pair(name, rows, sides="jax")
        j.remove_ids(gone)
        j.save(path)
        back = ShardedDenseIndex.load(path, _meshes(4)[1])
        assert back.ndev == 4 and back.chunk_size == CHUNK
        _check(j.search(queries, 10), back.search(queries, 10), tol, back, queries)
    elif direction == "port4_to_jax8":
        _, t, tol = _pair(name, rows, n=4, sides="port")
        t.remove_ids(gone)
        t.save(path)
        back = JaxSharded.load(path, _meshes(8)[0])
        assert back.ndev == 8 and back.size == 448
        _check(back.search(queries, 10), t.search(queries, 10), tol, t, queries)
    else:
        _, t, tol = _pair(name, rows, sides="port")
        t.remove_ids(gone)
        t.save(path)
        back = ShardedDenseIndex.load(path, t.mesh)
        np.testing.assert_array_equal(back._host_ids, t._host_ids)
        np.testing.assert_array_equal(back.search(queries, 10)[1], t.search(queries, 10)[1])
        assert back._next_id == 512 and back.quantize == t.quantize
