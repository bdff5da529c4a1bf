"""The sharded serving engine end to end: the port's
``SessionSearchEngine(mesh=...)`` against the JAX engine on a mesh, both
around the flagship GraphLevelEncoder (tiny config) with the same weights
(Flax init, converted by ``weights.py``; the ``parts`` fixture of
``test_torch_slice.py``), fed the same sessions, four of them twice. The
port's mesh is 4 CPU shards, JAX's 4 of its virtual CPU devices.

Tolerances, as ``test_torch_slice.py``: cosine scores 1e-5; ids equal
wherever a slot's JAX score is more than 1e-5 from its neighbours (the
duplicated sessions tie). Removal leaves tombstones in both packages, so
ids, the ``_removed`` sets and the stored sessions are compared exactly."""

import jax
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.engine import SessionSearchEngine as JaxEngine
from sessionsimilaritysearch_tpu.ops.projection import fit_itq
from sessionsimilaritysearch_tpu.parallel import create_mesh as jax_mesh
from sessionsimilaritysearch_tpu_torch.engine import SessionSearchEngine
from sessionsimilaritysearch_tpu_torch.index.sharded import ShardedDenseIndex
from sessionsimilaritysearch_tpu_torch.index.twostage import ShardedTwoStageIndex
from sessionsimilaritysearch_tpu_torch.ops import mips, mips_int8, packed
from sessionsimilaritysearch_tpu_torch.parallel import create_mesh
from test_torch_slice import _port_side, parts  # noqa: F401  (fixture)

TOL = 1e-5
SHARDS = 4


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    counts = (mips.launch_count, mips_int8.launch_count, packed.launch_count)
    yield
    assert (mips.launch_count, mips_int8.launch_count, packed.launch_count) == counts


def _meshes():
    return (jax_mesh(shape=(SHARDS,), devices=jax.devices()[:SHARDS]),
            create_mesh(devices=[torch.device("cpu")] * SHARDS))


@pytest.fixture(scope="module")
def sessions(parts):
    data = parts[2]
    return list(data) + list(data[:4])  # 44: the first four twice


@pytest.fixture(scope="module")
def engine_proj(parts):
    cfg = parts[0]
    emb = JaxEngine(cfg, parts[1], parts[3], dim=cfg.session_emb_dim, capacity=64,
                    batch_size=8).embed(parts[2])
    return fit_itq(emb / np.linalg.norm(emb, axis=1, keepdims=True), 32)


def _pair(parts, sides="jax+port", **opts):
    """The JAX and the port mesh engine; a side left out of ``sides`` is None."""
    cfg, tok, _, encode_fn, tenc = parts
    jm, tm = _meshes()
    kw = dict(dim=cfg.session_emb_dim, capacity=64, batch_size=8, **opts)
    j = JaxEngine(cfg, tok, encode_fn, mesh=jm, **kw) if "jax" in sides else None
    t = SessionSearchEngine(*_port_side(cfg), tenc, mesh=tm, **kw) if "port" in sides else None
    return j, t


def _same(j_res, t_res):
    (Dj, Ij), (Dt, It) = (np.asarray(x) for x in j_res), (np.asarray(x) for x in t_res)
    missing = It < 0
    np.testing.assert_array_equal(missing, Ij < 0)
    np.testing.assert_allclose(Dt[~missing], Dj[~missing], atol=TOL, rtol=0)
    gap = np.abs(np.diff(np.where(missing, -1e30, Dj), axis=1)) > TOL
    ones = np.ones((Dj.shape[0], 1), bool)
    sure = np.concatenate([ones, gap], 1) & np.concatenate([gap, ones], 1) & ~missing
    np.testing.assert_array_equal(It[sure], Ij[sure])


def _ingest(engines, sessions, stamps=True):
    for eng in engines:
        eng.add_sessions(sessions[:30], stamp=1.0 if stamps else None)  # 28 in, 2 pending
        assert eng.stats()["pending"] == 2 and eng.index.ntotal == 28
        eng.add_sessions(sessions[30:], stamp=2.0 if stamps else None)
        assert eng.stats()["pending"] == 0 and eng.index.ntotal == 44


def test_mesh_engine_builds_the_sharded_indexes(parts, engine_proj):
    _, t = _pair(parts)
    assert isinstance(t.index, ShardedDenseIndex) and t.device == torch.device("cpu")
    assert t.index.ndev == SHARDS and t.index.capacity == 64
    _, t = _pair(parts, prefilter="itq", projector=engine_proj, stage1="packed", pool=16)
    assert isinstance(t.index, ShardedTwoStageIndex)
    assert t.index.capacity == SHARDS * 2048  # whole pack blocks per shard
    with pytest.raises(ValueError, match="center"):
        _pair(parts, center="auto")


@pytest.mark.parametrize("opts", [
    {}, {"prefilter": "itq", "stage1": "matmul", "pool": 16},
    {"prefilter": "itq", "stage1": "packed", "pool": 16},
], ids=["dense", "itq-matmul", "itq-packed"])
def test_search_remove_expire_match_jax(parts, sessions, engine_proj, opts):
    if "prefilter" in opts:
        opts = dict(opts, projector=engine_proj)
    j, t = _pair(parts, **opts)
    _ingest((j, t), sessions)
    q = sessions[:12]
    _same(j.search(q, k=8), t.search(q, k=8))
    # removal by ids, by content (both copies of session 1 go) and by age
    assert t.remove_sessions(ids=[5, 17, 33]) == j.remove_sessions(ids=[5, 17, 33]) == 3
    assert t.remove_sessions(data=[sessions[1]]) == j.remove_sessions(data=[sessions[1]]) == 2
    assert t._removed == j._removed == {5, 17, 33, 1, 41}
    # the first add's 30 sessions (its 2 pending ones too) less the 3 removed
    assert t.expire(before=1.5) == j.expire(before=1.5) == 27
    assert t._removed == j._removed and t.index.ntotal == j.index.ntotal == 12
    assert len(t.sessions) == 44  # tombstones keep their metadata rows
    D, I = t.search(q, k=8)
    _same(j.search(q, k=8), (D, I))
    assert not np.isin(I, sorted(t._removed)).any()
    # the survivors kept their ids: sessions 30.. still find themselves
    np.testing.assert_array_equal(t.search(sessions[30:33], k=1)[1][:, 0], np.arange(30, 33))
    if not opts:  # dedup and a where= filter, keyed by global id
        _same(j.search(q, k=5, dedup=True), t.search(q, k=5, dedup=True))
        keep = lambda s: len(s) % 2 == 0  # noqa: E731
        _same(j.search(q, k=5, where=keep), t.search(q, k=5, where=keep))


def test_hybrid_and_range_search_match_jax(parts, sessions):
    j, t = _pair(parts)
    _ingest((j, t), sessions, stamps=False)
    for eng in (j, t):
        eng.remove_sessions(ids=[2, 9])
    q = sessions[:10]
    for kind in ("overlap", "stan"):
        for fusion in ("score", "rrf"):
            kw = dict(k=6, hybrid_alpha=0.5, hybrid_kind=kind, hybrid_fusion=fusion)
            _same(j.search(q, **kw), t.search(q, **kw))
    (jl, jd, ji), (tl, td, ti) = j.range_search(q, 0.9, k0=8), t.range_search(q, 0.9, k0=8)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(td, jd, atol=TOL, rtol=0)
    for r in range(len(q)):
        assert set(ti[tl[r]: tl[r + 1]]) == set(ji[jl[r]: jl[r + 1]])


@pytest.mark.parametrize("opts", [{}, {"prefilter": "itq", "stage1": "packed", "pool": 16}],
                         ids=["dense", "itq-packed"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_save_restore_across_packages(parts, sessions, engine_proj, opts, direction,
                                      tmp_path):
    if "prefilter" in opts:
        opts = dict(opts, projector=engine_proj)
    src, dst = ("port", "jax") if direction == "port_to_jax" else ("jax", "port")
    ref = [e for e in _pair(parts, sides=src, **opts) if e is not None][0]
    back = [e for e in _pair(parts, sides=dst, **opts) if e is not None][0]
    ref.add_sessions(sessions[:30], stamp=1.0)  # 2 stay pending
    # 24 left: a sharded two-stage snapshot loads whole stripes only
    ref.remove_sessions(ids=[3, 7, 11, 20])
    prefix = str(tmp_path / "eng")
    if direction == "port_to_jax":
        ref.save_async(prefix).join()
    else:
        ref.save(prefix)
        back.add_sessions(sessions[30:34])  # the live corpus goes
    back.restore(prefix)
    assert back.index.ntotal == 24 and len(back.sessions) == 28
    assert back._removed == ref._removed == {3, 7, 11, 20}
    assert [tuple(map(tuple, s)) for s in back.sessions] == [
        tuple(map(tuple, s)) for s in ref.sessions]
    assert back.stats()["pending"] == 2
    _same(ref.search(sessions[:10], k=5), back.search(sessions[:10], k=5))
    assert back.expire(before=2.0) == 24  # the stamps came along


def test_emptied_two_stage_engine_keeps_its_ids_through_a_snapshot(
        parts, sessions, engine_proj, tmp_path):
    # every session removed, saved and restored: the next add gets fresh ids,
    # never the metadata rows of the removed sessions
    opts = dict(prefilter="itq", projector=engine_proj, stage1="packed", pool=16)
    _, t = _pair(parts, sides="port", **opts)
    t.add_sessions(sessions[:28])
    assert t.remove_sessions(ids=list(range(28))) == 28 and t.index.ntotal == 0
    prefix = str(tmp_path / "empty")
    t.save_async(prefix).join()
    _, back = _pair(parts, sides="port", **opts)
    back.restore(prefix)
    assert back._removed == set(range(28)) and back.index._next_id == 28
    back.add_sessions(sessions[28:32])
    np.testing.assert_array_equal(back.search(sessions[28:32], k=1)[1][:, 0],
                                  np.arange(28, 32))
