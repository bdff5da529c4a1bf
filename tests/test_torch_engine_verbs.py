"""Parity of the port's SessionSearchEngine serving verbs with the JAX
engine, both around the flagship GraphLevelEncoder (tiny config) with the
same weights (tests/test_torch_slice.py's ``parts``), fed the same
sessions: removal by id and by content, TTL expiry over stamped rows, async
ingest, snapshots (save, save_async, restore, each package restoring the
other's), hybrid fusion (overlap/stan x score/rrf), range search with a
filter, centered serving, and what stays unported.

Tolerances: cosine scores 1e-5 (float32 sums in another order through the
encoder and the scan); fused hybrid scores 1e-5 as well (a linear
combination of a cosine and an exact set cosine); ids must match the JAX
engine's or reach value-recall 1.0 at rel_tol 1e-5 against the rows the
port stores."""

import sys

import numpy as np
import pytest

from sessionsimilaritysearch_tpu.data.synthetic import SyntheticSessionGenerator
from sessionsimilaritysearch_tpu.engine import SessionSearchEngine as JaxEngine
from sessionsimilaritysearch_tpu.engine import _item_set, _overlap_cos
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config
from sessionsimilaritysearch_tpu_torch.data.synthetic import (
    SyntheticSessionGenerator as PortGenerator,
)
from sessionsimilaritysearch_tpu_torch.engine import SessionSearchEngine, _session_key
from sessionsimilaritysearch_tpu_torch.index import dense as port_dense
from sessionsimilaritysearch_tpu_torch.ops.projection import fit_itq
from sessionsimilaritysearch_tpu_torch.ops.topk import value_recall_at_k
from test_torch_slice import _port_side, parts  # noqa: F401  (fixture)

TOL = 1e-5


def _data(n, seed=5, gen=PortGenerator):
    """Seeded sessions of the tiny config's catalog, the port's own by
    default; the JAX package's generator gives equal sessions of its own
    Action class."""
    return gen(asin_num=tiny_test_config().asin_num, seed=seed).dataset(n)


def _pair(parts, capacity=64, **opts):
    cfg, tok, _, encode_fn, tenc = parts
    kw = dict(dim=cfg.session_emb_dim, capacity=capacity, batch_size=8, **opts)
    return (JaxEngine(cfg, tok, encode_fn, **kw),
            SessionSearchEngine(*_port_side(cfg), tenc, device="cpu", **kw))


def _port(parts, capacity=64, **opts):
    cfg, _, _, _, tenc = parts
    return SessionSearchEngine(*_port_side(cfg), tenc, device="cpu", dim=cfg.session_emb_dim,
                               capacity=capacity, batch_size=8, **opts)


def _same_search(j_res, t_res, t, queries_emb=None, tol=TOL):
    (Dj, Ij), (Dt, It) = j_res, t_res
    np.testing.assert_array_equal(It < 0, Ij < 0)
    np.testing.assert_allclose(Dt[It >= 0], Dj[Ij >= 0], atol=tol, rtol=0)
    if queries_emb is not None:
        stored = t.reconstruct(np.arange(t.index.ntotal))
        q = queries_emb / np.linalg.norm(queries_emb, axis=1, keepdims=True)
        assert value_recall_at_k(It, q, stored, It.shape[1], rel_tol=tol) == 1.0


class TestRemoval:
    def test_remove_by_ids(self, parts):
        j, t = _pair(parts)
        data = _data(20)
        j.add_sessions(data)
        t.add_sessions(data)
        assert t.remove_sessions(ids=[0, 1]) == j.remove_sessions(ids=[0, 1]) == 2
        assert t.index.ntotal == 18 and t.sessions == j.sessions
        Dj, Ij = j.search(data[2:6], k=3)
        Dt, It = t.search(data[2:6], k=3)
        _same_search((Dj, Ij), (Dt, It), t, t.embed(data[2:6]))
        # positional metadata tracked the moves
        assert [t.sessions[i] for i in It[:, 0]] == [d[0] for d in data[2:6]]

    def test_remove_by_content(self, parts):
        j, t = _pair(parts)
        data = _data(12, seed=6)
        j.add_sessions(data)
        t.add_sessions(data)
        assert t.remove_sessions(data=data[:3]) == j.remove_sessions(data=data[:3]) == 3
        assert t.index.ntotal == 9 and t.sessions == j.sessions
        for d in data[:3]:
            assert d[0] not in t.sessions
        # hybrid + dedup run on the compacted metadata
        Dj, Ij = j.search(data[3:6], k=3, dedup=True, hybrid_alpha=0.5)
        Dt, It = t.search(data[3:6], k=3, dedup=True, hybrid_alpha=0.5)
        np.testing.assert_allclose(Dt, Dj, atol=TOL, rtol=0)
        assert [t.sessions[i] for i in It[:, 0]] == [d[0] for d in data[3:6]]
        with pytest.raises(ValueError, match="exactly one"):
            t.remove_sessions()

    def test_ttl_expiry(self, parts):
        j, t = _pair(parts)
        old, new, never = _data(6, 7), _data(4, 8), _data(2, 9)
        for eng in (j, t):
            eng.add_sessions(old, stamp=100.0)
            eng.add_sessions(new, stamp=200.0)
            eng.add_sessions(never)  # unstamped: exempt
        assert t.expire(before=150.0) == j.expire(before=150.0) == 6
        assert t.index.ntotal == 6 and t.sessions == j.sessions
        _, I = t.search(new[:3], k=1)
        assert [t.sessions[i] for i in I[:, 0]] == [d[0] for d in new[:3]]
        assert t.expire(before=150.0) == 0  # idempotent
        assert t.expire(before=1e9) == 4  # unstamped rows survive any cutoff
        assert t.index.ntotal == 2

    def test_incremental_compaction_matches_full_rebuild(self, parts):
        t = _port(parts)
        data = _data(24, 10)
        t.add_sessions(data)
        t.add_sessions(data[:4])  # duplicates: exercise canon classes
        t.remove_sessions(ids=[1, 5, 17, 25])
        t.add_sessions(_data(6, 11))  # append after a shrink
        t.remove_sessions(data=data[7:9])
        n, canon, off, flat, wstan = t._np_meta()
        t._rebuild_meta()
        n2, canon2, off2, flat2, wstan2 = t._np_meta()
        assert n == n2 == len(t.sessions) == t.index.ntotal
        np.testing.assert_array_equal(off, off2)
        np.testing.assert_array_equal(flat, flat2)
        np.testing.assert_allclose(wstan, wstan2)
        remap = {}
        for a, b in zip(canon.tolist(), canon2.tolist()):
            assert remap.setdefault(a, b) == b
        assert len(remap) == len(set(remap.values()))


class TestAsyncIngest:
    def test_async_equals_sync_and_carries_stamp(self, parts):
        j, t = _pair(parts)
        data = _data(24, 12)
        t.add_sessions_async(data[:12], stamp=10.0)
        t.add_sessions_async(data[12:])
        t.flush()
        j.add_sessions(data[:12], stamp=10.0)
        j.add_sessions(data[12:])
        assert t.index.ntotal == 24 and t.stats()["pending"] == 0
        _same_search(j.search(data[:4], k=3), t.search(data[:4], k=3), t,
                     t.embed(data[:4]))
        assert t.expire(before=11.0) == j.expire(before=11.0) == 12
        t.close()
        assert t._ingest_thread is None

    def test_searches_while_ingesting(self, parts):
        # the main thread searches while the ingest thread inserts; every
        # answer is well formed, and the end state equals a synchronous
        # ingest of the same batches
        t = _port(parts)
        data = _data(48, 13)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for b in range(6):
                t.add_sessions_async(data[8 * b: 8 * b + 8], stamp=float(b))
            answered = 0
            while t._ingest_q.unfinished_tasks:
                D, I = t.search(data[:4], k=2)
                n = t.index.ntotal
                assert ((I >= -1) & (I < max(n, 1))).all()
                assert np.isfinite(D[I >= 0]).all()
                answered += 1
            t.flush()
        finally:
            sys.setswitchinterval(old)
        ref = _port(parts)
        for b in range(6):
            ref.add_sessions(data[8 * b: 8 * b + 8], stamp=float(b))
        np.testing.assert_allclose(t.reconstruct(np.arange(48)),
                                   ref.reconstruct(np.arange(48)), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(t._stamps.view(), ref._stamps.view())
        assert t.sessions == ref.sessions
        t.close()

    def test_ingest_errors_surface_on_flush(self, parts):
        t = _port(parts, capacity=8)
        t.add_sessions_async(_data(12, 14))  # past capacity
        with pytest.raises(ValueError, match="full"):
            t.flush()
        t.close()


class TestSnapshots:
    def test_save_restore(self, parts, tmp_path):
        t = _port(parts)
        data = _data(15, 15)
        t.add_sessions(data[:8], stamp=1.0)
        t.add_sessions(data[8:], stamp=2.0)
        D1, I1 = t.search(data[:4], k=3)
        prefix = str(tmp_path / "snap")
        t.save(prefix)
        fresh = _port(parts)
        fresh.restore(prefix)
        assert fresh.index.ntotal == 15 and fresh.sessions == t.sessions
        D2, I2 = fresh.search(data[:4], k=3)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_array_equal(D1, D2)
        assert "ave_all_jaccard" in fresh.report(data[:4], I2)
        assert fresh.expire(before=1.5) == 8  # stamps survived

    def test_save_async_capture_consistency(self, parts, tmp_path):
        import torch

        t = _port(parts, dtype=torch.bfloat16)
        data = _data(30, 16)
        t.add_sessions(data[:15])
        D1, I1 = t.search(data[:4], k=3)
        h = t.save_async(str(tmp_path / "asnap"))
        # mutate while (possibly) still writing; serve a query too
        t.add_sessions(data[15:])
        t.remove_sessions(data=data[2:4])
        t.search(data[:4], k=3)
        h.join()
        assert h.done() and t.index.ntotal == 28
        fresh = _port(parts)
        fresh.restore(str(tmp_path / "asnap"))
        assert fresh.index.ntotal == 15 and fresh.index.dtype == torch.bfloat16
        D2, I2 = fresh.search(data[:4], k=3)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_array_equal(D1, D2)

    def test_writer_error_surfaces_on_join(self, parts, tmp_path):
        t = _port(parts)
        t.add_sessions(_data(4, 17))
        h = t.save_async(str(tmp_path / "no_such_dir" / "snap"))
        with pytest.raises(OSError):
            h.join()

    def test_restore_drops_the_old_index_first(self, parts, tmp_path, monkeypatch):
        t = _port(parts)
        data = _data(10, 18)
        t.add_sessions(data)
        t.save(str(tmp_path / "snap"))
        real_load = port_dense.DenseIndex.load.__func__
        seen = {}

        def spy_load(cls, path, capacity=None, **kw):
            seen["index_at_load"] = t.index
            return real_load(cls, path, capacity=capacity, **kw)

        monkeypatch.setattr(port_dense.DenseIndex, "load", classmethod(spy_load))
        t.restore(str(tmp_path / "snap"))
        assert seen["index_at_load"] is None
        _, I = t.search(data[:3], k=2)
        np.testing.assert_array_equal(I[:, 0], np.arange(3))

    @pytest.mark.parametrize("saver", ["jax", "port"])
    def test_each_package_restores_the_others(self, parts, tmp_path, saver):
        # each engine holds its own package's sessions (equal field by
        # field), so the pickles carry either package's Action
        j, t = _pair(parts)
        data = _data(20, 19)
        for eng, rows in ((j, _data(20, 19, SyntheticSessionGenerator)), (t, data)):
            eng.add_sessions(rows[:12], stamp=3.0)
            eng.add_sessions(rows[12:])
            eng.remove_sessions(ids=[4])
        prefix = str(tmp_path / "snap")
        (j if saver == "jax" else t).save(prefix)
        jr, tr = _pair(parts)
        (tr if saver == "jax" else jr).restore(prefix)
        got, src = (tr, j) if saver == "jax" else (jr, t)
        assert got.index.ntotal == 19 and got.sessions == src.sessions
        np.testing.assert_array_equal(got._stamps.view(), src._stamps.view())
        Ds, Is = src.search(data[:6], k=4)
        Dg, Ig = got.search(data[:6], k=4)
        np.testing.assert_allclose(Dg, Ds, atol=TOL, rtol=0)
        port_engine = tr if saver == "jax" else t
        q = port_engine.embed(data[:6])
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        stored = port_engine.reconstruct(np.arange(19))
        for ids in (Ig, Is):
            assert value_recall_at_k(ids, q, stored, 4, rel_tol=TOL) == 1.0
        assert got.expire(before=4.0) == 11


HYBRID = [(k, f) for k in ("overlap", "stan") for f in ("score", "rrf")]


@pytest.mark.parametrize("kind,fusion", HYBRID)
def test_hybrid_matches_jax(parts, kind, fusion):
    j, t = _pair(parts)
    data = _data(40, 20)
    j.add_sessions(data)
    t.add_sessions(data)
    kw = dict(k=5, hybrid_alpha=0.5, hybrid_kind=kind, hybrid_fusion=fusion, overfetch=4)
    Dj, Ij = j.search(data[:6], **kw)
    Dt, It = t.search(data[:6], **kw)
    np.testing.assert_allclose(Dt, Dj, atol=TOL, rtol=0)
    # the port's fusion recomputed from its own dense candidates
    D2, I2 = t.search(data[:6], k=20)
    for r in range(6):
        q = data[r][0]
        fused = []
        for c, g in enumerate(I2[r]):
            s = t.sessions[g]
            if kind == "overlap":
                sparse = _overlap_cos(_item_set(q), _item_set(s))
            else:
                from sessionsimilaritysearch_tpu.engine import _item_stan_weights

                wq, ws = _item_stan_weights(q), _item_stan_weights(s)
                sparse = sum(w * ws.get(i, 0.0) for i, w in wq.items())
            fused.append((c, sparse))
        if fusion == "score":
            want = sorted(((0.5 * D2[r, c] + 0.5 * sp, c) for c, sp in fused),
                          key=lambda x: (-x[0], x[1]))
        else:
            sp_rank = {c: w for w, (c, _) in enumerate(sorted(fused, key=lambda x: (-x[1], x[0])))}
            want = sorted(((1 / (60 + c) + 1 / (60 + sp_rank[c]), c) for c, _ in fused),
                          key=lambda x: (-x[0], x[1]))
        np.testing.assert_allclose(Dt[r], [w for w, _ in want[:5]], atol=TOL, rtol=0)
        np.testing.assert_array_equal(It[r], [I2[r, c] for _, c in want[:5]])


def test_hybrid_alpha_one_is_dense_and_refuses_unbounded_metrics(parts):
    t = _port(parts)
    data = _data(24, 21)
    t.add_sessions(data)
    Dd, Id = t.search(data[:4], k=5)
    Dh, Ih = t.search(data[:4], k=5, hybrid_alpha=1.0)
    np.testing.assert_array_equal(Ih, Id)
    np.testing.assert_allclose(Dh, Dd, atol=1e-6)
    with pytest.raises(ValueError, match="hybrid_kind"):
        t.search(data[:2], k=2, hybrid_alpha=0.5, hybrid_kind="bm25")
    ip = _port(parts, metric="ip")
    ip.add_sessions(data[:4])
    with pytest.raises(ValueError, match="metric"):
        ip.search(data[:2], k=2, hybrid_alpha=0.5)


def test_range_search_with_where(parts):
    j, t = _pair(parts)
    data = _data(16, 22)
    j.add_sessions(data)
    t.add_sessions(data)
    lims, D, I = t.range_search(data[:4], 0.999)
    lj, Dj, Ij = j.range_search(data[:4], 0.999)
    np.testing.assert_array_equal(lims, lj)
    Dk, Ik = t.search(data[:4], k=16)
    for q in range(4):
        got = I[lims[q]: lims[q + 1]]
        assert q in got.tolist() and set(got.tolist()) == set(Ij[lj[q]: lj[q + 1]].tolist())
        assert set(got.tolist()) == set(Ik[q][Dk[q] >= 0.999].tolist())
        assert np.all(np.diff(D[lims[q]: lims[q + 1]]) <= 1e-6)
    first4 = [d[0] for d in data[:4]]
    lims2, _, I2 = t.range_search(data[:4], 0.999, where=lambda s: s not in first4)
    for q in range(4):
        assert q not in I2[lims2[q]: lims2[q + 1]].tolist()
    assert t.stats()["search"]["count"] == 3


def test_centered_engine_matches_jax(parts):
    j, t = _pair(parts, center="auto")
    data = _data(30, 23)
    j.add_sessions(data)
    t.add_sessions(data)
    assert t.index.center_mode == "auto"
    _same_search(j.search(data[:6], k=4), t.search(data[:6], k=4), t)


def test_unported_and_refused(parts, tmp_path):
    cfg, tok, data, _, tenc = parts
    kw = dict(dim=cfg.session_emb_dim, capacity=64, batch_size=8, device="cpu")
    # mode= and the two-stage verbs are ported (test_torch_twostage_verbs.py);
    # what JAX refuses is still refused
    with pytest.raises(ValueError, match="selection mode"):
        SessionSearchEngine(*_port_side(cfg), tenc, mode="fast", **kw)
    emb = _port(parts).embed(data)
    proj = fit_itq(emb / np.linalg.norm(emb, axis=1, keepdims=True), 32)
    two = SessionSearchEngine(*_port_side(cfg), tenc, prefilter="itq", stage1="packed",
                              projector=proj, pool=64, **kw)
    two.add_sessions(data[:8])
    with pytest.raises(ValueError, match="two-stage"):
        two.range_search(data[:2], 0.5)
    with pytest.raises(ValueError, match="remove ids"):
        two.remove_sessions(ids=[8])
    with pytest.raises(FileNotFoundError):
        two.restore(str(tmp_path / "missing"))
    assert two.index is None  # the live index is dropped before the load
    two = SessionSearchEngine(*_port_side(cfg), tenc, prefilter="itq", stage1="packed",
                              projector=proj, pool=64, **kw)
    two.add_sessions(data[:8])
    assert two.index.ntotal == 8 and len(two.sessions) == 8
    with pytest.raises(ValueError, match="center"):
        SessionSearchEngine(*_port_side(cfg), tenc, prefilter="itq", stage1="packed",
                            projector=proj, center="auto", **kw)


def test_dedup_after_removal_keeps_keys_unique(parts):
    t = _port(parts)
    data = _data(10, 24)
    t.add_sessions(data)
    t.add_sessions(data[:3])  # rows 10-12 duplicate 0-2
    t.remove_sessions(ids=[0])
    _, I = t.search(data[:3], k=4, dedup=True)
    for r in range(3):
        keys = [_session_key(t.sessions[i]) for i in I[r] if i >= 0]
        assert len(set(keys)) == len(keys)
