"""The serving slice end to end: the port's SessionSearchEngine against the
JAX SessionSearchEngine, both around the flagship GraphLevelEncoder (tiny
config) with the same weights (Flax init, converted by ``weights.py``), fed
the same sessions.

Tolerances: embeddings atol 1e-5 of their largest magnitude (float32,
sums in another order through the whole encoder); cosine scores 1e-5; the
port's ids must reach value-recall 1.0 at rel_tol 1e-5 against the rows it
stores."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from sessionsimilaritysearch_tpu.config import tiny_test_config
from sessionsimilaritysearch_tpu.data.synthetic import SyntheticSessionGenerator
from sessionsimilaritysearch_tpu.engine import SessionSearchEngine as JaxEngine
from sessionsimilaritysearch_tpu.models import build_graph_encoder as flax_build
from sessionsimilaritysearch_tpu.ops.projection import fit_itq
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu_torch.engine import (
    SessionSearchEngine,
    _session_key,
)
from sessionsimilaritysearch_tpu_torch.models.encoder import build_graph_encoder
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config as port_tiny_config
from sessionsimilaritysearch_tpu_torch.ops import mips, mips_int8, packed
from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer as port_tokenizer
from sessionsimilaritysearch_tpu_torch.ops.topk import value_recall_at_k
from sessionsimilaritysearch_tpu_torch.weights import flax_to_state_dict

TOL = 1e-5


@pytest.fixture(scope="module")
def parts():
    cfg = tiny_test_config()
    tok = get_tokenizer(cfg.vocab_size)
    # a generator of this module's own: the shared conftest one is stateful
    data = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=0).dataset(40)
    fenc = flax_build(cfg)
    params = jax.tree.map(np.asarray, jax.jit(fenc.init)(
        jax.random.PRNGKey(0), __graft_entry__._example_batch(cfg, 8)))
    encode_fn = jax.jit(lambda g: fenc.apply(params, g))
    tenc = build_graph_encoder(cfg, "cpu")
    tenc.load_state_dict(flax_to_state_dict(params), strict=True)
    return cfg, tok, data, encode_fn, tenc


def _port_side(cfg):
    """The port's own config and tokenizer, equal to the JAX package's
    (tests/test_torch_shared.py), for the port's engines."""
    pcfg = port_tiny_config()
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    return pcfg, port_tokenizer(pcfg.vocab_size)


def _engines(parts, data, **opts):
    cfg, tok, _, encode_fn, tenc = parts
    kw = dict(dim=cfg.session_emb_dim, capacity=64, batch_size=8, **opts)
    j = JaxEngine(cfg, tok, encode_fn, **kw)
    t = SessionSearchEngine(*_port_side(cfg), tenc, device="cpu", **kw)
    j.add_sessions(data)
    t.add_sessions(data)
    return j, t


def _value_recall(t, emb, I):
    stored = t.reconstruct(np.arange(t.index.ntotal))
    q = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    return value_recall_at_k(I, q, stored, I.shape[1], rel_tol=TOL)


def test_embeddings_match(parts):
    _, _, data, _, _ = parts
    j, t = _engines(parts, data[:1])
    want = j.embed(data)
    got = t.embed(data)
    assert got.shape == want.shape == (40, parts[0].session_emb_dim)
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)


def test_add_then_search(parts):
    _, _, data, _, _ = parts
    j, t = _engines(parts, data)
    assert t.index.ntotal == j.index.ntotal == 40
    Dj, Ij = j.search(data[:10], k=5)
    Dt, It = t.search(data[:10], k=5)
    np.testing.assert_allclose(Dt, Dj, atol=TOL, rtol=0)
    np.testing.assert_array_equal(It[:, 0], np.arange(10))  # self top-1
    stats = t.stats()  # one encode for the add, one for the search
    assert stats["ntotal"] == 40 and stats["encode"]["count"] == 2
    assert stats["search"]["count"] == 1
    assert _value_recall(t, t.embed(data[:10]), It) == 1.0
    assert "ave_all_jaccard" in t.report(data[:10], It)
    assert mips.launch_count == 0  # CPU tensors take the plain version


def test_streaming_insert_global_ids(parts):
    _, _, data, _, _ = parts
    j, t = _engines(parts, data[:25])
    t.add_sessions(data[25:])
    _, It = t.search(data[25:28], k=1)
    np.testing.assert_array_equal(It[:, 0], [25, 26, 27])


def test_dedup_search(parts):
    _, _, data, _, _ = parts
    j, t = _engines(parts, data[:10])
    j.add_sessions(data[:3])  # a replayed stream: rows 10-12 duplicate 0-2
    t.add_sessions(data[:3])
    _, It = t.search(data[:3], k=4)
    assert set(It[0, :2].tolist()) == {0, 10}  # without dedup both rank
    Dj, Ij = j.search(data[:3], k=4, dedup=True)
    Dt, It = t.search(data[:3], k=4, dedup=True)
    np.testing.assert_allclose(Dt, Dj, atol=TOL, rtol=0)
    for r in range(3):
        keys = [_session_key(t.sessions[i]) for i in It[r] if i >= 0]
        assert len(set(keys)) == len(keys)  # no duplicate sessions


def test_where_filter(parts):
    _, _, data, _, _ = parts
    j, t = _engines(parts, data)

    def where(sess):
        return len(sess) % 2 == 0

    Dj, Ij = j.search(data[:8], k=5, where=where)
    Dt, It = t.search(data[:8], k=5, where=where)
    np.testing.assert_allclose(Dt, Dj, atol=TOL, rtol=0)
    np.testing.assert_array_equal(It < 0, Ij < 0)
    assert all(where(t.sessions[i]) for i in It[It >= 0])


@pytest.mark.parametrize("kw", [{"mesh": 2}, {"quantize": "int8"},
                                {"prefilter": "binary"}, {"center": "auto"}])
def test_unported_engine_options_raise(parts, kw):
    # the engine options the port once refused are all ported: quantize,
    # center, a prefilter with the default stage1='matmul', and (since the
    # sharded serving slice) a mesh, here of 2 CPU shards; each builds and
    # searches (tests/test_torch_sharded_engine.py holds the mesh engine
    # against JAX's)
    cfg, tok, data, encode_fn, tenc = parts
    if "mesh" in kw:
        from sessionsimilaritysearch_tpu_torch.parallel import create_mesh

        mesh = create_mesh(devices=[torch.device("cpu")] * kw["mesh"])
        t = SessionSearchEngine(*_port_side(cfg), tenc, dim=cfg.session_emb_dim,
                                capacity=64, batch_size=8, mesh=mesh)
        t.add_sessions(data[:20])
        _, It = t.search(data[:5], k=3)
        assert t.index.ndev == 2 and t.index.ntotal == 20
        np.testing.assert_array_equal(It[:, 0], np.arange(5))
        return
    if "quantize" in kw:
        t = SessionSearchEngine(*_port_side(cfg), tenc, dim=cfg.session_emb_dim,
                                capacity=64, batch_size=8, device="cpu", **kw)
        t.add_sessions(data[:20])
        _, It = t.search(data[:5], k=3)
        assert t.index.quantize == "int8"
        np.testing.assert_array_equal(It[:, 0], np.arange(5))
        with pytest.raises(ValueError, match="drop quantize"):
            SessionSearchEngine(*_port_side(cfg), tenc, dim=cfg.session_emb_dim,
                                capacity=8, device="cpu", prefilter="itq",
                                stage1="packed", **kw)
        return
    if "center" in kw:
        j, t = _engines(parts, data, **kw)
        assert t.index.center_mode == "auto"
        Dj, Ij = j.search(data[:5], k=3)
        Dt, It = t.search(data[:5], k=3)
        np.testing.assert_allclose(Dt, Dj, atol=TOL, rtol=0)
        np.testing.assert_array_equal(It[:, 0], np.arange(5))
        return
    if "prefilter" in kw:
        t = SessionSearchEngine(*_port_side(cfg), tenc, dim=cfg.session_emb_dim,
                                capacity=64, batch_size=8, device="cpu", pool=64, **kw)
        t.add_sessions(data[:20])
        D, It = t.search(data[:5], k=3)
        assert t.index.stage1 == "matmul" and t.index.ntotal == 20
        np.testing.assert_array_equal(It[:, 0], np.arange(5))


def test_twostage_itq_engine_matches_jax(parts):
    # both engines serve prefilter='itq', stage1='packed' with one projector,
    # fitted by the JAX fit_itq on the JAX embeddings; the pool holds the
    # whole corpus, so both return the exact dense result over bf16 rows
    cfg, tok, data, encode_fn, tenc = parts
    emb = JaxEngine(cfg, tok, encode_fn, dim=cfg.session_emb_dim, capacity=64,
                    batch_size=8).embed(data)
    proj = fit_itq(emb / np.linalg.norm(emb, axis=1, keepdims=True), 32)
    kw = dict(dim=cfg.session_emb_dim, capacity=64, batch_size=8,
              prefilter="itq", stage1="packed", projector=proj, pool=64)
    j = JaxEngine(cfg, tok, encode_fn, **kw)
    t = SessionSearchEngine(*_port_side(cfg), tenc, device="cpu", **kw)
    j.add_sessions(data)
    t.add_sessions(data)
    assert t.index.store_dtype == torch.bfloat16  # dtype=None: the default
    Dj, Ij = j.search(data[:10], k=5)
    Dt, It = t.search(data[:10], k=5)
    np.testing.assert_allclose(Dt, Dj, atol=TOL, rtol=0)
    np.testing.assert_array_equal(It[:, 0], np.arange(10))  # self top-1
    assert packed.launch_count == 0  # CPU tensors take the plain version


def test_int8x8_engine_matches_jax(parts):
    # both engines store int8 codes and quantize the queries per row: the
    # same embeddings (to 1e-5) give the same codes, so the scores agree to
    # 1e-5; the port's are also checked against the rows it stores
    _, _, data, _, _ = parts
    j, t = _engines(parts, data, quantize="int8x8")
    assert t.index.quantize == "int8x8" and t.index._buf.dtype == torch.int8
    Dj, Ij = j.search(data[:10], k=5)
    Dt, It = t.search(data[:10], k=5)
    np.testing.assert_array_equal(It[:, 0], np.arange(10))  # self top-1
    np.testing.assert_allclose(Dt, Dj, atol=TOL, rtol=0)
    assert (It == Ij).mean() > 0.9  # ties may swap
    # the port's own values: its dequantized query codes against its rows
    q = t.embed(data[:10])
    qb = torch.from_numpy(q).bfloat16()
    from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize

    codes, scales = mips_int8.quantize_rows_int8(l2_normalize(qb).bfloat16())
    deq = (codes.double() * scales.double()[:, None]).numpy()
    stored = t.reconstruct(np.arange(t.index.ntotal))
    true = np.take_along_axis(deq @ stored.T.astype(np.float64), It, axis=1)
    np.testing.assert_allclose(Dt, true, rtol=1e-5, atol=0)
    assert value_recall_at_k(It, deq, stored, 5, rel_tol=TOL) == 1.0
    assert mips_int8.launch_count == 0  # CPU tensors take the plain version
