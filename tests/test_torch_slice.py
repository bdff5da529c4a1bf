"""The serving slice end to end: the port's SessionSearchEngine against the
JAX SessionSearchEngine, both around the flagship GraphLevelEncoder (tiny
config) with the same weights (Flax init, converted by ``weights.py``), fed
the same sessions.

Tolerances: embeddings atol 1e-5 of their largest magnitude (float32,
sums in another order through the whole encoder); cosine scores 1e-5; the
port's ids must reach value-recall 1.0 at rel_tol 1e-5 against the rows it
stores."""

import jax
import numpy as np
import pytest

import __graft_entry__
from sessionsimilaritysearch_tpu.config import tiny_test_config
from sessionsimilaritysearch_tpu.data.synthetic import SyntheticSessionGenerator
from sessionsimilaritysearch_tpu.engine import SessionSearchEngine as JaxEngine
from sessionsimilaritysearch_tpu.models import build_graph_encoder as flax_build
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu_torch.engine import (
    SessionSearchEngine,
    _session_key,
)
from sessionsimilaritysearch_tpu_torch.models.encoder import build_graph_encoder
from sessionsimilaritysearch_tpu_torch.ops import mips
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
    params = jax.tree.map(np.asarray, fenc.init(
        jax.random.PRNGKey(0), __graft_entry__._example_batch(cfg, 8)))
    encode_fn = jax.jit(lambda g: fenc.apply(params, g))
    tenc = build_graph_encoder(cfg, "cpu")
    tenc.load_state_dict(flax_to_state_dict(params), strict=True)
    return cfg, tok, data, encode_fn, tenc


def _engines(parts, data):
    cfg, tok, _, encode_fn, tenc = parts
    kw = dict(dim=cfg.session_emb_dim, capacity=64, batch_size=8)
    j = JaxEngine(cfg, tok, encode_fn, **kw)
    t = SessionSearchEngine(cfg, tok, tenc, device="cpu", **kw)
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


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"quantize": "int8"},
                                {"prefilter": "binary"}, {"center": "auto"}])
def test_unported_engine_options_raise(parts, kw):
    # the port's engine has no such options yet: a call that sets one is
    # rejected, never served by the plain dense path
    cfg, tok, _, _, tenc = parts
    with pytest.raises(TypeError, match=next(iter(kw))):
        SessionSearchEngine(cfg, tok, tenc, dim=cfg.session_emb_dim,
                            capacity=8, device="cpu", **kw)
