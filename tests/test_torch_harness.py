"""The port's evaluation harness (``evalharness/harness.py``) against the
JAX package's on one tiny corpus: ``EmbeddingPipeline`` (with ``workers``
and ``prefetch``), ``run_dense_search``, every runner (``evaluate_encoder``,
``evaluate_binary``, both kNN runners, ``evaluate_sparse``,
``evaluate_hybrid``), the results round trip (``save_results``,
``load_results``, ``evaluate_loaded``, across the packages), and the
flagship serving path as a whole: bf16 ``serving_params`` + catalog tables
+ ``make_cached_encode_fn`` inside a default ``SessionSearchEngine``.

Both packages' encoders carry the same weights (``weights.flax_to_state_dict``).
Tolerances: embeddings and scores of the f32 encoders atol 1e-5 of the
largest |value| (rtol 1e-4), ids through ``value_recall_at_k`` (ties may
resolve to other rows), reports within rtol 1e-5; runners whose inputs are
the same on both sides (sparse, hybrid with a host feature encoder, binary
codes, saved results) must agree exactly. The bf16 slice: ids through
value-recall@10 at two bf16 ulps, scores within 2^-6."""

import jax
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu import engine as j_engine
from sessionsimilaritysearch_tpu.config import tiny_test_config
from sessionsimilaritysearch_tpu.data import SyntheticSessionGenerator as JGen
from sessionsimilaritysearch_tpu.evalharness import harness as jh
from sessionsimilaritysearch_tpu.models import build_graph_encoder as flax_build
from sessionsimilaritysearch_tpu.ops import topk as j_topk
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu.utils import precision as j_precision
from sessionsimilaritysearch_tpu_torch import engine as t_engine
from sessionsimilaritysearch_tpu_torch.evalharness import harness as th
from sessionsimilaritysearch_tpu_torch.evalharness import metrics as t_metrics
from sessionsimilaritysearch_tpu_torch.models.encoder import build_graph_encoder
from sessionsimilaritysearch_tpu_torch.utils import precision as t_precision
from sessionsimilaritysearch_tpu_torch.weights import flax_to_state_dict

CPU = "cpu"


def _reports_equal(got, want, rtol=1e-5):
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, err_msg=key)


def _recall(jax_D, ids, k, scores_of):
    """value_recall_at_k of ``ids`` against JAX's top-k values, the scores
    of ``ids`` recomputed by ``scores_of(row, ids)``."""
    got = np.stack([scores_of(i, row) for i, row in enumerate(ids)])
    return j_topk.value_recall_from_scores(got, np.asarray(jax_D)[:, :k],
                                           1e-5 * np.abs(jax_D).max(axis=1))


@pytest.fixture(scope="module")
def cfg():
    return tiny_test_config()


@pytest.fixture(scope="module")
def tok(cfg):
    return get_tokenizer(cfg.vocab_size)


@pytest.fixture(scope="module")
def gen(cfg):
    return JGen(asin_num=cfg.asin_num, seed=5)


@pytest.fixture(scope="module")
def split(gen):
    """(corpus, test): 40 corpus pairs and 10 test (prefix, future) pairs,
    every session with at least one product."""
    data = [d for d in gen.dataset(80) if any(a[1] != "s" for a in d[0]) and d[1]]
    return data[:40], data[40:50]


@pytest.fixture(scope="module")
def encoders(cfg, tok, split):
    """(JAX jitted encode fn, port encoder, fenc, params), one set of weights."""
    from sessionsimilaritysearch_tpu.data import build_graph_batch

    batch = build_graph_batch(split[0][:4], tok, cfg.dims, ignore_query=cfg.ignore_query)
    fenc = flax_build(cfg)
    params = jax.tree.map(np.asarray, jax.jit(fenc.init)(jax.random.PRNGKey(0), batch))
    tenc = build_graph_encoder(cfg, CPU)
    tenc.load_state_dict(flax_to_state_dict(params), strict=True)
    return jax.jit(lambda g: fenc.apply(params, g)), tenc, fenc, params


def _features(asin, mask):
    """A host feature encoder, the same numpy function in both packages:
    each session's product ids through a fixed random table, summed. Its
    width is the session embedding's, so it can pair with the encoder."""
    width = tiny_test_config().session_emb_dim
    table = np.random.default_rng(0).standard_normal((1000, width)).astype(np.float32)
    return (table[np.asarray(asin)] * np.asarray(mask)[..., None]).sum(axis=1)


def _t_features(g):
    return torch.from_numpy(_features(g.product_asin.numpy(), g.product_node_mask.numpy()))


def _j_features(g):
    return _features(g.product_asin, g.product_node_mask)


def test_embedding_pipeline_workers_and_prefetch(cfg, tok, split, encoders):
    jfn, tenc, _, _ = encoders
    sessions = [d[0] for d in split[0]]
    base = th.EmbeddingPipeline(cfg, tok, tenc, device=CPU, batch_size=16)(sessions)
    pooled = th.EmbeddingPipeline(cfg, tok, tenc, device=CPU, batch_size=16, workers=1,
                                  prefetch=1)(sessions)
    np.testing.assert_array_equal(pooled, base)
    assert base.shape == (len(sessions), cfg.session_emb_dim)
    want = jh.EmbeddingPipeline(cfg, tok, jfn, 16)(sessions)
    np.testing.assert_allclose(base, want, atol=1e-5 * np.abs(want).max(), rtol=1e-4)
    dev = th.EmbeddingPipeline(cfg, tok, tenc, device=CPU, batch_size=16)(sessions, out="device")
    assert isinstance(dev, torch.Tensor) and torch.equal(dev, torch.from_numpy(base))


def test_run_dense_search(cfg):
    rng = np.random.default_rng(3)
    corpus = rng.standard_normal((300, 24)).astype(np.float32)
    queries = rng.standard_normal((9, 24)).astype(np.float32)
    for metric in ("cos", "ip"):
        D, I, build_s, search_s = th.run_dense_search(corpus, queries, 12, metric,
                                                      chunk_size=128, device=CPU)
        jD, jI, _, _ = jh.run_dense_search(corpus, queries, 12, metric, chunk_size=128)
        np.testing.assert_array_equal(I, np.asarray(jI))
        np.testing.assert_allclose(D, np.asarray(jD), atol=1e-5 * np.abs(jD).max())
        assert build_s >= 0 and search_s > 0


def test_evaluate_encoder(cfg, tok, split, encoders):
    jfn, tenc, _, _ = encoders
    corpus, test = split
    got = th.evaluate_encoder(cfg, tok, tenc, corpus, test, k=10, batch_size=16, device=CPU)
    want = jh.evaluate_encoder(cfg, tok, jfn, corpus, test, k=10, batch_size=16)
    emb = th.EmbeddingPipeline(cfg, tok, tenc, device=CPU, batch_size=16)
    ce = emb([d[0] for d in corpus])
    qe = emb(test)
    ce /= np.linalg.norm(ce, axis=1, keepdims=True)
    qe /= np.linalg.norm(qe, axis=1, keepdims=True)
    assert _recall(want.D, got.I, 10, lambda i, row: ce[row] @ qe[i]) == 1.0
    np.testing.assert_allclose(got.D, want.D, atol=1e-5)
    _reports_equal(got.report, want.report)
    assert got.qps > 0 and got.embed_corpus_s > 0 and got.search_s > 0


@pytest.mark.parametrize("mode", ["sign", "packed"])
def test_evaluate_binary(split, mode):
    corpus, test = split
    rng = np.random.default_rng(4)
    db = np.where(rng.random((len(corpus), 48)) < 0.5, 1.0, -1.0).astype(np.float32)
    q = np.where(rng.random((len(test), 48)) < 0.5, 1.0, -1.0).astype(np.float32)
    sessions = [d[0] for d in corpus]
    got = th.evaluate_binary(db, q, sessions, test, k=8, mode=mode, device=CPU)
    want = jh.evaluate_binary(db, q, sessions, test, k=8, mode=mode)
    np.testing.assert_array_equal(got.D, np.asarray(want.D))
    # equal distances may list their rows in another order: compare the sets
    # of rows strictly inside each query's k-th distance, then the reports
    for d, a, b in zip(got.D, got.I, np.asarray(want.I)):
        inside = d < d[-1]
        assert set(a[inside]) == set(b[inside])
    if np.array_equal(got.I, np.asarray(want.I)):
        _reports_equal(got.report, want.report)
    # selection='approx' (sign mode) selects exactly: the exact run's result
    if mode == "sign":
        ap = th.evaluate_binary(db, q, sessions, test, k=8, mode=mode, selection="approx",
                                recall_target=0.9, device=CPU)
        np.testing.assert_array_equal(ap.D, got.D)
        np.testing.assert_array_equal(ap.I, got.I)
    else:
        with pytest.raises(ValueError, match="sign-matmul"):
            th.evaluate_binary(db, q, sessions, test, selection="approx", mode=mode,
                               device=CPU)


def test_evaluate_knn_runners(cfg, tok, split, encoders):
    jfn, tenc, _, _ = encoders
    corpus, test = split
    got = th.evaluate_knn_recommendation(cfg, tok, tenc, corpus, test, K=5, sample_size=20,
                                         batch_size=16, device=CPU)
    want = jh.evaluate_knn_recommendation(cfg, tok, jfn, corpus, test, K=5, sample_size=20,
                                          batch_size=16)
    assert got["K"] == want["K"] == 5
    assert got["recall_at_k"] == pytest.approx(want["recall_at_k"], abs=1e-12)
    # the feature encoder as the subsession tower: three different pairings
    got = th.evaluate_knn_pairings(cfg, tok, _t_features, tenc, corpus, test, K=5,
                                   sample_size=20, batch_size=16, device=CPU)
    want = jh.evaluate_knn_pairings(cfg, tok, _j_features, jfn, corpus, test, K=5,
                                    sample_size=20, batch_size=16)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-12), key


@pytest.mark.parametrize("kind", ["binary", "stan"])
def test_evaluate_sparse(cfg, split, kind):
    corpus, test = split
    sessions = [d[0] for d in corpus]
    got = th.evaluate_sparse(cfg, sessions, test, kind=kind, k=7)
    want = jh.evaluate_sparse(cfg, sessions, test, kind=kind, k=7)
    np.testing.assert_array_equal(got.D, want.D)
    np.testing.assert_array_equal(got.I, want.I)
    _reports_equal(got.report, want.report, rtol=0)


@pytest.mark.parametrize("kind", ["overlap", "stan"])
@pytest.mark.parametrize("fusion", ["score", "rrf"])
def test_evaluate_hybrid(cfg, tok, split, kind, fusion):
    corpus, test = split
    got = th.evaluate_hybrid(cfg, tok, _t_features, corpus, test, k=7, alpha=0.3, kind=kind,
                             fusion=fusion, batch_size=16, device=CPU)
    want = jh.evaluate_hybrid(cfg, tok, _j_features, corpus, test, k=7, alpha=0.3, kind=kind,
                              fusion=fusion, batch_size=16)
    np.testing.assert_array_equal(got.D, want.D)
    np.testing.assert_array_equal(got.I, want.I)
    _reports_equal(got.report, want.report, rtol=0)
    with pytest.raises(ValueError):
        th.evaluate_hybrid(cfg, tok, _t_features, corpus, test, kind="bm25", device=CPU)


def test_results_round_trip(tmp_path, split):
    corpus, test = split
    sessions = [d[0] for d in corpus]
    rng = np.random.default_rng(6)
    I = rng.integers(-1, len(sessions), (len(test), 6))
    D = np.sort(rng.random((len(test), 6)).astype(np.float32), axis=1)[:, ::-1].copy()
    want = t_metrics.full_report(D, I, test, sessions)
    th.save_results(str(tmp_path / "port.pkl"), torch.from_numpy(D), I, test, sessions)
    jh.save_results(str(tmp_path / "jax.pkl"), D, I, test, sessions)
    for path in ("port.pkl", "jax.pkl"):  # each package reads either file
        _reports_equal(th.evaluate_loaded(str(tmp_path / path)), want, rtol=0)
        _reports_equal(jh.evaluate_loaded(str(tmp_path / path)), want, rtol=0)
    blob = th.load_results(str(tmp_path / "jax.pkl"))
    np.testing.assert_array_equal(blob["I"], I)
    assert blob["test_data"] == test
    th.save_results(str(tmp_path / "noD.pkl"), None, I, test, sessions)
    assert th.load_results(str(tmp_path / "noD.pkl"))["D"] is None
    import pickle

    with open(tmp_path / "bad.pkl", "wb") as f:
        pickle.dump({"I": I}, f)
    with pytest.raises(KeyError, match="test_data"):
        th.load_results(str(tmp_path / "bad.pkl"))


def test_flagship_serving_slice(cfg, tok, gen, split, encoders):
    """The path as a whole on both packages: bf16 serving parameters, title
    and keyword tables, the cached encode fn inside a default engine (a f32
    DenseIndex searched through K1's plain version here)."""
    _, tenc, fenc, params = encoders
    corpus, test = split
    sessions = [d[0] for d in corpus]
    kws = sorted({a[2] or "" for s in sessions for a in s if a[1] == "s"})
    jserve = j_precision.serving_params(params)
    jt = jh.build_title_table(cfg, tok, gen.titles, fenc, jserve, batch_size=256)
    jq, jlk = jh.build_keyword_table(cfg, tok, kws, fenc, jserve, batch_size=256)
    jeng = j_engine.SessionSearchEngine(cfg, tok, jh.make_cached_encode_fn(fenc, jserve, jt, jq, jlk),
                                        dim=cfg.session_emb_dim, capacity=64, batch_size=16)
    tserve = t_precision.serving_params(tenc)
    tt = th.build_title_table(cfg, tok, gen.titles, tserve, batch_size=256)
    tq, tlk = th.build_keyword_table(cfg, tok, kws, tserve, batch_size=256)
    fn = th.make_cached_encode_fn(tserve, tt, tq, tlk)
    teng = t_engine.SessionSearchEngine(cfg, tok, fn, dim=cfg.session_emb_dim, capacity=64,
                                        batch_size=16, device=CPU)
    jeng.add_sessions(sessions)
    teng.add_sessions(sessions)
    assert teng.index.dtype == torch.float32 and fn.oov_batches == 0
    queries = [d[0] for d in test] + sessions[:6]
    jD, _ = jeng.search(queries, k=10)
    D, I = teng.search(queries, k=10)
    assert (I[-6:, 0] == np.arange(6)).all()  # stored sessions find themselves
    rows = teng.reconstruct(range(len(sessions)))
    qe = teng.embed(queries)
    qe /= np.linalg.norm(qe, axis=1, keepdims=True)
    # the port's ids hold the JAX top-10's values at two bf16 ulps
    got = np.stack([rows[r] @ qe[i] for i, r in enumerate(I)])
    rec = j_topk.value_recall_from_scores(got, np.asarray(jD), 2 * 2.0**-8 * np.ones(len(I)))
    assert rec == 1.0
    assert np.abs(D - np.asarray(jD)).max() <= 2.0**-6
