"""The port's copies of the JAX package's jax-free modules (config,
tokenizer, data, native, evalharness.metrics) held against the originals:
the same fields, token ids, synthetic sessions, graph arrays, metrics and
native graph batches; and the jax-free helpers it copies out of modules
that import JAX (index/dense.py compaction_plan and _range_from_search;
engine.py _item_set, _overlap_cos, _item_stan_weights, _session_key,
_GrowArr, _hybrid_rerank and _dedup_topk), which must return what the
originals return; and the evaluation harness's copies (data/augment.py,
data/etl.py, evalharness/knn.py, index/sparse.py, utils/logging.py),
function by function. The port imports none of the originals
(tests/test_torch_package.py); these tests keep the copies equal."""

import dataclasses
import shutil

import numpy as np
import pytest

from sessionsimilaritysearch_tpu import config as j_config
from sessionsimilaritysearch_tpu import data as j_data
from sessionsimilaritysearch_tpu import native as j_native
from sessionsimilaritysearch_tpu import tokenizer as j_tokenizer
from sessionsimilaritysearch_tpu.evalharness import metrics as j_metrics
from sessionsimilaritysearch_tpu_torch import config as t_config
from sessionsimilaritysearch_tpu_torch import data as t_data
from sessionsimilaritysearch_tpu_torch import native as t_native
from sessionsimilaritysearch_tpu_torch import native_build
from sessionsimilaritysearch_tpu_torch import tokenizer as t_tokenizer
from sessionsimilaritysearch_tpu_torch.evalharness import metrics as t_metrics


def _sessions(mod, n=40, seed=3):
    return mod.SyntheticSessionGenerator(asin_num=500, seed=seed).dataset(n)


@pytest.mark.parametrize("make", ["Config", "tiny_test_config"])
def test_config_field_by_field(make):
    j, t = getattr(j_config, make)(), getattr(t_config, make)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.astuple(t.dims) == dataclasses.astuple(j.dims)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]


def test_tokenizer_ids():
    texts = [" ".join(a[2] or "" for a in s) for s, _ in _sessions(j_data, 20)]
    texts += ["", "Kelvin K sign", "UPPER lower 123 x-y"]
    j = j_tokenizer.get_tokenizer(30522)
    t = t_tokenizer.get_tokenizer(30522)
    for a, b in zip(t(texts, 24), j(texts, 24)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for text in texts:
        np.testing.assert_array_equal(t.encode_one(text, 16), j.encode_one(text, 16))


@pytest.mark.parametrize("gen", ["SyntheticSessionGenerator", "AdversarialSessionGenerator"])
def test_synthetic_datasets(gen):
    j = getattr(j_data, gen)(asin_num=300, seed=11).dataset(30)
    t = getattr(t_data, gen)(asin_num=300, seed=11).dataset(30)
    assert t == j  # Actions are tuples: equal field by field


def test_sequence_to_graph_and_batch_graphs():
    cfg = t_config.tiny_test_config()
    tok = t_tokenizer.get_tokenizer(cfg.vocab_size)
    data = _sessions(t_data, 12)
    for ignore_query in (True, False):
        tg = [t_data.sequence_to_graph(i, s, f, tok, cfg.dims, ignore_query=ignore_query)
              for i, (s, f) in enumerate(data)]
        jg = [j_data.sequence_to_graph(i, s, f, tok, cfg.dims, ignore_query=ignore_query)
              for i, (s, f) in enumerate(data)]
        for a, b in zip(tg, jg):
            for name, x, y in zip(t_data.SessionGraph._fields, a, b):
                np.testing.assert_array_equal(x, y, err_msg=name)
        for name, x, y in zip(t_data.SessionGraph._fields, t_data.batch_graphs(tg),
                              j_data.batch_graphs(jg)):
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_metrics_on_one_result_set():
    data = _sessions(t_data, 60)
    corpus, test = [s for s, _ in data[:50]], data[50:]
    rng = np.random.default_rng(4)
    I = rng.integers(0, 50, (10, 5))
    D = np.sort(rng.random((10, 5)).astype(np.float32), axis=1)[:, ::-1]
    got = t_metrics.full_report(D, I, test, corpus)
    want = j_metrics.full_report(D, I, test, corpus)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, err_msg=key)


def test_native_graphs_match_jax_native_and_python():
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("needs make and a C++ compiler (g++)")
    assert native_build.ensure_native_library() in ("present", "openmp", "serial")
    assert t_native.load() is not None and j_native.load() is not None
    cfg = t_config.tiny_test_config()
    t_tok = t_tokenizer.get_tokenizer(cfg.vocab_size)
    j_tok = j_tokenizer.get_tokenizer(cfg.vocab_size)
    data = _sessions(t_data, 48, seed=9)
    t_nat = t_data.build_graph_batch(data, t_tok, cfg.dims, ignore_query=True)
    j_nat = j_data.build_graph_batch(data, j_tok, cfg.dims, ignore_query=True)
    py = t_data.batch_graphs([
        t_data.sequence_to_graph(i, s, f, t_tok, cfg.dims, ignore_query=True)
        for i, (s, f) in enumerate(data)])
    for name, a, b, c in zip(t_data.SessionGraph._fields, t_nat, j_nat, py):
        assert a.dtype == b.dtype == c.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, c, err_msg=name)


# --- the jax-free helpers the port's index and engine copy from modules that
# import JAX (index/dense.py, engine.py)

from sessionsimilaritysearch_tpu import engine as j_engine  # noqa: E402
from sessionsimilaritysearch_tpu.index import dense as j_dense  # noqa: E402
from sessionsimilaritysearch_tpu_torch import engine as t_engine  # noqa: E402
from sessionsimilaritysearch_tpu_torch.index import dense as t_dense  # noqa: E402


@pytest.mark.parametrize("seed", range(4))
def test_compaction_plan(seed):
    rng = np.random.default_rng(seed)
    size = int(rng.integers(1, 300))
    ids = rng.integers(0, size, size=int(rng.integers(0, size + 1)))
    for got, want in zip(t_dense.compaction_plan(size, ids), j_dense.compaction_plan(size, ids)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("descending", [True, False])
def test_range_from_search(descending):
    rng = np.random.default_rng(5)
    scores = rng.standard_normal((6, 200)).astype(np.float32)
    scores[2] = 3.0  # a query every row is within radius of: depth reaches total

    def search_fn(k):
        order = np.argsort(-scores if descending else scores, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(scores, order, axis=1), order.astype(np.int64)

    kw = dict(descending=descending, total=200, k0=8)
    got = t_dense._range_from_search(search_fn, 6, 1.5 if descending else -1.5, **kw)
    want = j_dense._range_from_search(search_fn, 6, 1.5 if descending else -1.5, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    empty = t_dense._range_from_search(search_fn, 0, 0.0, **kw)
    for a, b in zip(empty, j_dense._range_from_search(search_fn, 0, 0.0, **kw)):
        assert a.dtype == b.dtype and a.shape == b.shape


def test_session_helpers():
    sessions = [s for s, _ in _sessions(t_data, 40, seed=6)]
    for a in sessions:
        assert t_engine._item_set(a) == j_engine._item_set(a)
        assert t_engine._session_key(a) == j_engine._session_key(a)
        assert t_engine._item_stan_weights(a) == j_engine._item_stan_weights(a)
        for b in sessions[:8]:
            sa, sb = t_engine._item_set(a), t_engine._item_set(b)
            assert t_engine._overlap_cos(sa, sb) == j_engine._overlap_cos(sa, sb)


def test_grow_arr():
    arrs = [mod._GrowArr(np.int64) for mod in (t_engine, j_engine)]
    for a in arrs:
        for i in range(1500):  # past the first growth
            a.append(i * 3)
        a.extend(range(7))
        a[4] = -1
    t, j = arrs
    assert len(t) == len(j) == 1507 and t[4] == j[4] == -1
    np.testing.assert_array_equal(t.view(), j.view())
    np.testing.assert_array_equal(t.view(10), j.view(10))
    built = [mod._GrowArr(np.float64, [1.0, 2.5]) for mod in (t_engine, j_engine)]
    np.testing.assert_array_equal(built[0].view(), built[1].view())


def _bare_engine(mod, n_rows, seed):
    """An engine shell of ``mod`` with synthetic per-row metadata (no
    encoder or index): the host-side query helpers alone."""
    rng = np.random.default_rng(seed)
    eng = mod.SessionSearchEngine.__new__(mod.SessionSearchEngine)
    eng._key_to_id = {}
    for name, dt in (("_canon_ids", np.int64), ("_item_flat", np.int64),
                     ("_item_wstan", np.float64), ("_item_lens", np.int64)):
        setattr(eng, name, mod._GrowArr(dt))
    eng._meta_cache = None
    for _ in range(n_rows):
        items = sorted(set(rng.integers(0, 5000, size=rng.integers(1, 12)).tolist()))
        eng._canon_ids.append(eng._key_to_id.setdefault(tuple(items), len(eng._key_to_id)))
        eng._item_flat.extend(items)
        eng._item_wstan.extend(rng.random(len(items)).tolist())
        eng._item_lens.append(len(items))
    return eng, rng


@pytest.mark.parametrize("kind", ["overlap", "stan"])
@pytest.mark.parametrize("fusion", ["score", "rrf"])
def test_hybrid_rerank_on_random_candidates(kind, fusion):
    (t, rng), (j, _) = _bare_engine(t_engine, 400, 7), _bare_engine(j_engine, 400, 7)
    q, m, k = 12, 40, 10
    D2 = np.sort(rng.standard_normal((q, m)).astype(np.float32), axis=1)[:, ::-1].copy()
    gid = np.stack([rng.choice(400, size=m, replace=False) for _ in range(q)]).astype(np.int64)
    gid[:, -3:] = -1  # short rows
    q_w = [{int(i): float(w) for i, w in zip(rng.integers(0, 5000, 5), rng.random(5))}
           for _ in range(q)]
    got = t._hybrid_rerank(D2, gid, q_w, k, 0.3, kind, fusion=fusion)
    want = j._hybrid_rerank(D2, gid, q_w, k, 0.3, kind, fusion=fusion)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_dedup_topk():
    (t, rng), (j, _) = _bare_engine(t_engine, 64, 8), _bare_engine(j_engine, 64, 8)
    for eng in (t, j):  # duplicates: the second half mirrors the first
        for g in range(32, 64):
            eng._canon_ids[g] = eng._canon_ids[g - 32]
    D2 = np.sort(rng.standard_normal((8, 24)).astype(np.float32), axis=1)[:, ::-1].copy()
    gid = np.stack([rng.choice(64, size=24, replace=False) for _ in range(8)]).astype(np.int64)
    for a, b in zip(t._dedup_topk(D2, gid, 6), j._dedup_topk(D2, gid, 6)):
        np.testing.assert_array_equal(a, b)


# --- the jax-free modules the evaluation harness copies (data/augment.py,
# data/etl.py, evalharness/knn.py, index/sparse.py, utils/logging.py)

import json  # noqa: E402

from sessionsimilaritysearch_tpu.data import augment as j_augment  # noqa: E402
from sessionsimilaritysearch_tpu.data import etl as j_etl  # noqa: E402
from sessionsimilaritysearch_tpu.evalharness import knn as j_knn  # noqa: E402
from sessionsimilaritysearch_tpu.index import sparse as j_sparse  # noqa: E402
from sessionsimilaritysearch_tpu.utils import logging as j_logging  # noqa: E402
from sessionsimilaritysearch_tpu_torch.data import augment as t_augment  # noqa: E402
from sessionsimilaritysearch_tpu_torch.data import etl as t_etl  # noqa: E402
from sessionsimilaritysearch_tpu_torch.evalharness import knn as t_knn  # noqa: E402
from sessionsimilaritysearch_tpu_torch.index import sparse as t_sparse  # noqa: E402
from sessionsimilaritysearch_tpu_torch.utils import logging as t_logging  # noqa: E402


@pytest.mark.parametrize("fn", ["random_exchange_order", "random_drop_action",
                                "random_mask_product", "random_perturb_product"])
def test_augment(fn):
    extra = (500,) if fn == "random_perturb_product" else ()
    for seed, datum in enumerate(_sessions(t_data, 30, seed=12)):
        got = getattr(t_augment, fn)(datum, np.random.default_rng(seed), *extra)
        want = getattr(j_augment, fn)(datum, np.random.default_rng(seed), *extra)
        assert got == want


def test_etl_csv_round_trip(tmp_path):
    sessions = [s for s, _ in _sessions(t_data, 25, seed=13)]
    for mod in ("t", "j"):
        etl = t_etl if mod == "t" else j_etl
        etl.decompose_sessions(sessions, str(tmp_path / f"{mod}_a.csv"),
                               str(tmp_path / f"{mod}_c.csv"), id_offset=3)
    for name in ("a", "c"):
        assert (tmp_path / f"t_{name}.csv").read_bytes() == (tmp_path / f"j_{name}.csv").read_bytes()
    got = t_etl.load_sessions_from_csv(str(tmp_path / "t_a.csv"), str(tmp_path / "t_c.csv"))
    want = j_etl.load_sessions_from_csv(str(tmp_path / "t_a.csv"), str(tmp_path / "t_c.csv"))
    assert got == want and len(got[0]) == len(sessions)


def test_etl_pickles_item_sequences_and_splits(tmp_path):
    seqs = [[3, 7, 7, 1], [2], [9, 4]]
    got, want = t_etl.sessions_from_item_sequences(seqs), j_etl.sessions_from_item_sequences(seqs)
    assert got == want
    t_etl.save_sessions(got, str(tmp_path / "s.pkl"))
    assert j_etl.load_sessions(str(tmp_path / "s.pkl")) == t_etl.load_sessions(
        str(tmp_path / "s.pkl")) == want
    sessions = [s for s, _ in _sessions(t_data, 20, seed=14)] + [[]]
    for min_prefix in (1, 2):  # min_prefix 2 needs sessions of 3 or more
        sessions = [s for s in sessions if min_prefix == 1 or len(s) != 2]
        assert (t_etl.split_prefix_future(sessions, np.random.default_rng(1), min_prefix)
                == j_etl.split_prefix_future(sessions, np.random.default_rng(1), min_prefix))


def _knn_case(seed):
    data = _sessions(t_data, 70, seed=seed)
    corpus, test = [s for s, _ in data[:50]], data[50:]
    rng = np.random.default_rng(seed)
    I = rng.integers(-1, 50, (len(test), 12))
    D = np.sort(rng.random((len(test), 12)), axis=1)[:, ::-1].copy()
    return corpus, test, D, I


@pytest.mark.parametrize("seed", [15, 16])
def test_knn(seed):
    corpus, test, D, I = _knn_case(seed)
    for i in range(len(test)):
        got = t_knn.get_prediction_by_knn(D[i], I[i], corpus, 5)
        assert got == j_knn.get_prediction_by_knn(D[i], I[i], corpus, 5)
        gt = t_data.schema.get_item(test[i][1])
        assert t_knn.get_p_r(gt, got, 5) == j_knn.get_p_r(gt, got, 5)
    for K, sample in ((5, 12), (3, 4)):
        assert (t_knn.knn_recommendation_recall(D, I, test, corpus, K, sample)
                == j_knn.knn_recommendation_recall(D, I, test, corpus, K, sample))


@pytest.mark.parametrize("kind", ["binary", "stan"])
def test_sparse(kind):
    data = _sessions(t_data, 60, seed=17)
    corpus, test = [s for s, _ in data[:45]], data[45:]
    for s in corpus[:10] + [[]]:
        np.testing.assert_array_equal(t_sparse.sequence_to_stan_vec(s, 500, 0.8),
                                      j_sparse.sequence_to_stan_vec(s, 500, 0.8))
        np.testing.assert_array_equal(t_sparse.sequence_to_binary_vec(s, 500),
                                      j_sparse.sequence_to_binary_vec(s, 500))
    tc = t_sparse.build_sparse_corpus(corpus, 500, kind=kind, lammy=0.9)
    jc = j_sparse.build_sparse_corpus(corpus, 500, kind=kind, lammy=0.9)
    assert (tc != jc).nnz == 0
    q = np.stack([t_sparse.sequence_to_binary_vec(t[0], 500) for t in test])
    for K in (7, 60):  # 60 > corpus: the (-inf, -1) fill
        for a, b in zip(t_sparse.find_K_sparse_dense(tc, q, K), j_sparse.find_K_sparse_dense(jc, q, K)):
            np.testing.assert_array_equal(a, b)
    _, I = t_sparse.find_K_sparse_dense(tc, q, 60)
    assert (t_sparse.get_STAN_score(I, test, corpus, 500)
            == j_sparse.get_STAN_score(I, test, corpus, 500))


def test_logging(tmp_path):
    cfg = t_config.tiny_test_config()
    for mod, logmod in (("t", t_logging), ("j", j_logging)):
        run = logmod.RunDir(str(tmp_path / mod), config=cfg, name="exp")
        log = logmod.MetricLogger(run.file("metrics.jsonl"), echo=run.logger)
        log.log(1, loss=np.float32(0.5), tag="warm")
        log.log(2, recall=0.25)
        log.close()
    t_rows = t_logging.read_metrics(str(tmp_path / "t" / "metrics.jsonl"))
    j_rows = j_logging.read_metrics(str(tmp_path / "j" / "metrics.jsonl"))
    assert t_rows == j_logging.read_metrics(str(tmp_path / "t" / "metrics.jsonl"))
    for a, b in zip(t_rows, j_rows):  # the same rows but for the clock
        assert {k: v for k, v in a.items() if k != "t"} == {k: v for k, v in b.items() if k != "t"}
    assert len(t_rows) == 2 and t_rows[0]["tag"] == "warm"
    for name in ("config.json", "exp.log"):
        assert (tmp_path / "t" / name).exists() and (tmp_path / "j" / name).exists()
    assert (json.loads((tmp_path / "t" / "config.json").read_text())
            == json.loads((tmp_path / "j" / "config.json").read_text()))
