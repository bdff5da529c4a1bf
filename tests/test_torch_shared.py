"""The port's copies of the JAX package's jax-free modules (config,
tokenizer, data, native, evalharness.metrics) held against the originals:
the same fields, token ids, synthetic sessions, graph arrays, metrics and
native graph batches. The port imports none of the originals
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
