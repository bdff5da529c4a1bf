"""The port's 100k-session index build
(``sessionsimilaritysearch_tpu_torch.examples.index_build_100k``): its
``--tiny`` run reaches self-recall@1 1.0 and every top-1 score at the
self-cosine, as JAX's does, with JAX's report keys (``embed_compile_s`` ->
``embed_first_batch_s``); and its serve half (:func:`serve`: bf16 serving
weights -> the uncached forward -> the f32 'cos' ``DenseIndex`` -> search),
on weights carried from a JAX tiny subsession state through ``weights.py``,
gives the top-1 ids of the JAX package's own serve half on the same
sessions (computed with its functions, not its script)."""

import jax
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.config import tiny_test_config as jax_tiny_config
from sessionsimilaritysearch_tpu.data import SyntheticSessionGenerator as JaxGenerator
from sessionsimilaritysearch_tpu.data.loader import SessionGraphLoader as JaxLoader
from sessionsimilaritysearch_tpu.evalharness.harness import EmbeddingPipeline as JaxPipeline
from sessionsimilaritysearch_tpu.index.dense import DenseIndex as JaxDenseIndex
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer as jax_tokenizer
from sessionsimilaritysearch_tpu.training.loop import to_device as jax_to_device
from sessionsimilaritysearch_tpu.training.session_trainers import (
    create_session_state as jax_session_state,
)
from sessionsimilaritysearch_tpu.utils.precision import serving_params as jax_serving_params
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config
from sessionsimilaritysearch_tpu_torch.examples import index_build_100k
from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu_torch.training.session_trainers import create_session_state
from sessionsimilaritysearch_tpu_torch.weights import flax_to_state_dict

SESSIONS, QUERIES, K, EMBED_BATCH = 384, 32, 10, 64
JAX_KEYS = ["sessions", "gen_s", "train_s", "embed_s", "embed_compile_s",
            "embed_sessions_per_s", "index_build_s", "search_s", "qps", "self_recall_at_1",
            "top1_score_at_self_cos"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small tensors through many ops: one intra-op thread per suite worker
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny_report():
    return index_build_100k.main(["--device", "cpu", "--tiny"])


def test_tiny_run_self_recall(tiny_report):
    assert tiny_report["self_recall_at_1"] == 1.0
    assert tiny_report["top1_score_at_self_cos"] == 1.0
    assert tiny_report["sessions"] == 512


def test_tiny_run_keys(tiny_report):
    assert list(tiny_report) == [
        "embed_first_batch_s" if k == "embed_compile_s" else k for k in JAX_KEYS]
    assert all(np.isfinite(v) for v in tiny_report.values())


@pytest.fixture(scope="module")
def carried():
    """A JAX tiny subsession state (its init), the JAX package's serve half
    on it, and the port's model carrying the same weights."""
    cfg = jax_tiny_config()
    tok = jax_tokenizer(cfg.vocab_size)
    data = JaxGenerator(asin_num=cfg.asin_num, seed=0).dataset(SESSIONS)
    loader = JaxLoader(data[:EMBED_BATCH], tok, cfg.dims, EMBED_BATCH, seed=0)
    sample = jax_to_device(next(iter(loader)))
    model, state = jax_session_state(cfg, jax.random.PRNGKey(0), sample, mode="subsession")
    # index_build_100k.py:94-124: bf16 serving weights, the uncached encode,
    # the default f32 'cos' index, the first QUERIES rows as queries
    variables = {"params": jax_serving_params(state.params)}
    if state.batch_stats is not None:
        variables["batch_stats"] = state.batch_stats
    encode = jax.jit(lambda g: model.apply(variables, g, method="encode"))
    emb = JaxPipeline(cfg, tok, encode, batch_size=EMBED_BATCH)([d[0] for d in data])
    index = JaxDenseIndex(dim=emb.shape[1], capacity=SESSIONS, metric="cos")
    index.add(emb)
    D, I = index.search(emb[:QUERIES], K)

    tcfg = tiny_test_config()
    tmodel, _ = create_session_state(tcfg, "cpu", mode="subsession")
    tmodel.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, state.params),
        None if state.batch_stats is None else jax.tree.map(np.asarray, state.batch_stats)),
        strict=True)
    return {"cfg": tcfg, "data": data, "model": tmodel, "D": np.asarray(D),
            "I": np.asarray(I)}


def test_serve_gives_jax_top1_on_carried_weights(carried):
    c = carried
    keep = {}
    r = index_build_100k.serve(c["cfg"], get_tokenizer(c["cfg"].vocab_size),
                               c["model"].encoder, c["data"], QUERIES, K, EMBED_BATCH, "cpu",
                               keep=keep)
    np.testing.assert_array_equal(r["I"][:, 0], c["I"][:, 0])
    np.testing.assert_allclose(r["D"][:, 0], c["D"][:, 0], atol=1e-4)
    assert r["I"].shape == (QUERIES, K) and keep["index"].ntotal == SESSIONS
    assert keep["index"].dtype == torch.float32  # the default f32 index


def test_serve_self_recall_on_carried_weights(carried):
    # JAX's serve half on its own weights reaches self-recall@1; the port's
    # reaches it on the same weights
    c = carried
    assert (c["I"][:, 0] == np.arange(QUERIES)).all()
    r = index_build_100k.serve(c["cfg"], get_tokenizer(c["cfg"].vocab_size),
                               c["model"].encoder, c["data"], QUERIES, K, EMBED_BATCH, "cpu")
    assert (r["I"][:, 0] == np.arange(QUERIES)).all()
    assert (r["D"][:, 0] >= 1.0 - 1e-4).all()
