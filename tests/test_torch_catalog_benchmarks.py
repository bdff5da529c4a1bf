"""The port's out-of-catalog and in-catalog benchmarks
(``sessionsimilaritysearch_tpu_torch.examples.generalization_benchmark`` and
``incatalog_benchmark``) against the JAX scripts, run in this process at a
tiny size (128 corpus sessions, 16 queries, one epoch).

Each JAX script runs with its ``create_train_state`` and
``make_train_step`` wrapped to record its initial and trained states; the
port then runs at ``--epochs 0`` twice, its ``create_pretrain_state``
loading JAX's initial state (the ``untrained`` row) and then JAX's trained
state (the ``trained`` row) through ``weights.load_flax_train_state``.

Held: the sessions (the same corpus and queries, the catalog halves
disjoint); SKNN and STAN exactly equal; the embeddings within 1e-5 of their
scale (f32 on both sides); each dense or hybrid top-10 equal to JAX's but
where two candidates lie within ``TIE`` of the 10th score (counted), and
each encoder-derived row then within the bound those swaps allow (a swap
moves one query's mean by at most 1/10); the printed lines JAX's (numbers
aside) and the returned keys; ``--device`` defaulting to the card, which
raises here."""

import contextlib
import io
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import examples.generalization_benchmark as jax_gen  # noqa: E402
import examples.incatalog_benchmark as jax_inc  # noqa: E402
from sessionsimilaritysearch_tpu_torch.examples import (  # noqa: E402
    generalization_benchmark,
    incatalog_benchmark,
)
from sessionsimilaritysearch_tpu_torch.weights import load_flax_train_state  # noqa: E402

ARGS = ["--epochs", "1", "--corpus", "128", "--queries", "16"]
K = 10
EMB_REL = 1e-5  # |port - JAX| embedding, of the largest |JAX| entry
TIE = 1e-5  # two f32 cosines this close may swap places at the 10th
SCRIPTS = {"generalization_benchmark": (jax_gen, generalization_benchmark),
           "incatalog_benchmark": (jax_inc, incatalog_benchmark)}
DENSE_TAGS = {"generalization_benchmark": ("untrained", "trained"),
              "incatalog_benchmark": ("encoder untrained", "encoder trained")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small tensors through many ops: one intra-op thread per suite worker
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(state):
    return jax.tree.map(np.asarray, {"step": state.step, "params": state.params,
                                     "batch_stats": state.batch_stats})


def _run_jax(mod):
    """The JAX script's main() on ARGS: its stdout, its states (initial,
    trained), every dense search (ce, qe, D, I), every sparse and hybrid
    result, and the sessions its scores were taken on."""
    rec = {"states": [], "dense": [], "sparse": [], "hybrid": [], "data": []}
    mp = pytest.MonkeyPatch()

    def create_train_state(*a, **kw):
        s = orig_create(*a, **kw)
        rec["states"].append(_tree(s))
        return s

    def make_train_step(*a, **kw):
        step = orig_step(*a, **kw)

        def recorded(*sa, **skw):
            out = step(*sa, **skw)
            rec["trained"] = out[0]
            return out
        return recorded

    def build_index(ce, metric):
        idx = orig_build(ce, metric=metric)
        search = idx.search

        def recorded(qe, k):
            D, I = search(qe, k)
            rec["dense"].append({"ce": np.asarray(ce), "qe": np.asarray(qe),
                                 "D": np.asarray(D), "I": np.asarray(I)})
            return D, I
        idx.search = recorded
        return idx

    def get_ave_score(I, test_data, train_data, sim):
        rec["data"].append((test_data, train_data))
        return orig_score(I, test_data, train_data, sim)

    def recorder(key, fn):
        def wrapped(*a, **kw):
            res = fn(*a, **kw)
            rec[key].append(res)
            return res
        return wrapped

    orig_create, orig_step = mod.create_train_state, mod.make_train_step
    orig_build, orig_score = mod.build_index, mod.get_ave_score
    mp.setattr(mod, "create_train_state", create_train_state)
    mp.setattr(mod, "make_train_step", make_train_step)
    mp.setattr(mod, "build_index", build_index)
    mp.setattr(mod, "get_ave_score", get_ave_score)
    mp.setattr(mod, "evaluate_sparse", recorder("sparse", mod.evaluate_sparse))
    if hasattr(mod, "evaluate_hybrid"):
        mp.setattr(mod, "evaluate_hybrid", recorder("hybrid", mod.evaluate_hybrid))
    mp.setattr(sys, "argv", [mod.__file__, *ARGS])
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        mp.undo()
    rec["states"].append(_tree(rec.pop("trained")))
    rec["stdout"] = buf.getvalue()
    return rec


def _run_port(mod, tree, argv):
    """The port's main(argv) with its pretrain state carrying ``tree``;
    returns (report, keep, stdout)."""
    mp = pytest.MonkeyPatch()
    orig = mod.create_pretrain_state

    def create_pretrain_state(cfg, dev, generator=None):
        model, state = orig(cfg, dev, generator)
        load_flax_train_state(state, tree)
        return model, state

    mp.setattr(mod, "create_pretrain_state", create_pretrain_state)
    keep, buf = {}, io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            report = mod.main(argv, keep=keep)
    finally:
        mp.undo()
    return report, keep, buf.getvalue()


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, (jmod, pmod) in SCRIPTS.items():
        j = _run_jax(jmod)
        argv = ["--device", "cpu", "--epochs", "0", *ARGS[2:]]
        untrained = _run_port(pmod, j["states"][0], argv)
        trained = _run_port(pmod, j["states"][-1], argv)
        out[name] = {"jax": j, "untrained": untrained, "trained": trained}
    return out


def _same_sessions(a, b) -> bool:
    return len(a) == len(b) and all(
        [tuple(x) for x in s] == [tuple(y) for y in t] for s, t in zip(a, b))


def _tie_swaps(D_port, I_port, D_jax, I_jax, tol) -> int:
    """Number of ids in one top-k and not the other, summed over queries;
    every such id must score within ``tol`` of its own side's k-th score."""
    swaps = 0
    for q in range(len(I_jax)):
        for D, I, other in ((D_jax, I_jax, I_port), (D_port, I_port, I_jax)):
            for pos in np.nonzero(~np.isin(I[q], other[q]))[0]:
                assert abs(D[q, pos] - D[q, -1]) <= tol, (q, pos, D[q, pos], D[q, -1])
                swaps += 1
    return swaps // 2


@pytest.mark.parametrize("name", SCRIPTS)
def test_sessions_equal_jax(runs, name):
    r = runs[name]
    test_data, corpus = r["jax"]["data"][0]
    for which in ("untrained", "trained"):
        keep = r[which][1]
        assert _same_sessions([d[0] for d in keep["corpus"]], corpus)
        assert _same_sessions([d[0] for d in keep["test"]], [d[0] for d in test_data])
        assert _same_sessions([d[1] for d in keep["test"]], [d[1] for d in test_data])
    assert len(corpus) == 128 and len(test_data) == 16
    if name == "generalization_benchmark":
        c_items = {a[-1] for s in corpus for a in s if a[1] != "s"}
        q_items = {a[-1] for d in test_data for a in list(d[0]) + list(d[1]) if a[1] != "s"}
        assert c_items and q_items and not (c_items & q_items)
        assert max(c_items) < 800 <= min(q_items)


@pytest.mark.parametrize("name", SCRIPTS)
@pytest.mark.parametrize("system", ["SKNN", "STAN"])
def test_sparse_rows_exactly_jax(runs, name, system):
    r = runs[name]
    jax_value = r["jax"]["sparse"][0 if system == "SKNN" else 1].report[
        "ave_all_product_type_score"]
    for which in ("untrained", "trained"):
        assert r[which][0][system] == jax_value


@pytest.mark.parametrize("name", SCRIPTS)
@pytest.mark.parametrize("which", ["untrained", "trained"])
def test_embeddings_within_f32(runs, name, which):
    r = runs[name]
    j = r["jax"]["dense"][0 if which == "untrained" else 1]
    p = r[which][1]["dense"][0]
    scale = np.abs(j["qe"]).max()
    np.testing.assert_allclose(p["queries"], j["qe"], rtol=0, atol=EMB_REL * scale)
    rows = p["index"].reconstruct_batch(range(p["index"].ntotal))
    cn = j["ce"] / np.linalg.norm(j["ce"], axis=1, keepdims=True)
    np.testing.assert_allclose(rows, cn, rtol=0, atol=EMB_REL)


@pytest.mark.parametrize("name", SCRIPTS)
@pytest.mark.parametrize("which", ["untrained", "trained"])
def test_dense_rows_within_ties(runs, name, which):
    r = runs[name]
    j = r["jax"]["dense"][0 if which == "untrained" else 1]
    p = r[which][1]["dense"][0]
    D_port, I_port = p["index"].search(p["queries"], K)
    assert np.array_equal(I_port, p["ids"])
    swaps = _tie_swaps(D_port, I_port, j["D"], j["I"], TIE)
    tag = DENSE_TAGS[name][0 if which == "untrained" else 1]
    jax_value = float(re.search(rf"^{tag}: ave type score@10 = ([0-9.]+)$",
                                r["jax"]["stdout"], re.M).group(1))
    # the JAX line prints 3 decimals; the swaps bound the rest
    bound = swaps / (K * len(I_port)) + 5e-4
    assert abs(r[which][0][tag] - jax_value) <= bound, (swaps, r[which][0][tag], jax_value)


def test_hybrid_row_within_ties(runs):
    r = runs["incatalog_benchmark"]
    j = r["jax"]["hybrid"][0]
    port_value = r["trained"][0]["hybrid"]
    keep = r["trained"][1]
    swaps = _tie_swaps(keep["hybrid_D"], keep["hybrid_ids"], j.D, j.I, TIE)
    jax_value = j.report["ave_all_product_type_score"]
    assert abs(port_value - jax_value) <= swaps / (K * len(j.I)) + 1e-7


@pytest.mark.parametrize("name", SCRIPTS)
def test_printed_lines_and_keys(runs, name):
    r = runs[name]

    def shape(text):
        return [re.sub(r"-?[0-9]+(\.[0-9]+)?|nan", "#", line) for line in text.splitlines()]

    jax_lines = shape(r["jax"]["stdout"])
    port_lines = shape(r["trained"][2])
    assert port_lines == jax_lines
    report = r["trained"][0]
    assert report["epochs"] == 0 and np.isnan(report["loss"])  # no step ran
    keys = {"generalization_benchmark": ["corpus", "queries", "untrained", "epochs",
                                         "train_s", "loss", "trained", "SKNN", "STAN"],
            "incatalog_benchmark": ["encoder untrained", "epochs", "train_s", "loss",
                                    "encoder trained", "SKNN", "STAN", "hybrid", "alpha"]}
    assert list(report) == keys[name]
    for key in keys[name]:
        assert key in ("loss",) or np.isfinite(report[key])
    assert "loss nan" in r["trained"][2]


@pytest.mark.parametrize("name", SCRIPTS)
def test_default_device_is_the_card(name):
    with pytest.raises(RuntimeError, match="cuda"):
        SCRIPTS[name][1].main(ARGS)
