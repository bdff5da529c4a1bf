"""The port's three-pairing kNN protocol
(``sessionsimilaritysearch_tpu_torch.examples.knn_pairings``) against the
JAX script, run in this process at a tiny size (the clustered regime, joint
towers, 256 corpus sessions, 128 training sessions, 16 queries, one epoch,
widths 32 / 32 / 32 / 16).

The JAX script runs with ``session_trainers.make_joint_train_step`` (its
function-local import) wrapped to record the trained joint state and
``harness.run_dense_search`` each pairing's embeddings and search; the port
then runs at ``--epochs 0`` with its ``create_joint_state`` loading JAX's
trained state (``weights.load_flax_train_state``). Both serve the towers in
bf16 ``serving_params``.

Held: each pairing's embeddings at cosine >= 0.999 per row (bf16); each
pairing's top-``sample_size`` ids equal but for candidates within twice the
largest |port - JAX| score of their side's last score (counted); each
recall within ``RECALL_TOL`` (the swaps and the bf16 weights move the
pooled item scores); the JSON line's keys, ``--out``, and the losses
``nan`` where no step ran; ``--towers independent`` on the port alone;
the default device raises here."""

import contextlib
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import examples.knn_pairings as jax_knn  # noqa: E402
import sessionsimilaritysearch_tpu.evalharness.harness as jax_harness  # noqa: E402
import sessionsimilaritysearch_tpu.training.session_trainers as jax_st  # noqa: E402
from sessionsimilaritysearch_tpu_torch.examples import knn_pairings  # noqa: E402
from sessionsimilaritysearch_tpu_torch.weights import load_flax_train_state  # noqa: E402

ARGS = ["--regimes", "clustered", "--corpus", "256", "--train", "128", "--queries", "16",
        "--sample-size", "64", "--asins", "1000", "--gnn-nout", "32", "--gnn-nhid", "32",
        "--emb-len", "16", "--text-dim", "32"]
PAIRINGS = ("subsession_session", "subsession_subsession", "session_session")
BF16_COS = 0.999  # bf16 serving forward: each row's cosine to JAX's
RECALL_TOL = 0.05
JSON_KEYS = ["K", "recall_subsession_session", "recall_subsession_subsession",
             "recall_session_session", "regime", "towers", "corpus", "train", "queries",
             "epochs", "train_s_subsession", "train_s_session", "final_loss_subsession",
             "final_loss_session", "eval_s", "final_ctv_loss"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small tensors through many ops: one intra-op thread per suite worker
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("knn")
    rec = {"searches": []}
    mp = pytest.MonkeyPatch()

    def make_joint_train_step(*a, **kw):
        step = orig_step(*a, **kw)

        def recorded(*sa, **skw):
            out = step(*sa, **skw)
            rec["state"] = out[0]
            return out
        return recorded

    def run_dense_search(corpus_emb, query_emb, k, *a, **kw):
        out = orig_search(corpus_emb, query_emb, k, *a, **kw)
        rec["searches"].append({"db": np.asarray(corpus_emb), "queries": np.asarray(query_emb),
                                "D": np.asarray(out[0]), "I": np.asarray(out[1])})
        return out

    orig_step, orig_search = jax_st.make_joint_train_step, jax_harness.run_dense_search
    mp.setattr(jax_st, "make_joint_train_step", make_joint_train_step)
    mp.setattr(jax_harness, "run_dense_search", run_dense_search)
    mp.setattr(sys, "argv", ["knn_pairings.py", *ARGS, "--epochs", "1",
                             "--out", str(d / "jax.json")])
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            jax_knn.main()
    finally:
        mp.undo()
    s = rec.pop("state")
    tree = jax.tree.map(np.asarray, {"step": s.step, "params": s.params,
                                     "batch_stats": s.batch_stats})
    with open(d / "jax.json") as f:
        jax_out = json.load(f)

    orig_create = knn_pairings.create_joint_state

    def create_joint_state(*a, **kw):
        model, state = orig_create(*a, **kw)
        load_flax_train_state(state, tree)
        return model, state

    mp.setattr(knn_pairings, "create_joint_state", create_joint_state)
    keep, pbuf = {}, io.StringIO()
    try:
        with contextlib.redirect_stdout(pbuf):
            report = knn_pairings.main(["--device", "cpu", *ARGS, "--epochs", "0",
                                        "--out", str(d / "port.json")], keep=keep)
    finally:
        mp.undo()
    with open(d / "port.json") as f:
        port_out = json.load(f)
    return {"jax": rec, "jax_out": jax_out, "jax_stdout": buf.getvalue(), "report": report,
            "keep": keep["clustered"], "port_out": port_out, "stdout": pbuf.getvalue()}


def _unit(a):
    a = np.asarray(a, np.float64)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_embeddings_within_bf16(runs, pairing):
    got, want = runs["keep"][pairing], runs["jax"]["searches"][PAIRINGS.index(pairing)]
    for key in ("db", "queries"):
        g, w = got[key].float().numpy(), want[key]
        assert g.shape == w.shape
        cos = (_unit(g) * _unit(w)).sum(1)
        assert cos.min() >= BF16_COS, (key, cos.min())


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_searches_within_ties(runs, pairing):
    got, want = runs["keep"][pairing], runs["jax"]["searches"][PAIRINGS.index(pairing)]
    delta = np.abs(_unit(got["queries"].float().numpy()) @ _unit(got["db"].float().numpy()).T
                   - _unit(want["queries"]) @ _unit(want["db"]).T).max()
    tol = 2 * float(delta) + 1e-6
    swaps = 0
    for q in range(len(want["I"])):
        for D, I, other in ((want["D"], want["I"], got["I"]), (got["D"], got["I"], want["I"])):
            for pos in np.nonzero(~np.isin(I[q], other[q]))[0]:
                assert abs(D[q, pos] - D[q, -1]) <= tol, (q, pos, D[q, pos], D[q, -1], tol)
                swaps += 1
    assert got["I"].shape == want["I"].shape == (16, 64)
    # the count the tolerance explains: at most a quarter of the candidates
    assert swaps // 2 <= got["I"].size // 4, swaps


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_recalls_within_tolerance(runs, pairing):
    got = runs["report"]["clustered"][f"recall_{pairing}"]
    want = runs["jax_out"]["clustered"][f"recall_{pairing}"]
    assert abs(got - want) <= RECALL_TOL, (got, want)


def test_json_line_and_out(runs):
    line = json.loads(runs["stdout"].strip().splitlines()[-1])
    jline = json.loads(runs["jax_stdout"].strip().splitlines()[-1])
    assert list(line) == list(jline) == JSON_KEYS
    assert list(runs["port_out"]) == list(runs["jax_out"]) == ["clustered"]
    assert list(runs["port_out"]["clustered"]) == JSON_KEYS
    assert runs["report"]["clustered"]["K"] == jline["K"] == 20
    for key in ("regime", "towers", "corpus", "train", "queries"):
        assert line[key] == jline[key]
    assert line["epochs"] == 0
    # no step ran: the losses are nan (JSON NaN), the times finite
    for key in ("final_loss_subsession", "final_loss_session", "final_ctv_loss"):
        assert np.isnan(line[key]) and np.isfinite(jline[key])


def test_independent_towers_port():
    report = knn_pairings.main(["--device", "cpu", *ARGS, "--epochs", "1",
                                "--towers", "independent"])
    out = report["clustered"]
    assert list(out) == JSON_KEYS[:-1] and out["towers"] == "independent"
    for pairing in PAIRINGS:
        assert 0.0 <= out[f"recall_{pairing}"] <= 1.0
    assert np.isfinite(out["final_loss_subsession"]) and np.isfinite(out["final_loss_session"])


def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="cuda"):
        knn_pairings.main(ARGS)
