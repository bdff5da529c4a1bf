"""The port's multi-seed quality protocol
(``sessionsimilaritysearch_tpu_torch.examples.quality_protocol``) against
the JAX script, run in this process at a tiny size, in two configurations:
the pretrain encoder on seed 3 (``--seed-base 3``) with ``--alpha-sweep``
and ``--disjoint``, and the flagship encoder (bf16 ``serving_params``) with
``--pooling recency --regime adversarial`` over one seed.

The JAX script runs with ``make_train_step`` (pretrain) or
``session_trainers.make_session_train_step`` (flagship) wrapped to record
each seed's trained state, ``build_index`` to record each seed's
embeddings and dense search, and ``run_seed`` its scores
(``jax.clear_caches`` is a no-op here).
The port then runs at ``--epochs 0``, its ``create_pretrain_state`` /
``create_session_state`` loading the seed's trained JAX state.

Held: the sessions equal (the catalog halves disjoint); SKNN and STAN
exactly equal; the port's scoring (:func:`score_systems`) on JAX's
embeddings gives every host row of JAX's exactly, and the dense row but
for candidates within 1e-5 of the 10th score; the embeddings within 1e-5 of
their scale (f32), or at cosine >= 0.999 per row (bf16, the flagship
forward's bound elsewhere in the suite); each encoder-derived top-10
equal to the reference's but where a candidate lies within the tie
tolerance of its side's 10th score (f32: 1e-5; bf16: twice the largest
|port - JAX| dense score), those swaps counted, and each row then within
the bound they allow (a swap moves one query's mean by at most 1/10); the
printed lines (numbers aside), the ``--out`` keys (``platform`` ->
``device``); the default device raises here."""

import contextlib
import io
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import examples.quality_protocol as jax_qp  # noqa: E402
import sessionsimilaritysearch_tpu.training.session_trainers as jax_st  # noqa: E402
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config  # noqa: E402
from sessionsimilaritysearch_tpu_torch.examples import quality_protocol  # noqa: E402
from sessionsimilaritysearch_tpu_torch.weights import load_flax_train_state  # noqa: E402

K = 10
SIZE = ["--corpus", "96", "--train", "64", "--queries", "12", "--asins", "400"]
CONFIGS = {
    "pretrain": [*SIZE, "--seeds", "1", "--seed-base", "3", "--alpha-sweep", "0.3",
                 "--disjoint"],
    "flagship": [*SIZE, "--seeds", "1", "--encoder", "flagship", "--pooling", "recency",
                 "--regime", "adversarial"],
}
EMB_REL = 1e-5  # f32: |port - JAX| embedding, of the largest |JAX| entry
BF16_COS = 0.999  # bf16 serving forward: each row's cosine to JAX's
TIE_F32 = 1e-5
SYSTEMS = ["encoder", "SKNN", "STAN", "hybrid", "hybrid_stan", "rrf_sknn", "rrf_stan"]


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


def _run_jax(argv, out_path):
    """JAX's main() on ``argv`` + one epoch: per seed its trained state,
    dense search (ce, qe, D, I), scores and sessions; its stdout and --out."""
    rec = {"states": [], "dense": [], "scores": [], "data": []}
    mp = pytest.MonkeyPatch()

    def stepper(orig):
        def make(*a, **kw):
            step = orig(*a, **kw)
            rec["states"].append(None)

            def recorded(*sa, **skw):
                out = step(*sa, **skw)
                rec["states"][-1] = out[0]
                return out
            return recorded
        return make

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

    def evaluate_sparse(cfg, corpus_sessions, test_data, **kw):
        if kw["kind"] == "binary":
            rec["data"].append((corpus_sessions, test_data))
        return orig_sparse(cfg, corpus_sessions, test_data, **kw)

    def run_seed(seed, args):
        scores = orig_run(seed, args)
        rec["scores"].append(scores)
        return scores

    orig_build, orig_sparse, orig_run = jax_qp.build_index, jax_qp.evaluate_sparse, jax_qp.run_seed
    mp.setattr(jax_qp, "make_train_step", stepper(jax_qp.make_train_step))
    mp.setattr(jax_st, "make_session_train_step", stepper(jax_st.make_session_train_step))
    mp.setattr(jax_qp, "build_index", build_index)
    mp.setattr(jax_qp, "evaluate_sparse", evaluate_sparse)
    mp.setattr(jax_qp, "run_seed", run_seed)
    mp.setattr(jax, "clear_caches", lambda: None)
    mp.setattr(sys, "argv", ["quality_protocol.py", *argv, "--epochs", "1", "--out", out_path])
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            jax_qp.main()
    finally:
        mp.undo()
    rec["trees"] = [_tree(s) for s in rec.pop("states")]
    rec["stdout"] = buf.getvalue()
    with open(out_path) as f:
        rec["out"] = json.load(f)
    return rec


def _run_port(argv, trees, out_path):
    """The port's main(argv --epochs 0) with each seed's state carrying that
    seed's JAX tree (the seed read from the generator)."""
    mp = pytest.MonkeyPatch()
    seed_base = int(argv[argv.index("--seed-base") + 1]) if "--seed-base" in argv else 0

    def carrying(orig):
        def create(cfg, dev, *a, **kw):
            model, state = orig(cfg, dev, *a, **kw)
            generator = kw["generator"] if "generator" in kw else a[0]
            load_flax_train_state(state, trees[generator.initial_seed() - seed_base])
            return model, state
        return create

    mp.setattr(quality_protocol, "create_pretrain_state",
               carrying(quality_protocol.create_pretrain_state))
    mp.setattr(quality_protocol, "create_session_state",
               carrying(quality_protocol.create_session_state))
    keep, buf = {}, io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            report = quality_protocol.main(
                ["--device", "cpu", *argv, "--epochs", "0", "--out", out_path], keep=keep)
    finally:
        mp.undo()
    with open(out_path) as f:
        written = json.load(f)
    return report, keep, buf.getvalue(), written


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("qp")
    out = {}
    for name, argv in CONFIGS.items():
        j = _run_jax(argv, str(d / f"jax_{name}.json"))
        p = _run_port(argv, j["trees"], str(d / f"port_{name}.json"))
        out[name] = {"jax": j, "port": p}
    return out


def _same_sessions(a, b) -> bool:
    return len(a) == len(b) and all(
        [tuple(x) for x in s] == [tuple(y) for y in t] for s, t in zip(a, b))


def _tie_swaps(D_port, I_port, D_ref, I_ref, tol) -> int:
    """Ids in one top-k and not the other, summed over queries; each must
    score within ``tol`` of its own side's k-th score."""
    swaps = 0
    for q in range(len(I_ref)):
        for D, I, other in ((D_ref, I_ref, I_port), (D_port, I_port, I_ref)):
            for pos in np.nonzero(~np.isin(I[q], other[q]))[0]:
                assert abs(D[q, pos] - D[q, -1]) <= tol, (q, pos, D[q, pos], D[q, -1])
                swaps += 1
    return swaps // 2


def _reference(j, seed, argv_alpha_sweep):
    """The port's scoring on JAX's embeddings of one seed: (scores, tops)."""
    ce, qe = j["dense"][seed]["ce"], j["dense"][seed]["qe"]
    corpus, test = j["data"][seed]
    cfg = tiny_test_config(asin_num=400)
    keep = {}
    scores = quality_protocol.score_systems(cfg, ce, qe, test, corpus, 0.5, argv_alpha_sweep,
                                            "cpu", keep=keep)
    return scores, keep["tops"]


def _sweep(name):
    return [0.3] if name == "pretrain" else []


@pytest.mark.parametrize("name", CONFIGS)
def test_sessions_equal_jax(runs, name):
    r = runs[name]
    seeds = r["port"][1]["seeds"]
    assert len(seeds) == len(r["jax"]["data"]) == 1
    for kept, (corpus, test) in zip(seeds, r["jax"]["data"]):
        assert _same_sessions([d[0] for d in kept["corpus"]], corpus)
        assert _same_sessions([d[0] for d in kept["test"]], [d[0] for d in test])
        assert len(corpus) == 96 and len(test) == 12
        if name == "pretrain":  # --disjoint: the catalog halves [0, 200), [200, 400)
            c_items = {a[-1] for s in corpus for a in s if a[1] != "s"}
            q_items = {a[-1] for d in test for a in list(d[0]) + list(d[1]) if a[1] != "s"}
            assert max(c_items) < 200 <= min(q_items)


@pytest.mark.parametrize("name", CONFIGS)
def test_sparse_rows_exactly_jax(runs, name):
    r = runs[name]
    for seed, jscores in enumerate(r["jax"]["scores"]):
        pscores = r["port"][0]["systems"]
        for system in ("SKNN", "STAN"):
            assert pscores[system]["per_seed"][seed] == round(float(jscores[system]), 4)
            assert quality_protocol_scores(r, seed)[system] == jscores[system]


def quality_protocol_scores(r, seed):
    """The port run's unrounded scores of one seed."""
    return r["port"][1]["seeds"][seed]["scores"]


@pytest.mark.parametrize("name", CONFIGS)
def test_scoring_on_jax_embeddings_gives_jax_rows(runs, name):
    # the host rows (SKNN, STAN, the fusions) are numpy on the same arrays:
    # exactly JAX's; the dense row is K1's plain f32 version against JAX's
    # index, whose scores may order two candidates within rounding of the
    # 10th differently (counted, and the row held to the bound they allow)
    r = runs[name]
    for seed, jscores in enumerate(r["jax"]["scores"]):
        scores, tops = _reference(r["jax"], seed, _sweep(name))
        assert list(scores) == list(jscores)
        for system, value in jscores.items():
            if system != "encoder":
                assert scores[system] == value, (system, scores[system], value)
        j = r["jax"]["dense"][seed]
        I, D = tops["encoder"]
        swaps = _tie_swaps(D, I, j["D"], j["I"], TIE_F32)
        assert abs(scores["encoder"] - jscores["encoder"]) <= swaps / (K * len(I)) + 1e-7


@pytest.mark.parametrize("name", CONFIGS)
def test_embeddings_within_tolerance(runs, name):
    r = runs[name]
    for seed, kept in enumerate(r["port"][1]["seeds"]):
        j = r["jax"]["dense"][seed]
        for got, want in ((kept["ce"], j["ce"]), (kept["qe"], j["qe"])):
            assert got.dtype == np.float32 and got.shape == want.shape
            if name == "pretrain":
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=EMB_REL * np.abs(want).max())
            else:
                cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                             * np.linalg.norm(want, axis=1))
                assert cos.min() >= BF16_COS, cos.min()


@pytest.mark.parametrize("name", CONFIGS)
def test_encoder_rows_within_ties(runs, name):
    r = runs[name]
    counts = {}
    for seed, kept in enumerate(r["port"][1]["seeds"]):
        j = r["jax"]["dense"][seed]
        if name == "pretrain":
            tol = TIE_F32
        else:
            def unit(a):
                return a / np.linalg.norm(a, axis=1, keepdims=True)
            delta = np.abs(unit(kept["qe"]) @ unit(kept["ce"]).T
                           - unit(j["qe"]) @ unit(j["ce"]).T).max()
            tol = 2 * float(delta) + 1e-6
        ref_scores, ref_tops = _reference(r["jax"], seed, _sweep(name))
        mine = quality_protocol_scores(r, seed)
        for system, (I_ref, D_ref) in ref_tops.items():
            I_port, D_port = kept["tops"][system]
            if system.startswith("rrf"):
                # rank fusion: a dense near-tie swaps two ranks anywhere in
                # the row, so the fused values move by up to 1/60 - 1/61;
                # its swaps are bounded below, not tie-checked
                swaps = sum(len(set(a) - set(b)) for a, b in zip(I_port, I_ref))
            else:
                swaps = _tie_swaps(D_port, I_port, D_ref, I_ref, tol)
            counts[(seed, system)] = swaps
            bound = swaps / (K * len(I_ref)) + 1e-7
            assert abs(mine[system] - ref_scores[system]) <= bound, (system, swaps)


@pytest.mark.parametrize("name", CONFIGS)
def test_summary_from_per_seed_scores(runs, name):
    r = runs[name]
    report, written = r["port"][0], r["port"][3]
    assert json.dumps(report, sort_keys=True) == json.dumps(written, sort_keys=True)
    for seed in range(len(r["port"][1]["seeds"])):
        mine = quality_protocol_scores(r, seed)
        for system, value in mine.items():
            assert report["systems"][system]["per_seed"][seed] == round(float(value), 4)
    for system, s in report["systems"].items():
        vs = np.asarray([quality_protocol_scores(r, i)[system]
                         for i in range(len(s["per_seed"]))])
        assert s["mean"] == pytest.approx(float(vs.mean()), abs=1e-12)


@pytest.mark.parametrize("name", CONFIGS)
def test_out_keys_and_printed_lines(runs, name):
    r = runs[name]
    jout, pout = r["jax"]["out"], r["port"][3]
    assert list(pout) == list(jout) == ["args", "systems"]
    assert [("platform" if k == "device" else k) for k in pout["args"]] == list(jout["args"])
    assert pout["args"]["device"] == "cpu" and pout["args"]["epochs"] == 0
    assert list(pout["systems"]) == list(jout["systems"])
    for system in pout["systems"]:
        assert list(pout["systems"][system]) == ["mean", "std", "per_seed"]
    expected = SYSTEMS[:5] + (["hybrid[a=0.3]", "hybrid_stan[a=0.3]"]
                              if name == "pretrain" else []) + SYSTEMS[5:]
    assert list(pout["systems"]) == expected

    def shape(text):
        # numbers (and numpy's per-seed arrays' padding) aside
        lines = [re.sub(r"-?[0-9]+(\.[0-9]+)?(e-?[0-9]+)?|nan", "#", line)
                 for line in text.splitlines()]
        return [re.sub(r"\s+", " ", line).replace(" ]", "]") for line in lines]

    assert shape(r["port"][2]) == shape(r["jax"]["stdout"])
    assert "loss nan" in r["port"][2]  # --epochs 0: no step ran


def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="cuda"):
        quality_protocol.main(CONFIGS["pretrain"])
