"""The port's trained binary-code quality study
(``sessionsimilaritysearch_tpu_torch.examples.binary_quality``) against the
JAX script, run in this process at a tiny size (160 corpus sessions, 12
queries, 32 bits, 16 triplets, one encoder epoch, two fine-tune epochs).

The JAX script runs with ``make_train_step`` wrapped to record the trained
encoder state, ``create_finetune_state`` and ``make_finetune_step`` the
hash heads' initial and trained states, and ``mine_triplets``,
``build_index`` and ``evaluate_binary`` their inputs and results. The port
then runs at ``--epochs 0`` with its encoder carrying JAX's trained state
(``weights.load_flax_train_state``) and its hash heads starting from JAX's
initial heads (``load_flax_finetune_state``), and fine-tunes them itself
for the same two epochs on the same triplet batches (the step draws
nothing at random).

Held: the sessions and the mined triplets exactly equal; the embeddings
within 1e-5 of their scale (f32); the spectrum statistics within rel 1e-4
of the same statistics of JAX's embeddings; each code family's bits equal
but for the few whose projection lies within ``FLIP_REL`` of 0 (counted);
the dense top-10 equal but for candidates within 1e-5 of the 10th score,
and each Hamming top-10 equal but for candidates within the score change
the flipped bits allow (2 per flipped bit), those swaps counted, each row
then within the bound they allow (a swap moves one query's mean by at most
1/10); the printed lines (numbers aside); the default device raises here."""

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

import examples.binary_quality as jax_bq  # noqa: E402
from sessionsimilaritysearch_tpu_torch.examples import binary_quality  # noqa: E402
from sessionsimilaritysearch_tpu_torch.weights import (  # noqa: E402
    load_flax_finetune_state,
    load_flax_train_state,
)

ARGS = ["--corpus", "160", "--train", "64", "--queries", "12", "--ft-epochs", "2",
        "--bits", "32", "--triplets", "16", "--asins", "400"]
K = 10
EMB_REL = 1e-5
TIE = 1e-5
FLIP_SHARE = 0.01  # at most this share of a code family's bits may differ
TAGS = ["binary untrained", "binary LSH (simhash)", "binary ITQ (32b)", "binary trained"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small tensors through many ops: one intra-op thread per suite worker
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs():
    rec = {"binary": []}
    mp = pytest.MonkeyPatch()

    def make_train_step(*a, **kw):
        step = orig["make_train_step"](*a, **kw)

        def recorded(*sa, **skw):
            out = step(*sa, **skw)
            rec["encoder"] = out[0]
            return out
        return recorded

    def create_finetune_state(*a, **kw):
        out = orig["create_finetune_state"](*a, **kw)
        rec["ft_init"] = jax.tree.map(np.asarray, out[1]._asdict())
        return out

    def make_finetune_step(*a, **kw):
        step = orig["make_finetune_step"](*a, **kw)

        def recorded(*sa, **skw):
            out = step(*sa, **skw)
            rec["ft_trained"] = out[0]
            return out
        return recorded

    def mine_triplets(*a, **kw):
        rec["triplets"] = orig["mine_triplets"](*a, **kw)
        return rec["triplets"]

    def build_index(ce, metric):
        idx = orig["build_index"](ce, metric=metric)
        search = idx.search

        def recorded(qe, k):
            D, I = search(qe, k)
            rec["dense"] = {"ce": np.asarray(ce), "qe": np.asarray(qe),
                            "D": np.asarray(D), "I": np.asarray(I)}
            return D, I
        idx.search = recorded
        return idx

    def evaluate_binary(db_c, q_c, corpus_sessions, test_data, **kw):
        res = orig["evaluate_binary"](db_c, q_c, corpus_sessions, test_data, **kw)
        rec["binary"].append((np.asarray(db_c), np.asarray(q_c), res))
        rec["data"] = (corpus_sessions, test_data)
        return res

    wrappers = dict(make_train_step=make_train_step, create_finetune_state=create_finetune_state,
                    make_finetune_step=make_finetune_step, mine_triplets=mine_triplets,
                    build_index=build_index, evaluate_binary=evaluate_binary)
    orig = {name: getattr(jax_bq, name) for name in wrappers}
    for name, fn in wrappers.items():
        mp.setattr(jax_bq, name, fn)
    mp.setattr(sys, "argv", ["binary_quality.py", *ARGS, "--epochs", "1"])
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            jax_bq.main()
    finally:
        mp.undo()
    rec["stdout"] = buf.getvalue()
    enc = rec.pop("encoder")
    tree = jax.tree.map(np.asarray, {"step": enc.step, "params": enc.params,
                                     "batch_stats": enc.batch_stats})

    port_orig = {"pre": binary_quality.create_pretrain_state,
                 "ft": binary_quality.create_finetune_state}

    def create_pretrain_state(*a, **kw):
        model, state = port_orig["pre"](*a, **kw)
        load_flax_train_state(state, tree)
        return model, state

    def create_finetune_state_port(*a, **kw):
        model, state = port_orig["ft"](*a, **kw)
        load_flax_finetune_state(state, rec["ft_init"])
        return model, state

    mp.setattr(binary_quality, "create_pretrain_state", create_pretrain_state)
    mp.setattr(binary_quality, "create_finetune_state", create_finetune_state_port)
    keep, buf = {}, io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            report = binary_quality.main(["--device", "cpu", *ARGS, "--epochs", "0"], keep=keep)
    finally:
        mp.undo()
    return {"jax": rec, "report": report, "keep": keep, "stdout": buf.getvalue()}


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


def test_sessions_and_triplets_exactly_jax(runs):
    keep, (corpus, test) = runs["keep"], runs["jax"]["data"]
    assert _same_sessions([d[0] for d in keep["corpus"]], corpus)
    assert _same_sessions([d[0] for d in keep["test"]], [d[0] for d in test])
    assert len(corpus) == 160 and len(test) == 12
    want = runs["jax"]["triplets"]
    got = keep["triplets"]
    assert len(got) == len(want) == runs["report"]["triplets"] > 0
    for g, w in zip(got, want):
        assert all(_same_sessions(a, b) for a, b in zip(g[:4], w[:4]))
        assert tuple(g[4:]) == tuple(w[4:])


def test_embeddings_within_f32(runs):
    keep, j = runs["keep"], runs["jax"]["dense"]
    for got, want in ((keep["ce"], j["ce"]), (keep["qe"], j["qe"])):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=EMB_REL * np.abs(want).max())


def test_spectrum_within_rel(runs):
    want = binary_quality.spectrum(runs["jax"]["dense"]["ce"])
    for key, value in want.items():
        assert runs["report"][key] == pytest.approx(value, rel=1e-4), key
    line = re.search(r"participation_ratio=([0-9.]+)", runs["jax"]["stdout"]).group(1)
    assert f"{runs['report']['participation_ratio']:.1f}" == line


def test_dense_row_within_ties(runs):
    keep, j = runs["keep"], runs["jax"]["dense"]
    D, I = keep["index"].search(keep["queries"], K)
    assert np.array_equal(I, keep["ids"])
    swaps = _tie_swaps(D, I, j["D"], j["I"], TIE)
    got = runs["report"]["rows"]["dense cosine"]["score"]
    want = float(re.search(r"dense cosine: ([0-9.]+)", runs["jax"]["stdout"]).group(1))
    assert abs(got - want) <= swaps / (K * len(I)) + 5e-5


@pytest.mark.parametrize("tag", TAGS)
def test_codes_equal_but_near_zero_bits(runs, tag):
    db_p, q_p, _, _ = runs["keep"]["codes"][tag]
    db_j, q_j, _ = runs["jax"]["binary"][TAGS.index(tag)]
    for got, want in ((db_p, db_j), (q_p, q_j)):
        assert got.shape == want.shape and set(np.unique(got)) <= {-1.0, 1.0}
        assert (got != want).mean() <= FLIP_SHARE, (tag, int((got != want).sum()))


@pytest.mark.parametrize("tag", TAGS)
def test_hamming_rows_within_ties(runs, tag):
    db_p, q_p, D_p, I_p = runs["keep"]["codes"][tag]
    db_j, q_j, res = runs["jax"]["binary"][TAGS.index(tag)]
    # a flipped bit moves a +-1 dot by 2; the two sides' D may differ in sign
    # and offset (distance or similarity), so each side is tie-checked on its own
    flips = (db_p != db_j).sum(1).max() + (q_p != q_j).sum(1).max()
    swaps = _tie_swaps(np.asarray(D_p, np.float64), I_p, np.asarray(res.D, np.float64),
                       res.I, 2 * flips + 1e-6)
    got = runs["report"]["rows"][tag]["score"]
    want = res.report["ave_all_product_type_score"]
    assert abs(got - want) <= swaps / (K * len(I_p)) + 1e-7, (tag, swaps, got, want)


def test_report_and_printed_lines(runs):
    r = runs["report"]
    assert list(r) == ["session_emb_dim", "bits", "compression", "regime", "encoder_train_s",
                       "participation_ratio", "var_top10", "var_top50", "var_top250",
                       "triplets", "ft_loss", "ft_train_s", "rows"]
    assert list(r["rows"]) == ["dense cosine", *TAGS]
    assert r["session_emb_dim"] == 128 and r["bits"] == 32 and np.isfinite(r["ft_loss"])

    def shape(text):
        lines = [re.sub(r"-?[0-9][0-9,]*(\.[0-9]+)?|nan", "#", line)
                 for line in text.splitlines()]
        return [re.sub(r"\s+", " ", line) for line in lines]

    assert shape(runs["stdout"]) == shape(runs["jax"]["stdout"])


def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="cuda"):
        binary_quality.main(ARGS)
