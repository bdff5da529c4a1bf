"""The frozen copies of ``portbench/reference`` and ``portbench/traffic``
held to the program's CPU path at the tiny widths."""

import numpy as np
import pytest
import torch

from portbench import judge
from portbench.inputs import Corpus, make_weights
from portbench.reference import graph as ref_graph
from portbench.reference import tokenizer as ref_tok
from portbench.reference.encoder import Arith, embed_sessions, param_spec
from portbench.reference.search import scan
from portbench.tests.tiny import TINY_MODEL
from portbench.traffic.sessions import SessionGenerator
from sessionsimilaritysearch_tpu_torch.config import Config, tiny_test_config
from sessionsimilaritysearch_tpu_torch.data.graph import sequence_to_graph
from sessionsimilaritysearch_tpu_torch.data.synthetic import SyntheticSessionGenerator
from sessionsimilaritysearch_tpu_torch.models.encoder import build_graph_encoder
from sessionsimilaritysearch_tpu_torch.tokenizer import HashTokenizer

CFG = tiny_test_config()


def _sessions(n, seed=5, asin_num=1000):
    gen = SessionGenerator(asin_num, seed=seed)
    return [gen.session(1, 20) for _ in range(n)]


def test_generator_is_the_programs():
    ours, theirs = SessionGenerator(1000, seed=11), SyntheticSessionGenerator(1000, seed=11)
    assert ours.titles == theirs.titles
    for _ in range(50):
        a, b = ours.session(1, 20), theirs.session(min_len=1, max_len=20)
        assert [tuple(x) for x in a] == [tuple(x) for x in b]


@pytest.mark.parametrize("text", ["", "Red lamp", "wireless  KEYBOARD brand7 model3",
                                  " ".join(f"w{i}" for i in range(40)), "café 42"])
def test_tokenizer_is_the_programs(text):
    for vocab in (1000, 30522):
        np.testing.assert_array_equal(ref_tok.encode(text, 20, vocab),
                                      HashTokenizer(vocab).encode_one(text, 20))


@pytest.mark.parametrize("ignore_query", [True, False])
def test_graph_is_the_programs(ignore_query):
    tok = HashTokenizer(CFG.vocab_size)
    for i, s in enumerate(_sessions(40)):
        g = sequence_to_graph(i, s, [], tok, CFG.dims, ignore_query=ignore_query)
        r = ref_graph.session_graph(s, 20, 20, CFG.vocab_size, ignore_query)
        for ours, theirs in (("query_ids", "query_input_ids"), ("query_mask", "query_node_mask"),
                             ("product_asin", "product_asin"),
                             ("product_ids", "product_input_ids"),
                             ("product_mask", "product_node_mask"), ("adj_qp", "adj_qp"),
                             ("adj_pp", "adj_pp"), ("last_click", "last_click_mask")):
            np.testing.assert_array_equal(r[ours], getattr(g, theirs), err_msg=ours)


def test_weights_fit_the_programs_encoder_at_the_flagship_widths():
    cfg = Config().replace(asin_num=1000, vocab_size=1000)
    m = {f: getattr(cfg, f) for f in TINY_MODEL}
    enc = build_graph_encoder(cfg, "cpu")
    want = {k: tuple(v.shape) for k, v in enc.state_dict().items()}
    assert {n: s for n, s, _, _ in param_spec(m)} == want


def _port_encoder(W):
    enc = build_graph_encoder(CFG, "cpu")
    enc.load_state_dict({k: v.float() for k, v in W.items()})
    return enc


def test_encoder_matches_the_programs_f32_forward():
    from sessionsimilaritysearch_tpu_torch.data.graph import build_graph_batch

    W = make_weights(TINY_MODEL, 3, "cpu")
    sessions = _sessions(24)
    enc = _port_encoder(W)
    g = build_graph_batch([(s, []) for s in sessions], HashTokenizer(CFG.vocab_size),
                          CFG.dims, ignore_query=True)
    with torch.no_grad():
        want = enc(type(g)(*(torch.from_numpy(np.asarray(a)) for a in g)))
    got = embed_sessions(sessions, W, TINY_MODEL, Arith("f32"), "cpu")
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * want.abs().max().item())


def test_serving_forward_stays_within_bf16_rounding_of_the_reference():
    from sessionsimilaritysearch_tpu_torch.evalharness.harness import (
        EmbeddingPipeline, build_keyword_table, build_title_table, make_cached_encode_fn)
    from sessionsimilaritysearch_tpu_torch.utils.precision import serving_params

    W = make_weights(TINY_MODEL, 4, "cpu")
    gen = SessionGenerator(1000, seed=6)
    sessions = [gen.session(1, 20) for _ in range(32)]
    enc = serving_params(_port_encoder(W))
    tok = HashTokenizer(CFG.vocab_size)
    table = build_title_table(CFG, tok, gen.titles, enc)
    qt, lk = build_keyword_table(CFG, tok, [], enc)
    pipe = EmbeddingPipeline(CFG, tok, make_cached_encode_fn(enc, table, qt, lk),
                             device="cpu", batch_size=32)
    got = torch.from_numpy(pipe(sessions))
    want = embed_sessions(sessions, W, TINY_MODEL, Arith("f32"), "cpu")
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert cos.min() > 0.999
    fp8 = embed_sessions(sessions, W, TINY_MODEL, Arith("fp8"), "cpu")
    cos8 = torch.nn.functional.cosine_similarity(fp8, want, dim=1)
    # float8 drifts further from the reference than the bf16 serving forward
    assert (1 - cos8).mean() > 3 * (1 - cos).mean()


def _blocks(corpus):
    return list(corpus.blocks())


def test_exact_scan_is_the_brute_force_top_k():
    corpus = Corpus({"rows": 3000, "centers": 16, "noise": 1.0, "block_rows": 700}, 24, 1, "cpu")
    rows = torch.cat([r for _, r in _blocks(corpus)]).double()
    rows = rows / rows.norm(dim=1, keepdim=True)
    q = torch.randn(9, 24, generator=torch.Generator().manual_seed(2))
    qn = (q / q.norm(dim=1, keepdim=True)).double()
    want = torch.topk(qn @ rows.T, 10, dim=1)
    out = scan(q, _blocks(corpus), semantics="exact", k=10, probe=want.indices)
    assert torch.equal(out["ids"], want.indices)
    torch.testing.assert_close(out["scores"].double(), want.values, rtol=0, atol=1e-5)
    torch.testing.assert_close(out["probe_score"].double(), want.values, rtol=0, atol=1e-5)


def test_twostage_scan_is_the_programs_twostage_index():
    from sessionsimilaritysearch_tpu_torch.index.twostage import TwoStageIndex

    d, n, bits = 32, 4096, 64
    corpus = Corpus({"rows": n, "centers": 16, "noise": 1.0, "block_rows": 1000}, d, 2, "cpu")
    index = TwoStageIndex(d, n, device="cpu", prefilter="binary", n_bits=bits, pool=40,
                          stage1="packed")
    for _, rows in _blocks(corpus):
        index.add(rows)
    q = torch.randn(12, d, generator=torch.Generator().manual_seed(3))
    D, I = index.search(q, 10)
    R = torch.randn(d, bits, generator=torch.Generator().manual_seed(0))
    ref = scan(q, _blocks(corpus), semantics="twostage", k=10, pool=40, projection=R,
               probe=torch.from_numpy(I))
    nums = judge.numbers(D, I, {k: v.numpy() for k, v in ref.items()}, n)
    assert nums["bad_ids"] == 0 and nums["pool_gap"] == 0
    assert nums["score_err"] < 1e-2  # the index re-ranks bf16 rows
    assert nums["miss"] < 0.1        # ties at the pool's edge resolve apart


def test_judge_counts_what_it_says():
    ref = {"ids": np.array([[1, 2, 3], [4, 5, 6]]),
           "probe_score": np.array([[0.9, 0.8, 0.7], [0.5, 0.4, 0.3]])}
    D = np.array([[0.9, 0.8, 0.7], [0.5, 0.4, 0.3]])
    assert judge.numbers(D, np.array([[1, 2, 3], [4, 5, 6]]), ref, 10) == \
        {"bad_ids": 0.0, "score_err": 0.0, "miss": 0.0}
    nums = judge.numbers(D + [[0, 0, 0.25], [0, 0, 0]], np.array([[1, 1, 3], [4, 5, 12]]),
                         ref, 10)
    assert nums["bad_ids"] == 2.0             # a repeat and a row past the corpus
    assert nums["score_err"] == pytest.approx(0.25)
    assert nums["miss"] == pytest.approx(2 / 6)
    assert not judge.verdict(nums, {"bad_ids": 0, "score_err": 1, "miss": 1})
    assert not judge.verdict({"x": 0.0}, {})
