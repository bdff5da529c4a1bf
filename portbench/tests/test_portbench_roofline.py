"""The yardstick's counts against shapes worked by hand."""

import pytest

from portbench import roofline
from portbench.tests.tiny import TINY_MODEL


def test_dense_scan_bound_at_the_k1_bench_shape():
    ops, nbytes, peak = roofline.dense_scan(1024, 1 << 20, 1600)
    assert ops == 2 * 1024 * 2**20 * 1600
    assert nbytes == 2**20 * 1600 * 2 + 1024 * 1600 * 2
    # PERF.md's K1 bf16 bound: 3.474 ms, set by the operations
    assert roofline.least_seconds(ops, nbytes, peak) * 1e3 == pytest.approx(3.474, abs=5e-4)


def test_dense_scan_bound_at_the_cell_shape():
    ops, nbytes, peak = roofline.dense_scan(1024, 1 << 23, 1600)
    assert roofline.least_seconds(ops, nbytes, peak) * 1e3 == pytest.approx(27.79, abs=0.01)
    assert nbytes / roofline.HBM_BYTES_PER_S * 1e3 == pytest.approx(8.01, abs=0.01)


def test_binary_scan_bound_is_the_int8_rate():
    ops, nbytes, peak = roofline.binary_scan(1024, 1 << 20, 256)
    assert (ops, peak) == (2 * 1024 * 2**20 * 256, "int8")
    assert nbytes == 2**20 * 32 + 1024 * 32
    # PERF.md's K5 bound at 8 words: 0.278 ms
    assert roofline.least_seconds(ops, nbytes, peak) * 1e3 == pytest.approx(0.278, abs=5e-4)


def test_rerank_is_set_by_its_bytes_at_pool_128():
    ops, nbytes, peak = roofline.rerank(1024, 128, 1600)
    assert ops == 2 * 1024 * 128 * 1600
    assert nbytes == 1024 * 128 * 1600 * 2 + 1024 * 1600 * 4
    assert roofline.least_seconds(ops, nbytes, peak) == nbytes / roofline.HBM_BYTES_PER_S


def _hand_flops(m, B, nodes=None):
    """Every matrix product of the GNN and the poolings, counted by hand."""
    L = m["max_seq_len"]
    Q, P = nodes or (L + 1, L)
    hid, out = m["gnn_nhid"], m["gnn_nout"]
    dq, dp = m["text_encoder_dim"], m["emb_len"] + m["text_encoder_dim"]
    f = 0
    for _ in range(m["gnn_nlayers"]):
        # GAT query -> product, then product -> query
        f += 2 * B * (Q * dq * hid + P * dp * hid + Q * hid + P * hid + P * Q * hid)
        f += 2 * B * (P * dp * hid + Q * dq * hid + P * hid + Q * hid + Q * P * hid)
        # gated graph conv on product -> product with its GRU
        if dp > hid:
            f += 2 * B * P * dp * hid
        f += 2 * B * (P * hid * hid + P * P * hid + 2 * P * hid * 3 * hid)
        dq = dp = hid
    Dq = m["text_encoder_dim"] + m["gnn_nlayers"] * hid
    Dp = m["emb_len"] + m["text_encoder_dim"] + m["gnn_nlayers"] * hid
    f += 2 * B * (Q * Dq + Dq * out)                          # attention pooling
    f += 2 * B * (Dp * Dp + P * Dp * Dp + P * Dp + 2 * Dp * out)  # SR-GNN pooling
    return f


@pytest.mark.parametrize("model", [TINY_MODEL, dict(TINY_MODEL, gnn_nhid=48, gnn_nlayers=3)])
def test_encoder_flops_match_the_hand_count(model):
    assert roofline.encoder_flops(model, 16) == _hand_flops(model, 16)


def test_encoder_flops_at_the_flagship_widths():
    import json

    from portbench.tests.tiny import PKG

    m = json.loads((PKG / "configs" / "flagship-dense-bf16.json").read_text())["model"]
    flops = roofline.encoder_flops(m, 1024)
    assert flops == _hand_flops(m, 1024)
    # about 2 ms of a 1,024-session batch at the bf16 peak
    assert 1.0e-3 < flops / roofline.PEAK["bf16"] < 4.0e-3


@pytest.mark.parametrize("nodes", [(1, 1), (1, 7), (4, 3), (21, 20)])
def test_encoder_flops_at_a_sessions_own_sizes(nodes):
    assert roofline.encoder_flops(TINY_MODEL, 3, nodes) == _hand_flops(TINY_MODEL, 3, nodes)
    assert roofline.encoder_flops(TINY_MODEL, 3, nodes) == \
        3 * roofline.encoder_flops(TINY_MODEL, 1, nodes)


@pytest.mark.parametrize("ignore_query", [True, False])
def test_node_counts_are_the_filled_graph_nodes(ignore_query):
    from portbench.reference.graph import node_counts, session_graph
    from portbench.traffic.sessions import SessionGenerator

    gen = SessionGenerator(500, seed=3)
    m = TINY_MODEL
    for _ in range(200):
        s = gen.session(1, 30)
        g = session_graph(s, m["max_seq_len"], m["token_len"], m["vocab_size"], ignore_query)
        assert node_counts(s, m["max_seq_len"], ignore_query) == \
            (int(g["query_mask"].sum()), int(g["product_mask"].sum()))


def test_a_request_counts_its_sessions_not_the_padding():
    from portbench import run
    from portbench.tests.tiny import tiny_config
    from portbench.traffic.sessions import SessionGenerator

    cfg = tiny_config("exact")
    gen = SessionGenerator(500, seed=4)
    sessions = [gen.session(1, 20) for _ in range(16)]
    flops = {}
    work = run.request_work(cfg, sessions, flops)
    padded = roofline.encoder_flops(cfg["model"], len(sessions))
    assert 0 < work["encoder"][0] < padded
    assert work["scan"] == roofline.dense_scan(16, cfg["corpus"]["rows"], 64)
    assert len(flops) <= 20  # one count per shape (ignore_query: one query node)
