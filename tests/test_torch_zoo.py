"""Parity of the port's ``HGT`` and ``NodeLevelEncoder``
(sessionsimilaritysearch_tpu_torch.models) with the JAX package's Flax
modules: the Flax parameters carried by ``weights.flax_to_state_dict`` and
loaded with ``strict=True``, the same numpy inputs (seeded) on both sides,
the tiny config's graphs.

Tolerance: atol 1e-5, rtol 1e-4 -- float32 on both sides, sums taken in
another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.config import tiny_test_config as j_tiny
from sessionsimilaritysearch_tpu.data import SyntheticSessionGenerator as JGen
from sessionsimilaritysearch_tpu.data.graph import batch_graphs, sequence_to_graph
from sessionsimilaritysearch_tpu.models import embedding as j_emb
from sessionsimilaritysearch_tpu.models import encoder as j_enc
from sessionsimilaritysearch_tpu.models import gnn as j_gnn
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config as t_tiny
from sessionsimilaritysearch_tpu_torch.data.graph import SessionGraph
from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
from sessionsimilaritysearch_tpu_torch.models import HGT, NodeLevelEncoder
from sessionsimilaritysearch_tpu_torch.models import embedding as t_emb
from sessionsimilaritysearch_tpu_torch.models import gnn as t_gnn
from sessionsimilaritysearch_tpu_torch.models.encoder import build_text_backbone
from sessionsimilaritysearch_tpu_torch.weights import flax_to_state_dict

ATOL, RTOL = 1e-5, 1e-4
CPU = torch.device("cpu")
C, HEADS, LAYERS, DQ, DP = 8, 2, 2, 16, 24


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the suite's workers share the machine's cores (oversubscribed, the
    training calls here ran ~8x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _port(module, params):
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def batch():
    cfg = j_tiny()
    tok = get_tokenizer(cfg.vocab_size)
    data = JGen(asin_num=cfg.asin_num, seed=0).dataset(6)
    return batch_graphs([sequence_to_graph(i, s, t, tok, cfg.dims)
                         for i, (s, t) in enumerate(data)])


def _features(batch, seed):
    rng = np.random.default_rng(seed)
    B, Q = batch.query_node_mask.shape
    P = batch.product_node_mask.shape[1]
    return {"query": rng.standard_normal((B, Q, DQ)).astype(np.float32),
            "product": rng.standard_normal((B, P, DP)).astype(np.float32)}


def _hgt_pair(batch, x, seed=0):
    """The Flax HGT's numpy params and outputs, and the port's HGT with them."""
    jm = j_gnn.HGT(C, HEADS, LAYERS)
    jx = {k: jnp.asarray(a) for k, a in x.items()}
    params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(seed), jx,
                                              jax.tree.map(jnp.asarray, batch)))
    return jm, params, _port(HGT(DQ, DP, C, HEADS, LAYERS, device="cpu"), params)


def _both(jm, params, tm, batch, x, **kw):
    want = jm.apply(params, {k: jnp.asarray(a) for k, a in x.items()},
                    jax.tree.map(jnp.asarray, batch), **kw)
    got = tm({k: torch.from_numpy(a) for k, a in x.items()}, _graph(batch), **kw)
    return got, want


def _graph(batch):
    return to_device(SessionGraph(*(np.asarray(a) for a in batch)), CPU)


@pytest.mark.parametrize("add_input_feat", [True, False])
def test_hgt_jk_concat_matches_jax(batch, add_input_feat):
    x = _features(batch, 1)
    jm, params, tm = _hgt_pair(batch, x)
    got, want = _both(jm, params, tm, batch, x, add_input_feat=add_input_feat)
    for t in ("query", "product"):
        # the projected input (C wide) and every layer's output (C each)
        assert got[t].shape[-1] == (LAYERS + int(add_input_feat)) * C
        _close(got[t], want[t])


def test_hgt_carries_every_flax_name(batch):
    _, params, tm = _hgt_pair(batch, _features(batch, 2))
    names = set(tm.state_dict())
    assert {"lin_query.weight", "lin_product.bias", "l0_q_product.weight",
            "l1_v_query.bias", "l0_out_qp.weight", "l1_out_pq.bias",
            "l1_out_pp.weight"} <= names
    assert len(names) == len(flax_to_state_dict(params))


def test_hgt_isolated_destination_gets_a_zero_message(batch):
    """A node with no incoming edge of any type gets no message: with the
    output projections' biases zero, each of its layers passes its state
    on unchanged (gelu(0) = 0), where a uniform attention would not."""
    iso = jax.tree.map(np.array, batch)
    iso.adj_qp[0, :, 0] = 0  # product 0 of session 0: no query source ...
    iso.adj_pp[0, :, 0] = 0  # ... and no product source
    iso.adj_qp[1, 0, :] = 0  # query 0 of session 1: no product source
    x = _features(iso, 3)
    jm, params, _ = _hgt_pair(iso, x, seed=1)
    for i in range(LAYERS):
        for key in ("qp", "pq", "pp"):
            params["params"][f"l{i}_out_{key}"]["bias"][:] = 0.0
    tm = _port(HGT(DQ, DP, C, HEADS, LAYERS, device="cpu"), params)
    got, want = _both(jm, params, tm, iso, x)
    for t in ("query", "product"):
        _close(got[t], want[t])
    for t, node in (("product", got["product"][0, 0]), ("query", got["query"][1, 0])):
        chunks = node.reshape(LAYERS + 1, C)
        for layer in range(1, LAYERS + 1):
            assert torch.equal(chunks[layer], chunks[0]), (t, layer)
    # a node with sources does receive a message
    other = got["product"][0, 1].reshape(LAYERS + 1, C)
    assert not torch.equal(other[1], other[0])


def test_hgt_masks_edges_by_presence_not_count(batch):
    """Multiplicity > 1 in adj_qp: HGT attends over ``adj > 0``, unlike the
    count-weighted DenseGATConv, so doubled and tripled edges change
    nothing; the JAX module agrees on the multi-edge graph."""
    rng = np.random.default_rng(4)
    present = batch.adj_qp > 0
    assert present.any()
    multi = batch._replace(adj_qp=np.where(present, rng.integers(2, 4, batch.adj_qp.shape),
                                           0).astype(batch.adj_qp.dtype))
    assert multi.adj_qp.max() > 1
    x = _features(batch, 5)
    jm, params, tm = _hgt_pair(batch, x)
    got, want = _both(jm, params, tm, multi, x)
    once, _ = _both(jm, params, tm, batch, x)
    for t in ("query", "product"):
        _close(got[t], want[t])
        torch.testing.assert_close(got[t], once[t], atol=0, rtol=0)


def test_hgt_refuses_heads_that_do_not_divide_the_width():
    with pytest.raises(ValueError, match="multiple of num_heads"):
        HGT(4, 4, 10, 3, 1, device="cpu")


@pytest.mark.parametrize("backbone", ["hgt", "ggnn"])
def test_node_level_encoder_matches_jax(batch, backbone):
    jcfg, tcfg = j_tiny(), t_tiny()
    if backbone == "hgt":
        jgnn = j_gnn.HGT(jcfg.gnn_nhid, jcfg.gnn_nhead, jcfg.gnn_nlayers)
        tgnn = HGT(tcfg.text_encoder_dim, tcfg.emb_len, tcfg.gnn_nhid, tcfg.gnn_nhead,
                   tcfg.gnn_nlayers, device="cpu")
        width = (tcfg.gnn_nlayers + 1) * tcfg.gnn_nhid
    else:
        jgnn = j_gnn.HeteroGGNN(jcfg.gnn_nhid, jcfg.gnn_nlayers)
        tgnn = t_gnn.HeteroGGNN(tcfg.text_encoder_dim, tcfg.emb_len, tcfg.gnn_nhid,
                                tcfg.gnn_nlayers, device="cpu")
        width = None
    jenc = j_enc.NodeLevelEncoder(j_enc.build_text_backbone(jcfg),
                                  j_emb.NodeAsinEmbedding(jcfg.asin_num, jcfg.emb_len), jgnn)
    jg = jax.tree.map(jnp.asarray, batch)
    params = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(7), jg))
    want = jenc.apply(params, jg)
    tenc = _port(NodeLevelEncoder(build_text_backbone(tcfg, device="cpu"),
                                  t_emb.NodeAsinEmbedding(tcfg.asin_num, tcfg.emb_len,
                                                          device="cpu"),
                                  tgnn, device="cpu"), params)
    with torch.no_grad():
        got = tenc(_graph(batch))
    for t in ("query", "product"):
        assert got[t].shape == want[t].shape
        if width is not None:
            assert got[t].shape[-1] == width
        _close(got[t], want[t])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only machine")
def test_hgt_and_node_level_encoder_default_to_the_card():
    with pytest.raises(RuntimeError, match="cuda"):
        HGT(4, 4, 4, 2, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        NodeLevelEncoder(torch.nn.Identity(), torch.nn.Identity(), torch.nn.Identity())
