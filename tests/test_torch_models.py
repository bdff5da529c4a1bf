"""Parity of the port's encoder modules (sessionsimilaritysearch_tpu_torch
.models) with their Flax counterparts. Each case initializes the Flax module,
converts its parameters with ``weights.flax_to_state_dict`` (strict load),
feeds both sides the same numpy inputs and compares in float32.

Tolerance unless a test says otherwise: atol 1e-5, rtol 1e-4 -- float32 on
both sides, with sums taken in another order."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from sessionsimilaritysearch_tpu.config import Config, tiny_test_config
from sessionsimilaritysearch_tpu.models import build_graph_encoder as flax_build
from sessionsimilaritysearch_tpu.models import embedding as f_emb
from sessionsimilaritysearch_tpu.models import gnn as f_gnn
from sessionsimilaritysearch_tpu.models import pooling as f_pool
from sessionsimilaritysearch_tpu.models import transformer as f_tr
from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
from sessionsimilaritysearch_tpu_torch.models import embedding as t_emb
from sessionsimilaritysearch_tpu_torch.models import gnn as t_gnn
from sessionsimilaritysearch_tpu_torch.models import pooling as t_pool
from sessionsimilaritysearch_tpu_torch.models import transformer as t_tr
from sessionsimilaritysearch_tpu_torch.models.encoder import build_graph_encoder
from sessionsimilaritysearch_tpu_torch.weights import flax_to_state_dict, torch_key

ATOL, RTOL = 1e-5, 1e-4
CPU = torch.device("cpu")


def _init(module, *args):
    """Flax init on the CPU; numpy leaves, as the bridge expects."""
    params = module.init(jax.random.PRNGKey(0), *args)
    return jax.tree.map(np.asarray, params)


def _load(tmod, params):
    tmod.load_state_dict(flax_to_state_dict(params), strict=True)
    return tmod.eval()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def graph():
    return __graft_entry__._example_batch(tiny_test_config(), 8)


def test_torch_key_renames():
    assert torch_key(("encoder", "layer_1", "MultiHeadAttention_0", "q_proj",
                      "kernel")) == "encoder.layers.1.self_attn.q_proj.weight"
    assert torch_key(("gnn", "l2_pp", "gru", "hh", "bias")) == \
        "gnn.convs.l2_pp.gru.hh.bias"
    assert torch_key(("emb_ln", "scale")) == "emb_ln.weight"
    assert torch_key(("tok_emb", "embedding")) == "tok_emb.weight"


def test_transformer_encoder_with_fully_padded_row():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 7, 16)).astype(np.float32)
    pad = rng.random((4, 7)) < 0.3
    pad[2] = True  # every key of row 2 is padding: attention output is zero
    fmod = f_tr.TransformerEncoder(16, 2, 24, 2)
    params = _init(fmod, x, None, pad)
    want = fmod.apply(params, x, None, pad)
    tmod = _load(t_tr.TransformerEncoder(16, 2, 24, 2), params)
    _close(tmod(_t(x), _t(pad)), want)


def test_text_encoder():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50, (6, 9)).astype(np.int32)
    typ = rng.integers(0, 3, (6, 9)).astype(np.int32)  # clipped to 0..1
    att = (rng.random((6, 9)) < 0.7).astype(np.int32)
    att[3] = 0  # an empty text field: masked mean of nothing is 0
    fmod = f_emb.TextEncoder(vocab_size=50, d_model=16, nhead=2, nhid=24,
                             nlayers=2, max_len=9)
    params = _init(fmod, ids, typ, att)
    want = fmod.apply(params, ids, typ, att)
    tmod = _load(t_emb.TextEncoder(50, 16, 2, 24, 2, max_len=9), params)
    _close(tmod(_t(ids), _t(typ), _t(att)), want)


def test_node_asin_embedding():
    ids = np.random.default_rng(2).integers(0, 30, (3, 5)).astype(np.int32)
    fmod = f_emb.NodeAsinEmbedding(30, 8)
    params = _init(fmod, ids)
    tmod = _load(t_emb.NodeAsinEmbedding(30, 8), params)
    _close(tmod(_t(ids)), fmod.apply(params, ids), atol=0, rtol=0)


def test_gru_cell():
    rng = np.random.default_rng(3)
    m = rng.standard_normal((5, 12)).astype(np.float32)
    h = rng.standard_normal((5, 12)).astype(np.float32)
    fmod = f_gnn.GRUCell(12)
    params = _init(fmod, m, h)
    tmod = _load(t_gnn.GRUCell(12, 12), params)
    _close(tmod(_t(m), _t(h)), fmod.apply(params, m, h))


@pytest.mark.parametrize("d_in", [20, 12, 9], ids=["in_proj", "same", "pad"])
@pytest.mark.parametrize("use_edge_weight", [False, True])
def test_dense_gated_graph_conv(d_in, use_edge_weight):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 6, d_in)).astype(np.float32)
    adj = rng.integers(0, 3, (3, 6, 6)).astype(np.float32)
    fmod = f_gnn.DenseGatedGraphConv(12, use_edge_weight=use_edge_weight)
    params = _init(fmod, x, adj)
    tmod = _load(t_gnn.DenseGatedGraphConv(d_in, 12, use_edge_weight), params)
    _close(tmod(_t(x), _t(adj)), fmod.apply(params, x, adj))


def test_dense_gat_conv_counts_and_isolated_destination():
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((2, 5, 10)).astype(np.float32)
    xd = rng.standard_normal((2, 4, 7)).astype(np.float32)
    adj = (rng.random((2, 5, 4)) < 0.5).astype(np.float32)
    adj[0, 1, 2] = 2.0  # a repeated edge weighs twice in the softmax
    adj[1, :, 3] = 0.0  # destination with no incoming edge: bias only
    fmod = f_gnn.DenseGATConv(8)
    params = _init(fmod, xs, xd, adj)
    # give the bias a value so "bias only" is visible
    params["params"]["bias"] = np.linspace(-1, 1, 8).astype(np.float32)
    want = np.asarray(fmod.apply(params, xs, xd, adj))
    tmod = _load(t_gnn.DenseGATConv(10, 7, 8), params)
    got = tmod(_t(xs), _t(xd), _t(adj)).detach().numpy()
    _close(got, want)
    np.testing.assert_allclose(got[1, 3], params["params"]["bias"], atol=0, rtol=0)


def test_hetero_ggnn(graph):
    rng = np.random.default_rng(6)
    B, Q, P = graph.adj_qp.shape
    x = {
        "query": rng.standard_normal((B, Q, 10)).astype(np.float32),
        "product": rng.standard_normal((B, P, 14)).astype(np.float32),
    }
    fmod = f_gnn.HeteroGGNN(12, 2)
    params = _init(fmod, x, graph)
    want = fmod.apply(params, x, graph)
    tmod = _load(t_gnn.HeteroGGNN(10, 14, 12, 2), params)
    got = tmod({k: _t(v) for k, v in x.items()}, to_device(graph, CPU))
    for t in ("query", "product"):
        _close(got[t], want[t])


def test_attention_pooling(graph):
    x = np.random.default_rng(7).standard_normal(
        graph.query_node_mask.shape + (10,)).astype(np.float32)
    fmod = f_pool.AttentionPooling(6)
    params = _init(fmod, x, graph.query_node_mask)
    tmod = _load(t_pool.AttentionPooling(10, 6), params)
    _close(tmod(_t(x), _t(graph.query_node_mask)),
           fmod.apply(params, x, graph.query_node_mask))


def test_srgnn_pooling(graph):
    x = np.random.default_rng(8).standard_normal(
        graph.product_node_mask.shape + (10,)).astype(np.float32)
    mask = graph.product_node_mask
    fmod = f_pool.SRGNNPooling(6)
    params = _init(fmod, x, mask, graph)
    tmod = _load(t_pool.SRGNNPooling(10, 6), params)
    _close(tmod(_t(x), _t(mask), to_device(graph, CPU)),
           fmod.apply(params, x, mask, graph))


@pytest.mark.parametrize("fn", ["mean", "sum", "max"])
def test_masked_reductions(fn):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 6, 5)).astype(np.float32)
    mask = (rng.random((4, 6)) < 0.5).astype(np.float32)
    mask[1] = 0.0  # an empty set
    want = getattr(f_pool, f"masked_{fn}")(x, mask)
    got = getattr(t_pool, f"masked_{fn}")(_t(x), _t(mask))
    _close(got, want)


def _encoder_parity(cfg, batch_size=8):
    """Whole-encoder parity. Rounding error accumulates with the scale of
    the activations through the text layers, three GNN layers and the
    poolings, not with each output element, so atol is 1e-5 of the largest
    output (measured at the tiny config: 2.4e-7 of it)."""
    batch = __graft_entry__._example_batch(cfg, batch_size)
    fenc = flax_build(cfg)
    params = _init(fenc, batch)
    want = np.asarray(fenc.apply(params, batch))
    tenc = build_graph_encoder(cfg, "cpu")
    tenc.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.inference_mode():
        got = tenc(to_device(batch, CPU)).numpy()
    assert got.shape == (batch_size, cfg.session_emb_dim)
    _close(got, want, atol=1e-5 * np.abs(want).max(), rtol=RTOL)


def test_graph_level_encoder_tiny():
    _encoder_parity(tiny_test_config())


def test_graph_level_encoder_entry_config():
    # __graft_entry__.entry()'s reduced widths (text 256, GNN 256 x 3)
    cfg = Config(asin_num=20_000, vocab_size=8192, text_encoder_dim=256,
                 query_embedder_nhid=512, gnn_nhid=256, gnn_nout=256,
                 emb_len=128)
    _encoder_parity(cfg)


@pytest.mark.slow
def test_graph_level_encoder_full_config():
    # the flagship at Config() widths: text 768, GNN 800 x 3, 1600-d output
    _encoder_parity(Config(), batch_size=4)


def test_build_graph_encoder_seeded_init():
    cfg = tiny_test_config()
    a = build_graph_encoder(cfg, "cpu", torch.Generator().manual_seed(3))
    b = build_graph_encoder(cfg, "cpu", torch.Generator().manual_seed(3))
    c = build_graph_encoder(cfg, "cpu", torch.Generator().manual_seed(4))
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.gnn.convs.l0_qp.lin_src.weight,
                           c.gnn.convs.l0_qp.lin_src.weight)
    assert not a.training
    # the recency pooling: seeded like the rest, its decay length at 1.04
    r = build_graph_encoder(cfg.replace(product_pooling="recency"), "cpu",
                            torch.Generator().manual_seed(3))
    assert torch.equal(r.gnn.convs.l0_qp.lin_src.weight, a.gnn.convs.l0_qp.lin_src.weight)
    lam = torch.nn.functional.softplus(r.product_pooling.raw_lambda)
    assert lam.item() == pytest.approx(1.04, rel=1e-6)
    with pytest.raises(KeyError):
        build_graph_encoder(cfg.replace(product_pooling="mean"), "cpu")


def test_dropout_at_half_rate():
    """Flax ``nn.Dropout`` at rate 0.5: about half the entries kept, the kept
    ones scaled by 1 / (1 - rate), the keep mask the given generator's next
    uniform draw (>= rate); off when deterministic or at rate 0."""
    x = torch.ones(200_000)
    y = t_tr.dropout(x, 0.5, False, torch.Generator().manual_seed(3))
    kept = y != 0
    # binomial share: sigma = 0.5 / sqrt(2e5) ~ 0.0011, the bound ~9 sigma
    assert abs(kept.double().mean().item() - 0.5) < 0.01
    assert torch.equal(y[kept], torch.full((int(kept.sum()),), 2.0))
    assert torch.equal(kept, torch.rand(x.shape, generator=torch.Generator().manual_seed(3)) >= 0.5)
    g = torch.Generator().manual_seed(3)
    assert torch.equal(t_tr.dropout(x, 0.5, False, g), y)
    assert not torch.equal(t_tr.dropout(x, 0.5, False, g), y)  # the generator moved on
    assert t_tr.dropout(x, 0.5, True, g) is x and t_tr.dropout(x, 0.0, False) is x
    with pytest.raises(ValueError):
        t_tr.dropout(x, 0.5, False)


def _stand_in_mask(shape, k):
    """A fixed stand-in for the k-th dropout call of a forward: every third
    entry zeroed, the others scaled by 1 + k / 10."""
    n = int(np.prod(shape))
    return ((np.arange(n) % 3 != 0) * (1.0 + k / 10)).reshape(shape).astype(np.float32)


def _flax_with_stand_in(fn):
    """Run ``fn`` with every Flax ``nn.Dropout`` call replaced by the stand-in."""
    import flax.linen as fnn

    calls = []

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            x = args[0]
            calls.append(x.shape)
            return x * _stand_in_mask(x.shape, len(calls) - 1)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(intercept):
        return fn(), calls


def _port_with_stand_in(monkeypatch, module, fn):
    calls = []

    def drop(x, rate, deterministic, generator=None):
        assert rate == 0.5 and not deterministic and generator is not None
        calls.append(tuple(x.shape))
        return x * _t(_stand_in_mask(tuple(x.shape), len(calls) - 1))

    monkeypatch.setattr(module, "dropout", drop)
    return fn(), calls


def test_encoder_layer_dropout_positions_match_flax(monkeypatch):
    """With each dropout replaced by the same fixed mask on both sides, the
    port's TransformerEncoder at rate 0.5 gives Flax's output: the dropouts
    sit where Flax's EncoderLayer has them, in the same order."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    pad = rng.random((3, 5)) < 0.3
    fmod = f_tr.TransformerEncoder(16, 2, 24, 2, dropout=0.5)
    params = _init(fmod, x, None, pad)
    want, fcalls = _flax_with_stand_in(
        lambda: fmod.apply(params, x, None, pad, deterministic=False))
    tmod = _load(t_tr.TransformerEncoder(16, 2, 24, 2, dropout=0.5), params)
    got, tcalls = _port_with_stand_in(
        monkeypatch, t_tr,
        lambda: tmod(_t(x), _t(pad), deterministic=False, generator=torch.Generator()))
    assert tcalls == fcalls and len(tcalls) == 6
    _close(got, want)


def test_mlp_dropout_positions_match_flax(monkeypatch):
    """The same for the pretrainer's MLP head in training mode (batch
    statistics): one dropout after each hidden layer's ReLU."""
    from sessionsimilaritysearch_tpu.models import heads as f_heads
    from sessionsimilaritysearch_tpu_torch.models import heads as t_heads

    x = np.random.default_rng(5).standard_normal((6, 12)).astype(np.float32)
    fmod = f_heads.MLP(7, 10, n_hidden_layers=1, dropout=0.5)
    variables = _init(fmod, x)
    (want, _), fcalls = _flax_with_stand_in(lambda: fmod.apply(
        variables, x, deterministic=False, mutable=["batch_stats"]))
    tmod = t_heads.MLP(12, 7, 10, n_hidden_layers=1, dropout=0.5)
    tmod.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]),
                         strict=True)
    got, tcalls = _port_with_stand_in(
        monkeypatch, t_heads,
        lambda: tmod(_t(x), deterministic=False, generator=torch.Generator()))
    assert tcalls == fcalls and len(tcalls) == 2
    _close(got, want)
