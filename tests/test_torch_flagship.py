"""The flagship serving forward of the port against the JAX package's:
``RecencySRGNNPooling``, ``GraphLevelEncoder``'s ``use_id_embedding``, node
masks, ``get_node`` and cached forwards (``title_table``, ``query_table`` +
``query_kw``), ``keyword_ids`` and its out-of-vocabulary fallback,
``utils.precision`` (``serving_params``, ``cast_floats``) and the bf16
serving forward. Both packages run on the same weights, carried by
``weights.flax_to_state_dict`` (strict load), and the same seeded inputs.

Tolerances: the recency pooling alone rtol 1e-5, atol 1e-5; whole f32
encoders atol 1e-5 of the largest output, rtol 1e-4 (test_torch_models.py);
cached against uncached forwards rtol 1e-5, atol 1e-4 (the JAX package's own
test, tests/test_models.py); bf16 serving forwards: every row's cosine with
JAX's bf16 forward >= 0.999 and the largest |difference| <= 2^-6 of the
largest |JAX output|, and >= 0.98 cosine with the port's f32 forward; the
bf16 fully cached forward on JAX's own bf16 tables: the largest |difference|
<= 1e-4 of the largest |JAX output|, a bound the f32 forward must miss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from sessionsimilaritysearch_tpu.config import Config, tiny_test_config
from sessionsimilaritysearch_tpu.data import SyntheticSessionGenerator as JGen
from sessionsimilaritysearch_tpu.data import build_graph_batch as j_build_batch
from sessionsimilaritysearch_tpu.evalharness import harness as jh
from sessionsimilaritysearch_tpu.models import build_graph_encoder as flax_build
from sessionsimilaritysearch_tpu.models import encoder as f_enc
from sessionsimilaritysearch_tpu.models import pooling as f_pool
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu.utils import precision as j_precision
from sessionsimilaritysearch_tpu_torch.evalharness import harness as th
from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
from sessionsimilaritysearch_tpu_torch.models import encoder as t_enc
from sessionsimilaritysearch_tpu_torch.models import pooling as t_pool
from sessionsimilaritysearch_tpu_torch.models.embedding import NodeAsinEmbedding, TextEncoder
from sessionsimilaritysearch_tpu_torch.models.encoder import build_graph_encoder
from sessionsimilaritysearch_tpu_torch.utils import precision as t_precision
from sessionsimilaritysearch_tpu_torch.weights import flax_to_state_dict, torch_key

CPU = torch.device("cpu")
ATOL_ENC_REL, RTOL_ENC = 1e-5, 1e-4
RTOL_CACHE, ATOL_CACHE = 1e-5, 1e-4
BF16_COS, BF16_REL = 0.999, 2.0**-6
POLICY_REL = 1e-4


def _close(got, want, atol, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _enc_close(got, want):
    want = np.asarray(want)
    _close(got, want, ATOL_ENC_REL * np.abs(want).max(), RTOL_ENC)


def _init(module, *args):
    return jax.tree.map(np.asarray, jax.jit(module.init)(jax.random.PRNGKey(0), *args))


def _port(cfg, params):
    enc = build_graph_encoder(cfg, "cpu")
    enc.load_state_dict(flax_to_state_dict(params), strict=True)
    return enc


def _product_sessions(gen, n):
    """Sessions with at least one product: asin 0's placeholder node gathers
    asin 0's real title under a title table (the JAX package's caveat)."""
    return [d for d in gen.dataset(n) if any(a[1] != "s" for a in d[0])]


@pytest.fixture(scope="module")
def cfg():
    return tiny_test_config()


@pytest.fixture(scope="module")
def tok(cfg):
    return get_tokenizer(cfg.vocab_size)


@pytest.fixture(scope="module")
def gen(cfg):
    return JGen(asin_num=cfg.asin_num, seed=0)


@pytest.fixture(scope="module")
def data(gen):
    return _product_sessions(gen, 14)


@pytest.fixture(scope="module")
def batches(cfg, tok, data):
    """Host grids of the same sessions without and with the query nodes."""
    return {iq: j_build_batch(data, tok, cfg.dims, ignore_query=iq) for iq in (True, False)}


@pytest.fixture(scope="module")
def flagship(cfg, batches):
    """The flagship encoder on both sides, on the same f32 weights."""
    fenc = flax_build(cfg)
    params = _init(fenc, batches[False])
    return fenc, params, _port(cfg, params)


@pytest.fixture(scope="module")
def tables(cfg, tok, gen, data, flagship):
    """Title and keyword tables of both packages (f32 weights)."""
    fenc, params, tenc = flagship
    kws = sorted({a[2] or "" for d in data for a in d[0] if a[1] == "s"})
    return {
        "jax": (jh.build_title_table(cfg, tok, gen.titles, fenc, params, batch_size=256),
                *jh.build_keyword_table(cfg, tok, kws, fenc, params, batch_size=256)),
        "port": (th.build_title_table(cfg, tok, gen.titles, tenc, batch_size=256),
                 *th.build_keyword_table(cfg, tok, kws, tenc, batch_size=256)),
    }


# --- RecencySRGNNPooling ----------------------------------------------------

@pytest.mark.parametrize("raw_lambda", [None, -0.7], ids=["init", "learned"])
def test_recency_pooling(cfg, raw_lambda):
    graph = __graft_entry__._example_batch(cfg, 8)
    x = np.random.default_rng(11).standard_normal(
        graph.product_node_mask.shape + (10,)).astype(np.float32)
    mask = graph.product_node_mask
    fmod = f_pool.RecencySRGNNPooling(6)
    params = _init(fmod, x, mask, graph)
    if raw_lambda is not None:
        params["params"]["raw_lambda"] = np.float32(raw_lambda)
    assert params["params"]["raw_lambda"].shape == ()
    tmod = t_pool.RecencySRGNNPooling(10, 6)
    assert tmod.raw_lambda.item() == pytest.approx(float(np.log(np.expm1(1.04))), abs=1e-7)
    tmod.load_state_dict(flax_to_state_dict(params), strict=True)
    _close(tmod(torch.from_numpy(x), torch.from_numpy(mask), to_device(graph, CPU)),
           fmod.apply(params, x, mask, graph), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def recency(cfg):
    """The flagship encoder with the recency pooling on both sides."""
    rcfg = cfg.replace(product_pooling="recency")
    batch = __graft_entry__._example_batch(rcfg, 8)
    fenc = flax_build(rcfg)
    params = _init(fenc, batch)
    return rcfg, batch, fenc, params, _port(rcfg, params)


def test_recency_encoder(recency):
    _, batch, fenc, params, tenc = recency
    assert torch_key(("product_pooling", "raw_lambda")) in flax_to_state_dict(params)
    with torch.inference_mode():
        _enc_close(tenc(to_device(batch, CPU)), jax.jit(fenc.apply)(params, batch))


def test_recency_builds_and_runs_at_config_width():
    # the flagship widths (text 768, GNN 3 x 800, 1600-d) with the recency pooling
    rcfg = Config(product_pooling="recency")
    enc = build_graph_encoder(rcfg, "cpu", torch.Generator().manual_seed(0))
    assert enc.product_pooling.lin4.in_features == 3 * (rcfg.emb_len + rcfg.text_encoder_dim
                                                        + rcfg.gnn_nlayers * rcfg.gnn_nhid)
    batch = __graft_entry__._example_batch(rcfg, 2)
    with torch.inference_mode():
        out = enc(to_device(batch, CPU))
    assert out.shape == (2, rcfg.session_emb_dim) and torch.isfinite(out).all()


# --- GraphLevelEncoder options ----------------------------------------------

def test_use_id_embedding_off(cfg, batches):
    batch = batches[False]
    fenc = f_enc.GraphLevelEncoder(
        query_node_embedder=f_enc.build_text_backbone(cfg),
        product_node_embedder=f_enc.NodeAsinEmbedding(cfg.asin_num, cfg.emb_len),
        gnn=f_enc.HeteroGGNN(cfg.gnn_nhid, cfg.gnn_nlayers),
        product_pooling=f_pool.SRGNNPooling(cfg.gnn_nout),
        query_pooling=f_pool.AttentionPooling(cfg.gnn_nout),
        use_id_embedding=False,
    )
    params = _init(fenc, batch)
    assert "product_node_embedder" not in params["params"]
    d, hid, layers = cfg.text_encoder_dim, cfg.gnn_nhid, cfg.gnn_nlayers
    tenc = t_enc.GraphLevelEncoder(
        query_node_embedder=t_enc.build_text_backbone(cfg, device=CPU),
        product_node_embedder=None,
        gnn=t_enc.HeteroGGNN(d, d, hid, layers, device=CPU),
        product_pooling=t_pool.SRGNNPooling(d + layers * hid, cfg.gnn_nout, device=CPU),
        query_pooling=t_pool.AttentionPooling(d + layers * hid, cfg.gnn_nout, device=CPU),
        use_id_embedding=False,
    ).eval()
    tenc.load_state_dict(flax_to_state_dict(params), strict=True)
    assert tenc.product_node_embedder is None
    assert tenc.gnn.convs.l0_qp.lin_dst.in_features == cfg.text_encoder_dim
    with torch.inference_mode():
        _enc_close(tenc(to_device(batch, CPU)), jax.jit(fenc.apply)(params, batch))


def test_node_masks_and_get_node(batches, flagship):
    fenc, params, tenc = flagship
    batch = batches[False]
    rng = np.random.default_rng(12)
    qm = (rng.random(batch.query_node_mask.shape) < 0.7).astype(np.float32)
    pm = (rng.random(batch.product_node_mask.shape) < 0.7).astype(np.float32)
    want, want_nodes, none = jax.jit(
        lambda b, q, p: fenc.apply(params, b, q, p, get_node=True))(batch, qm, pm)
    with torch.inference_mode():
        got, got_nodes, got_none = tenc(to_device(batch, CPU), torch.from_numpy(qm),
                                        torch.from_numpy(pm), get_node=True)
    assert none is None and got_none is None
    _enc_close(got, want)
    for t in ("query", "product"):
        _enc_close(got_nodes[t], want_nodes[t])
    # the masks matter: without them the output differs
    with torch.inference_mode():
        assert not torch.allclose(tenc(to_device(batch, CPU)), got)


def test_query_table_alone_raises(batches, flagship):
    _, _, tenc = flagship
    g = to_device(batches[True], CPU)
    table = torch.zeros(4, 32)
    kw = torch.zeros(g.query_input_ids.shape[:2], dtype=torch.int32)
    with pytest.raises(ValueError, match="title_table"):
        tenc(g, query_table=table, query_kw=kw)
    with pytest.raises(ValueError, match="query_kw"):
        tenc(g, title_table=table, query_table=table)


# --- cached forwards ----------------------------------------------------------

@pytest.mark.parametrize("ignore_query", [True, False], ids=["ignore_query", "with_queries"])
def test_cached_forwards(batches, flagship, tables, ignore_query):
    fenc, params, tenc = flagship
    batch = batches[ignore_query]
    if not ignore_query:  # real keywords in play, not only the root node
        assert (batch.query_node_mask.sum(axis=1) > 1).any()
    jt, jq, jlk = tables["jax"]
    tt, tq, tlk = tables["port"]
    _close(tt, jt, atol=1e-5, rtol=1e-5)
    _close(tq, jq, atol=1e-5, rtol=1e-5)
    g = to_device(batch, CPU)
    with torch.inference_mode():
        plain = tenc(g).numpy()
        kw = torch.from_numpy(th.keyword_ids(tlk, batch.query_input_ids))
        port = {"title": tenc(g, title_table=tt),
                "full": tenc(g, title_table=tt, query_table=tq, query_kw=kw)}
    jax_out = {"title": jh.make_cached_encode_fn(fenc, params, jt)(batch),
               "full": jh.make_cached_encode_fn(fenc, params, jt, jq, jlk)(batch)}
    for name, got in port.items():
        _close(got, plain, atol=ATOL_CACHE, rtol=RTOL_CACHE)
        _close(got, jax_out[name], atol=ATOL_CACHE, rtol=RTOL_CACHE)


@pytest.mark.parametrize("ignore_query", [True, False], ids=["ignore_query", "with_queries"])
def test_keyword_ids_equal_jax(batches, tables, ignore_query):
    _, _, jlk = tables["jax"]
    _, _, tlk = tables["port"]
    assert tlk == jlk
    grid = batches[ignore_query].query_input_ids
    got, want = th.keyword_ids(tlk, grid), jh.keyword_ids(jlk, grid)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    missing = grid.copy()
    missing[0, 0, 1] = 999  # a token row outside the table
    assert th.keyword_ids(tlk, missing) is None and jh.keyword_ids(jlk, missing) is None


def test_oov_fallback_is_title_only_and_counted(cfg, tok, gen, flagship):
    _, _, tenc = flagship
    qcfg = cfg.replace(ignore_query=False)
    data = [d for d in _product_sessions(gen, 40) if any(a[1] == "s" for a in d[0])][:6]
    kws = sorted({a[2] or "" for d in data for a in d[0] if a[1] == "s"})
    title = th.build_title_table(qcfg, tok, gen.titles, tenc, batch_size=256)
    qtable, lookup = th.build_keyword_table(qcfg, tok, kws[1:], tenc, batch_size=256)
    fn = th.make_cached_encode_fn(tenc, title, qtable, lookup)
    title_only = th.make_cached_encode_fn(tenc, title)
    pipe = th.EmbeddingPipeline(qcfg, tok, fn, device="cpu", batch_size=8)
    want = th.EmbeddingPipeline(qcfg, tok, title_only, device="cpu", batch_size=8)(data)
    np.testing.assert_array_equal(pipe(data), want)  # prepare(): host lookup
    assert fn.oov_batches == 1
    g = to_device(j_build_batch(data, tok, qcfg.dims, ignore_query=False), CPU)
    with torch.inference_mode():
        np.testing.assert_array_equal(fn(g).numpy(), want[: len(data)])  # lookup from g
    assert fn.oov_batches == 2 and title_only.oov_batches == 0
    full = th.make_cached_encode_fn(
        tenc, title, *th.build_keyword_table(qcfg, tok, kws, tenc, batch_size=256))
    th.EmbeddingPipeline(qcfg, tok, full, device="cpu", batch_size=8)(data)
    assert full.oov_batches == 0
    with pytest.raises(ValueError, match="kw_lookup"):
        th.make_cached_encode_fn(tenc, title, qtable)


# --- precision ----------------------------------------------------------------

def _bf16_bits(x):
    """bf16 values -> their 16 bits (numpy uint16), from either package."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_serving_params_policy_and_bits(recency):
    _, _, _, params, tenc = recency
    before = {k: v.clone() for k, v in tenc.state_dict().items()}
    served = t_precision.serving_params(tenc)
    assert served is not tenc
    for k, v in tenc.state_dict().items():  # the f32 module is left as it is
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k
    jserve = j_precision.serving_params(params)
    assert all(leaf.dtype == jnp.bfloat16 for leaf in jax.tree.leaves(jserve))
    # JAX's bf16 leaves widened to f32 (exact) under the port's names and layout
    want = flax_to_state_dict(jax.tree.map(np.asarray, jserve))
    embedders = {id(p) for m in served.modules() if isinstance(m, (TextEncoder, NodeAsinEmbedding))
                 for p in m.parameters()}
    assert len(embedders) > 0
    for name, p in served.named_parameters():
        in_bf16 = id(p) in embedders or p.dim() == 0
        assert p.dtype == (torch.bfloat16 if in_bf16 else torch.float32), name
        got = p.detach().to(torch.bfloat16)  # exact: every value is a bf16 value
        np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want[name].to(torch.bfloat16)),
                                      err_msg=name)
        np.testing.assert_array_equal(p.detach().float().numpy(), want[name].numpy(),
                                      err_msg=name)
    assert served.product_pooling.raw_lambda.dtype == torch.bfloat16
    assert t_precision.serving_params(tenc, use_bf16=False) is tenc


def test_cast_floats(flagship):
    _, _, tenc = flagship
    half = t_precision.cast_floats(tenc, torch.float16)
    assert all(p.dtype == torch.float16 for p in half.parameters())
    assert all(p.dtype == torch.float32 for p in tenc.parameters())


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _bf16_bounds(got, want):
    """Every row's cosine >= 0.999 and the largest |difference| <= 2^-6 of
    the largest |reference|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    cos = _cosines(got, want)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert cos.min() >= BF16_COS, f"min cosine {cos.min()}"
    assert rel <= BF16_REL, f"max |diff| / max |ref| = {rel}"


@pytest.mark.parametrize("forward", ["uncached", "title", "full"])
def test_bf16_serving_forward(cfg, tok, gen, data, batches, flagship, forward):
    fenc, params, tenc = flagship
    jserve = j_precision.serving_params(params)
    tserve = t_precision.serving_params(tenc)
    batch = batches[False]
    g = to_device(batch, CPU)
    with torch.inference_mode():
        f32 = tenc(g).numpy()
    if forward == "uncached":
        want = jax.jit(lambda b: fenc.apply(jserve, b))(batch)
        with torch.inference_mode():
            got = tserve(g)
    else:
        kws = sorted({a[2] or "" for d in data for a in d[0] if a[1] == "s"})
        jt = jh.build_title_table(cfg, tok, gen.titles, fenc, jserve, batch_size=256)
        tt = th.build_title_table(cfg, tok, gen.titles, tserve, batch_size=256)
        assert jt.dtype == jnp.bfloat16 and tt.dtype == torch.bfloat16
        if forward == "title":
            want = jh.make_cached_encode_fn(fenc, jserve, jt)(batch)
            fn = th.make_cached_encode_fn(tserve, tt)
        else:
            jq, jlk = jh.build_keyword_table(cfg, tok, kws, fenc, jserve, batch_size=256)
            tq, tlk = th.build_keyword_table(cfg, tok, kws, tserve, batch_size=256)
            want = jh.make_cached_encode_fn(fenc, jserve, jt, jq, jlk)(batch)
            fn = th.make_cached_encode_fn(tserve, tt, tq, tlk)
        with torch.inference_mode():
            got = fn(g)
        assert fn.oov_batches == 0
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    _bf16_bounds(got.numpy(), want)
    assert _cosines(got.numpy(), f32).min() >= 0.98


def _torch_bf16(x):
    """A JAX bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(torch.bfloat16)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("ignore_query", [True, False], ids=["ignore_query", "with_queries"])
def test_bf16_policy_past_the_text_backbone(cfg, tok, gen, data, batches, flagship,
                                            ignore_query):
    """The bounds above hold the bf16 forwards to a tolerance but cannot pin
    the policy: the two packages' bf16 text backbones round in another order,
    and differ from each other by about as much as bf16 differs from f32.
    Given JAX's own bf16 tables, the fully cached forward runs no text
    backbone, and the rest of the policy (bf16 gathers, f32 GNN and pooling
    on bf16-rounded weights) agrees to POLICY_REL, which the f32 forward on
    the same tables misses."""
    fenc, params, tenc = flagship
    jserve = j_precision.serving_params(params)
    tserve = t_precision.serving_params(tenc)
    batch = batches[ignore_query]
    kws = sorted({a[2] or "" for d in data for a in d[0] if a[1] == "s"})
    jt = jh.build_title_table(cfg, tok, gen.titles, fenc, jserve, batch_size=256)
    jq, jlk = jh.build_keyword_table(cfg, tok, kws, fenc, jserve, batch_size=256)
    want = jh.make_cached_encode_fn(fenc, jserve, jt, jq, jlk)(batch)
    tt, tq = _torch_bf16(jt), _torch_bf16(jq)
    kw = torch.from_numpy(th.keyword_ids(jlk, batch.query_input_ids))
    g = to_device(batch, CPU)
    with torch.inference_mode():
        bf16 = tserve(g, title_table=tt, query_table=tq, query_kw=kw)
        f32 = tenc(g, title_table=tt.float(), query_table=tq.float(), query_kw=kw)
    assert _rel(bf16, want) <= POLICY_REL, f"bf16 policy: {_rel(bf16, want)}"
    assert _rel(f32, want) > POLICY_REL, f"the f32 forward passes: {_rel(f32, want)}"
