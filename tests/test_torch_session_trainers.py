"""The port's session trainers against the JAX package's, module by module
and step for step.

Modules alone (seeded numpy inputs, JAX's weights carried across by
``weights.flax_to_state_dict``): ``DecoderLayer`` with a causal mask and
all-padding rows, ``NodeTextTransformer`` with padding, ``HeteroSAGE`` with
each conv (SAGE / GCN / GAT), ``GraphPooling`` with each key (tied 'sort'
keys included), and the query-generation losses.

One full train step in four configurations of ``tiny_test_config()``:
scratch subsession autoregressive, scratch session ``mlm_electra``, flagship
subsession (autoregressive) and the scratch ``JointModel``. Both sides start
from the same weights (the port's seeded init, written into JAX's tree of
``jax.eval_shape(init)``, and carried back by
``weights.load_flax_train_state``, strict), take one step on the same
numpy-seeded batch, and JAX's random draws (the key splits of
``session_trainers.py:156``, ``:209``, ``:270``) are passed to the port as
``draws=``. Then JAX's state after the step is loaded into a fresh port
state, whose next step on a second batch must give JAX's loss.

Tolerances (float32 on the CPU on both sides, summed in other orders; PR
11's rule for the pretrainer):

- modules: rtol 1e-5, atol 1e-5 of the largest |output|;
- the loss and every metric: rtol 1e-5, atol 1e-6;
- the Adam moments after the step: mu (0.1 g) within rtol 1e-4 and 0.1 x
  the gradient bound (2e-5 of the largest |gradient|), and nu (0.001 g^2)
  as |g| = sqrt(nu / 0.001), within rtol 1e-4 and the gradient bound;
- the parameters after the step: atol 1e-6, rtol 1e-6, on the elements
  whose first Adam update g / (|g| + 1e-8) is the same to 1e-3 from either
  side's gradient (at least 90% of all elements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sessionsimilaritysearch_tpu.config import tiny_test_config as j_tiny
from sessionsimilaritysearch_tpu.data import SyntheticSessionGenerator as JGen
from sessionsimilaritysearch_tpu.data.graph import (
    batch_graphs,
    sequence_to_graph,
    truncate_to_subsession,
)
from sessionsimilaritysearch_tpu.models import embedding as j_emb
from sessionsimilaritysearch_tpu.models import gnn as j_gnn
from sessionsimilaritysearch_tpu.models import pooling as j_pool
from sessionsimilaritysearch_tpu.models import transformer as j_tr
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu.training import losses as j_losses
from sessionsimilaritysearch_tpu.training import session_trainers as jst
from sessionsimilaritysearch_tpu.training.train_state import TrainState as JState
from sessionsimilaritysearch_tpu.training.train_state import adam_with_clip as j_adam
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config as t_tiny
from sessionsimilaritysearch_tpu_torch.data.graph import SessionGraph
from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
from sessionsimilaritysearch_tpu_torch.models import embedding as t_emb
from sessionsimilaritysearch_tpu_torch.models import gnn as t_gnn
from sessionsimilaritysearch_tpu_torch.models import pooling as t_pool
from sessionsimilaritysearch_tpu_torch.models import transformer as t_tr
from sessionsimilaritysearch_tpu_torch.training import losses as t_losses
from sessionsimilaritysearch_tpu_torch.training import session_trainers as tst
from sessionsimilaritysearch_tpu_torch.weights import (
    _adam_state,
    flax_to_state_dict,
    load_flax_train_state,
    torch_key,
)

CPU = torch.device("cpu")
MOD_RTOL, MOD_REL = 1e-5, 1e-5
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-6
GRAD_REL, GRAD_RTOL = 2e-5, 1e-4
PARAM_TOL = 1e-6
SURE_U, SURE_SHARE = 1e-3, 0.9
# name -> (kind, mode, query_loss_style, encoder_kind)
CONFIGS = {
    "scratch_subsession_autoregressive": ("single", "subsession", "autoregressive", "scratch"),
    "scratch_session_mlm_electra": ("single", "session", "mlm_electra", "scratch"),
    "flagship_subsession": ("single", "subsession", "autoregressive", "flagship"),
    "joint": ("joint", None, "mlm_electra", "scratch"),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _jax_layout(path, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.T if path[-1] == "kernel" else a


def _first_update(g):
    g = g.astype(np.float64)
    return g / (np.abs(g) + 1e-8)


def _close(got, want, rtol=MOD_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=MOD_REL * max(float(np.abs(want).max()), 1.0))


def _port(module, variables):
    """Load JAX ``variables`` into the port ``module`` (strict)."""
    module.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, variables)),
                           strict=True)
    return module


# ---------------------------------------------------------------------------
# the new modules alone
# ---------------------------------------------------------------------------

def test_decoder_layer_with_causal_mask_and_all_padding_rows():
    rng = np.random.default_rng(1)
    B, T, S, D = 4, 6, 3, 16
    tgt = rng.standard_normal((B, T, D)).astype(np.float32)
    mem = rng.standard_normal((B, S, D)).astype(np.float32)
    pad = rng.random((B, T)) < 0.3
    pad[1] = True                      # a session with no target query
    pad[2, 0] = True                   # causal row 0 sees only a padded key
    mem_pad = np.zeros((B, S), bool)
    mem_pad[3, 1:] = True
    jm = j_tr.TransformerDecoder(D, 2, 32, 2)
    args = (jnp.asarray(tgt), jnp.asarray(mem), j_tr.causal_mask(T), jnp.asarray(pad),
            jnp.asarray(mem_pad))
    v = jm.init(jax.random.PRNGKey(0), *args)
    want = jm.apply(v, *args)
    tm = _port(t_tr.TransformerDecoder(D, 2, 32, 2), v)
    got = tm(_t(tgt), _t(mem), t_tr.causal_mask(T), _t(pad), _t(mem_pad))
    _close(got, want)
    assert np.isfinite(_np(got)).all()
    np.testing.assert_array_equal(_np(t_tr.causal_mask(T)), np.asarray(j_tr.causal_mask(T)))


def test_sinusoidal_table_is_the_jax_one():
    np.testing.assert_array_equal(t_tr.sinusoidal_pe(30, 200), j_tr.sinusoidal_pe(30, 200))


def test_node_text_transformer_with_padding():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 50, (5, 7)).astype(np.int32)
    att = (np.arange(7)[None, :] < np.array([7, 4, 1, 0, 3])[:, None]).astype(np.int32)
    jm = j_emb.NodeTextTransformer(50, 16, 2, 32, 2, dropout=0.0)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(att))
    want = jm.apply(v, jnp.asarray(ids), jnp.asarray(att))
    tm = _port(t_emb.NodeTextTransformer(50, 16, 2, 32, 2, dropout=0.0), v)
    _close(tm(_t(ids), _t(att)), want)


@pytest.fixture(scope="module")
def shared():
    cfg = j_tiny()
    tok = get_tokenizer(cfg.vocab_size)
    gen = JGen(asin_num=cfg.asin_num, seed=0)
    rng = np.random.default_rng(0)

    def batches(data):
        session, sub = [], []
        for i, (seq, tar) in enumerate(data):
            full = list(seq) + list(tar)
            session.append(sequence_to_graph(i, full, full, tok, cfg.dims))
            pre, fut = truncate_to_subsession((full, []), rng)
            sub.append(sequence_to_graph(i, pre, fut, tok, cfg.dims))
        return batch_graphs(session), batch_graphs(sub)

    first, second = batches(gen.dataset(8)), batches(gen.dataset(8))
    return {"session": first[0], "subsession": first[1], "session2": second[0],
            "subsession2": second[1], "cache": {}}


def _port_graph(batch):
    return to_device(SessionGraph(*(np.asarray(a) for a in batch)), CPU)


@pytest.mark.parametrize("conv_key", ["SAGE", "GCN", "GAT"])
def test_hetero_sage(shared, conv_key):
    rng = np.random.default_rng(3)
    batch = shared["subsession"]
    B, Q, P = (*batch.query_node_mask.shape, batch.product_node_mask.shape[1])
    x = {"query": rng.standard_normal((B, Q, 16)).astype(np.float32),
         "product": rng.standard_normal((B, P, 24)).astype(np.float32)}
    jm = j_gnn.HeteroSAGE(32, 8, conv_key)
    jx = {k: jnp.asarray(a) for k, a in x.items()}
    jg = jax.tree.map(jnp.asarray, batch)
    v = jm.init(jax.random.PRNGKey(2), jx, jg)
    want = jm.apply(v, jx, jg)
    tm = _port(t_gnn.HeteroSAGE(16, 24, 32, 8, conv_key), v)
    got = tm({k: _t(a) for k, a in x.items()}, _port_graph(batch))
    for k in want:
        _close(got[k], want[k])


def test_hetero_sage_refuses_an_unknown_conv():
    with pytest.raises(ValueError, match="GAT, GCN or SAGE"):
        t_gnn.HeteroSAGE(4, 4, 4, 4, "GIN")


@pytest.mark.parametrize("key", ["mean", "add", "max", "sort"])
def test_graph_pooling(key):
    rng = np.random.default_rng(4)
    B, N, d = 5, 7, 6
    x = rng.standard_normal((B, N, d)).astype(np.float32)
    x[..., -1] = np.round(x[..., -1])  # ties of the 'sort' key
    x[0, :, -1] = 1.0                  # every node of a graph tied
    mask = (rng.random((B, N)) < 0.7).astype(np.float32)
    mask[1] = 0.0                      # an empty graph
    mask[2, :2] = 0.0
    jm = j_pool.GraphPooling(key, 3)
    v = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(mask))
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(mask))
    tm = _port(t_pool.GraphPooling(key, d, 3), v)
    got = tm(_t(x), _t(mask))
    _close(got, want)


def test_graph_pooling_sort_breaks_ties_by_the_lower_index():
    x = torch.zeros(1, 6, 2)
    x[0, :, 0] = torch.arange(6.0)
    x[0, :, 1] = torch.tensor([0.0, 2.0, 2.0, 1.0, 2.0, 2.0])
    pool = t_pool.GraphPooling("sort", 2, 1, sort_k=4)
    with torch.no_grad():
        pool.lin.weight.zero_()
        pool.lin.weight[0, 0::2] = torch.tensor([1000.0, 100.0, 10.0, 1.0])
        pool.lin.bias.zero_()
    # the four largest keys are the ties at nodes 1, 2, 4, 5, kept in that order
    with torch.no_grad():
        assert float(pool(x, torch.ones(1, 6))[0, 0]) == 1245.0


def _loss_case(name):
    rng = np.random.default_rng(6)
    B, T, V, d, K = 4, 6, 30, 8, 3
    y = rng.integers(0, V, (B, T)).astype(np.int32)
    y_mask = (rng.random((B, T)) < 0.8).astype(np.float32)
    y_mask[0] = 0.0
    key = jax.random.PRNGKey(7)
    if name == "make_mlm_target":
        want = j_losses.make_mlm_target(key, jnp.asarray(y), jnp.asarray(y_mask), 0.4, 4)
        draw = np.asarray(jax.random.uniform(key, y.shape) < 0.4) & (y >= 5)
        got = t_losses.make_mlm_target(None, _t(y), _t(y_mask), 0.4, 4, pred_target=_t(draw))
        return got, want
    if name == "next_query_mlm_loss":
        logits = rng.standard_normal((B, T, V)).astype(np.float32)
        pred = rng.random((B, T)) < 0.5
        return (t_losses.next_query_mlm_loss(_t(logits), _t(y), _t(pred)),
                j_losses.next_query_mlm_loss(jnp.asarray(logits), jnp.asarray(y),
                                             jnp.asarray(pred)))
    if name == "autoregressive_query_loss":
        dec = rng.standard_normal((B, T, d)).astype(np.float32)
        table = rng.standard_normal((V, d)).astype(np.float32)
        want = j_losses.autoregressive_query_loss(key, jnp.asarray(dec), jnp.asarray(y),
                                                  jnp.asarray(y_mask), jnp.asarray(table), K)
        neg_ids = np.asarray(jax.random.randint(key, (B, T - 1, K), 0, V))
        got = t_losses.autoregressive_query_loss(None, _t(dec), _t(y), _t(y_mask), _t(table),
                                                 K, neg_ids=_t(neg_ids))
        return got, want
    logits2 = rng.standard_normal((B, T, 2)).astype(np.float32)
    output = np.where(rng.random((B, T)) < 0.3, 1, y).astype(np.int32)
    return (t_losses.next_query_electra_loss(_t(logits2), _t(output), _t(y), _t(y_mask)),
            j_losses.next_query_electra_loss(jnp.asarray(logits2), jnp.asarray(output),
                                             jnp.asarray(y), jnp.asarray(y_mask)))


@pytest.mark.parametrize("name", ["make_mlm_target", "next_query_mlm_loss",
                                  "autoregressive_query_loss", "next_query_electra_loss"])
def test_query_generation_loss_matches_jax(name):
    got, want = _loss_case(name)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if np.asarray(w).dtype.kind in "biu":
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        else:
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# one train step of each configuration against JAX's
# ---------------------------------------------------------------------------

def _query_y(batch, mode):
    """The target query ids of ``_query_target`` (numpy)."""
    if mode == "subsession":
        return np.asarray(batch.query_target_input_ids)[:, 0, :]
    last = np.asarray(batch.query_node_mask).sum(1).astype(np.int64) - 1
    return np.take_along_axis(np.asarray(batch.query_input_ids), last[:, None, None], 1)[:, 0]


def jax_draws(cfg, batch, rng, mode, style):
    """The random parts of SessionEmbeddingModel.__call__ (:156-209) drawn
    from ``rng`` as JAX draws them."""
    r_neg, r_tok = jax.random.split(rng)
    B, A = batch.product_asin.shape[0], cfg.asin_num
    d = {"neg": np.asarray(jax.random.uniform(r_neg, (B, A)) < cfg.neg_sample_count / A)}
    y = _query_y(batch, mode)
    if style == "mlm_electra":
        _, r_mask = jax.random.split(r_tok)
        d["mlm_target"] = (np.asarray(jax.random.uniform(r_mask, y.shape)
                                      < max(cfg.mask_token_ratio, 0.05)) & (y >= 5))
    else:
        d["neg_ids"] = np.asarray(jax.random.randint(
            r_tok, (B, y.shape[1] - 1, cfg.neg_k), 0, cfg.vocab_size))
    return {k: _t(v) for k, v in d.items()}


def _draws(run, rng, which=""):
    cfg, (kind, mode, style, _) = run["jcfg"], CONFIGS[run["name"]]
    sh = run["shared"]
    if kind == "joint":
        r1, r2 = jax.random.split(rng)
        return {"session": jax_draws(cfg, sh["session" + which], r1, "session", style),
                "subsession": jax_draws(cfg, sh["subsession" + which], r2, "subsession",
                                        style)}
    return jax_draws(cfg, sh[mode + which], rng, mode, style)


def _inputs(run, which=""):
    """(JAX args, port args) of the model's call on the first or second batch."""
    kind, mode = CONFIGS[run["name"]][:2]
    names = ("session", "subsession") if kind == "joint" else (mode,)
    sh = run["shared"]
    return ([jax.tree.map(jnp.asarray, sh[n + which]) for n in names],
            [_port_graph(sh[n + which]) for n in names])


def _flax_tree(shapes, tmodel):
    """The Flax variables tree of ``shapes`` (``jax.eval_shape`` of an
    init) filled with the port model's parameters and BatchNorm buffers."""
    sd = tmodel.state_dict()

    def leaf(path, spec):
        keys = tuple(str(p.key) for p in path)
        a = sd[torch_key(keys[1:])].numpy()
        a = a.T if keys[-1] == "kernel" else a
        assert a.shape == spec.shape, (keys, a.shape, spec.shape)
        return jnp.asarray(a, spec.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _build(shared, name):
    kind, mode, style, enc = CONFIGS[name]
    jcfg, tcfg = j_tiny(), t_tiny()
    run = {"name": name, "jcfg": jcfg, "shared": shared}
    jin, tin = _inputs(run)
    rng = jax.random.PRNGKey(3)
    if kind == "joint":
        jmodel = jst.JointModel(jcfg, encoder_kind=enc)
        tmodel, tstate = tst.create_joint_state(tcfg, "cpu", encoder_kind=enc)
        tstep = tst.make_joint_train_step(tmodel)
    else:
        jmodel = jst.SessionEmbeddingModel(jcfg, mode=mode, query_loss_style=style,
                                           encoder_kind=enc)
        tmodel, tstate = tst.create_session_state(tcfg, "cpu", mode, enc,
                                                  query_loss_style=style)
        tstep = tst.make_session_train_step(tmodel)
    # both sides start from the port's init, carried into JAX's tree (traced,
    # not compiled: a JAX init would cost one more compile per configuration)
    shapes = jax.eval_shape(lambda r, *g: jmodel.init(r, *g, r, deterministic=True),
                            jax.random.PRNGKey(0), *jin)
    variables = _flax_tree(shapes, tmodel)
    jstate = JState.create(apply_fn=jmodel.apply, params=variables["params"],
                           tx=j_adam(jcfg.lr, jcfg.grad_clip_norm, jcfg.weight_decay),
                           batch_stats=variables["batch_stats"])
    load_flax_train_state(tstate, jax.tree.map(np.asarray, {
        "step": jstate.step, "params": jstate.params, "batch_stats": jstate.batch_stats,
        "opt_state": jstate.opt_state}))

    @jax.jit
    def jstep(state, rng, *graphs):
        # make_session_train_step's / make_joint_train_step's step
        # (session_trainers.py:296-338), with its clipped gradients
        def loss_fn(params):
            (loss, metrics), upd = state.apply_fn(
                {"params": params, "batch_stats": state.batch_stats}, *graphs, rng,
                deterministic=False, mutable=["batch_stats"], rngs={"dropout": rng})
            return loss, (metrics, upd["batch_stats"])

        grads, (metrics, bs) = jax.grad(loss_fn, has_aux=True)(state.params)
        clipped, _ = optax.clip_by_global_norm(jcfg.grad_clip_norm).update(grads, None)
        return state.apply_gradients(grads=grads).replace(batch_stats=bs), metrics, clipped

    jnew, jmetrics, jgrads = jstep(jstate, rng, *jin)
    tstate, tmetrics = tstep(tstate, *tin, draws=_draws(run, rng))

    # JAX's state after the step, loaded into a fresh port state: the next
    # step on the second batch (the same compiled JAX step)
    jin2, tin2 = _inputs(run, "2")
    rng2 = jax.random.PRNGKey(8)
    _, jm2, _ = jstep(jnew, rng2, *jin2)
    if kind == "joint":
        model2, state2 = tst.create_joint_state(tcfg, "cpu", encoder_kind=enc)
    else:
        model2, state2 = tst.create_session_state(tcfg, "cpu", mode, enc,
                                                  query_loss_style=style)
    load_flax_train_state(state2, jax.tree.map(np.asarray, {
        "step": jnew.step, "params": jnew.params, "batch_stats": jnew.batch_stats,
        "opt_state": jnew.opt_state}))
    step2 = tst.make_joint_train_step if kind == "joint" else tst.make_session_train_step
    _, tm2 = step2(model2)(state2, *tin2, draws=_draws(run, rng2, "2"))
    run.update(jnew=jnew, jmetrics=jmetrics, jgrads=jgrads, tmodel=tmodel, tstate=tstate,
               tmetrics=tmetrics, jm2=jm2, tm2=tm2, state2=state2)
    return run


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request, shared):
    cache = shared["cache"]
    if request.param not in cache:
        cache[request.param] = _build(shared, request.param)
    return cache[request.param]


def _grad_bound(run):
    return GRAD_REL * max(float(np.abs(g).max()) for _, g in _leaves(run["jgrads"]))


def test_loss_and_every_metric(run):
    jm, tm = run["jmetrics"], run["tmetrics"]
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg=k)
    assert np.isfinite(float(tm["loss"])) and run["tstate"].step == 1


def test_adam_moments_after_the_step(run):
    named = dict(run["tmodel"].named_parameters())
    opt, bound = run["tstate"].optimizer, _grad_bound(run)
    jadam = _adam_state(run["jnew"].opt_state)
    assert int(jadam["count"]) == 1
    leaves = list(zip(_leaves(jadam["mu"]), _leaves(jadam["nu"])))
    assert len(leaves) == len(named)
    for (path, mu), (_, nu) in leaves:
        st = opt.state[named[torch_key(path)]]
        assert float(st["step"]) == 1.0
        np.testing.assert_allclose(_jax_layout(path, st["exp_avg"]), mu, rtol=GRAD_RTOL,
                                   atol=0.1 * bound, err_msg=torch_key(path))
        # nu = 0.001 g^2: held as |g| = sqrt(nu / 0.001), to the gradient's bound
        np.testing.assert_allclose(np.sqrt(_jax_layout(path, st["exp_avg_sq"]) / 0.001),
                                   np.sqrt(nu / 0.001), rtol=GRAD_RTOL, atol=bound,
                                   err_msg=torch_key(path))


def test_parameters_after_the_step(run):
    named = dict(run["tmodel"].named_parameters())
    checked = 0
    for (path, new), (_, g) in zip(_leaves(run["jnew"].params), _leaves(run["jgrads"])):
        p = named[torch_key(path)]
        got, g_port = _jax_layout(path, p), _jax_layout(path, p.grad)
        sure = np.abs(_first_update(g) - _first_update(g_port)) <= SURE_U
        np.testing.assert_allclose(got[sure], new[sure], atol=PARAM_TOL, rtol=PARAM_TOL,
                                   err_msg=torch_key(path))
        checked += int(sure.sum())
    total = sum(p.numel() for p in named.values())
    assert checked >= SURE_SHARE * total, (checked, total)


def test_batch_stats_after_the_step(run):
    buffers = dict(run["tmodel"].named_buffers(remove_duplicate=False))
    leaves = list(_leaves(run["jnew"].batch_stats))
    assert leaves
    for path, v in leaves:
        np.testing.assert_allclose(_np(buffers[torch_key(path)]), v, rtol=1e-5, atol=1e-6,
                                   err_msg=torch_key(path))


def test_a_loaded_jax_state_gives_jax_loss(run):
    """JAX's state after the step through load_flax_train_state: the next
    step on another batch gives JAX's loss and metrics."""
    assert run["state2"].step == 2  # JAX's step 1, then one more
    for k in run["jm2"]:
        np.testing.assert_allclose(_np(run["tm2"][k]), np.asarray(run["jm2"][k]),
                                   rtol=METRIC_RTOL, atol=METRIC_ATOL, err_msg=k)


def test_encode_and_retrieval_metrics(shared):
    """The trained scratch model's encode and retrieval metrics against
    JAX's on JAX's state after the step."""
    run = shared["cache"].get("scratch_subsession_autoregressive") or _build(
        shared, "scratch_subsession_autoregressive")
    shared["cache"][run["name"]] = run
    jm = jst.SessionEmbeddingModel(run["jcfg"])
    v = {"params": run["jnew"].params, "batch_stats": run["jnew"].batch_stats}
    batch = jax.tree.map(jnp.asarray, shared["subsession"])
    model, state = tst.create_session_state(t_tiny(), "cpu")
    load_flax_train_state(state, jax.tree.map(np.asarray, {
        "step": run["jnew"].step, "params": run["jnew"].params,
        "batch_stats": run["jnew"].batch_stats, "opt_state": run["jnew"].opt_state}))
    g = _port_graph(shared["subsession"])
    with torch.no_grad():
        _close(model.encode(g), jm.apply(v, batch, method=jm.encode))
    for k in (1, 5):
        want = jm.apply(v, batch, k, method=jm.retrieval_metrics)
        got = model.retrieval_metrics(g, k)
        np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want],
                                   atol=1e-6)


def test_port_draws_follow_the_config(shared):
    cfg = t_tiny()
    g = _port_graph(shared["subsession"])
    for style, keys in (("autoregressive", {"neg", "neg_ids"}),
                        ("mlm_electra", {"neg", "mlm_target"})):
        model, state = tst.create_session_state(cfg, "cpu", query_loss_style=style)
        d = model.draw(g, state.generator)
        assert set(d) == keys
        assert d["neg"].shape == (8, cfg.asin_num)
        if style == "autoregressive":
            assert d["neg_ids"].shape == (8, cfg.token_len - 1, cfg.neg_k)
            assert int(d["neg_ids"].max()) < cfg.vocab_size
        else:
            y, _ = model._query_target(g)
            assert not bool((d["mlm_target"] & (y < 5)).any())
        _, m = tst.make_session_train_step(model)(state, g)  # its own draws
        assert np.isfinite(float(m["loss"]))


def test_flagship_token_table_gets_gradients_through_the_decoder(shared):
    """The flagship's text backbone is frozen, but its token table feeds the
    query decoder through token_table_proj: that gradient reaches it."""
    model, state = tst.create_session_state(t_tiny(), "cpu", encoder_kind="flagship")
    g = _port_graph(shared["subsession"])
    tst.make_session_train_step(model)(state, g)
    backbone = model.encoder.query_node_embedder
    assert float(backbone.tok_emb.weight.grad.abs().sum()) > 0
    assert float(backbone.encoder.layers[0].ffn_in.weight.grad.abs().sum()) == 0


def test_bad_options_raise():
    cfg = t_tiny()
    for kw in ({"mode": "x"}, {"query_loss_style": "x"}, {"encoder_kind": "x"}):
        with pytest.raises(ValueError):
            tst.SessionEmbeddingModel(cfg, **kw)


def test_run_training_drives_the_session_trainer(shared, tmp_path):
    """The CLI's train-{mode} wiring: run_training with the session step, a
    deterministic eval, checkpoints and a RunDir; a second run resumes from
    its 'latest' and replays the first run's next step."""
    from sessionsimilaritysearch_tpu_torch.training.loop import run_training
    from sessionsimilaritysearch_tpu_torch.utils.checkpoint import CheckpointManager
    from sessionsimilaritysearch_tpu_torch.utils.logging import RunDir

    cfg = t_tiny()
    batches = [SessionGraph(*(np.asarray(a) for a in shared[k]))
               for k in ("subsession", "subsession2")]

    def eval_fn_of(model):
        def eval_fn(state, graph):
            with torch.no_grad():
                return model(graph, state.generator, deterministic=True)[1]
        return eval_fn

    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    model, state = tst.create_session_state(cfg, "cpu")
    state, best = run_training(state=state, step_fn=tst.make_session_train_step(model),
                               eval_fn=eval_fn_of(model), train_loader=batches,
                               valid_loader=batches[:1], epochs=1, ckpt=ckpt,
                               rundir=RunDir(str(tmp_path / "run"), cfg, "subsession"))
    assert state.step == 2 and np.isfinite(best)
    assert "epoch 0" in open(tmp_path / "run" / "subsession.log").read()
    g = _port_graph(shared["subsession"])
    _, want = tst.make_session_train_step(model)(state, g)
    model2, state2 = tst.create_session_state(cfg, "cpu", generator=torch.Generator().manual_seed(5))
    state2, _ = run_training(state=state2, step_fn=tst.make_session_train_step(model2),
                             train_loader=[], epochs=1, ckpt=ckpt)
    assert state2.step == 2
    _, got = tst.make_session_train_step(model2)(state2, g)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-6, err_msg=k)
