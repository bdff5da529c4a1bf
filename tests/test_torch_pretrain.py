"""The port's pretrainer against the JAX package's, step for step.

Four configurations of ``tiny_test_config()``: ``default`` (the active
next-product objective, auxiliaries off), ``aux`` (every auxiliary on:
ph/qh/pt/qaea/node/token/ctv > 0), ``wd`` (AdamW, ``weight_decay > 0``) and
``cached`` (the ``tables=`` step on title and keyword tables). Both sides
start from the JAX init, carried across by ``weights.load_flax_train_state``
(strict), take one train step on the same numpy-seeded batch, and the JAX
step's random draws (node keep-masks, negative samples, token corruption,
from the key split of ``pretrain.py:124-153``) are passed to the port.

Tolerances (float32 on the CPU on both sides, summed in other orders):

- the loss and every metric: rtol 1e-5, atol 1e-6;
- every gradient leaf after the clip: atol 2e-5 of the largest |gradient|
  of the whole tree, rtol 1e-4;
- the BatchNorm statistics after the step: rtol 1e-5, atol 1e-6;
- the Adam moments after the step: mu (0.1 g) within rtol 1e-4 and 0.1 x
  the gradient bound, nu (0.001 g^2) within rtol 1e-3 and 0.004 x the
  square of the gradient bound;
- the parameters after the step: atol 1e-6, rtol 1e-6, on the elements
  whose first Adam update g / (|g| + 1e-8) is the same to 1e-3 from either
  side's gradient (at least 90% of all elements). One Adam step moves a
  parameter by that update times lr, about lr * sign(g), so where |g| is at
  rounding level (the biases before a BatchNorm, whose gradient is 0 up to
  rounding) the move, up to 2 lr, is not determined by the gradient; the
  moments hold those elements instead;
- the eval step, ``encode`` and ``retrieval_metrics`` on the JAX state
  after the step: rtol 1e-5, atol 1e-5 of the largest |output|;
- the cached (``tables=``) step against the uncached one: rtol 1e-5 (the
  JAX package's own bound, tests/test_pretrain.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sessionsimilaritysearch_tpu.config import tiny_test_config as j_tiny
from sessionsimilaritysearch_tpu.data import SyntheticSessionGenerator as JGen
from sessionsimilaritysearch_tpu.data import build_graph_batch as j_build_batch
from sessionsimilaritysearch_tpu.data.augment import random_exchange_order
from sessionsimilaritysearch_tpu.evalharness import harness as jh
from sessionsimilaritysearch_tpu.models.encoder import build_pretrain_encoder as j_build_enc
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu.training import losses as j_losses
from sessionsimilaritysearch_tpu.training import pretrain as jp
from sessionsimilaritysearch_tpu.training.train_state import TrainState as JState
from sessionsimilaritysearch_tpu.training.train_state import adam_with_clip as j_adam
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config as t_tiny
from sessionsimilaritysearch_tpu_torch.data.graph import SessionGraph
from sessionsimilaritysearch_tpu_torch.evalharness import harness as th
from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
from sessionsimilaritysearch_tpu_torch.training import pretrain as tp
from sessionsimilaritysearch_tpu_torch.weights import load_flax_train_state, torch_key

CPU = torch.device("cpu")
AUX = dict(ph_w=0.1, qh_w=0.1, pt_w=0.1, qaea_w=0.1, node_w=0.1, token_w=0.1, ctv_w=0.1)
CONFIGS = {"default": {}, "aux": AUX, "wd": dict(weight_decay=0.01), "cached": {}}
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-6
GRAD_REL, GRAD_RTOL = 2e-5, 1e-4
BN_RTOL, BN_ATOL = 1e-5, 1e-6
PARAM_TOL = 1e-6
SURE_U, SURE_SHARE = 1e-3, 0.9


def _first_update(g):
    """The first Adam step's update before the learning rate: mu_hat /
    (sqrt(nu_hat) + eps) with mu_hat = g and nu_hat = g^2."""
    g = g.astype(np.float64)
    return g / (np.abs(g) + 1e-8)
OUT_RTOL, OUT_REL = 1e-5, 1e-5


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _jax_layout(path, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.T if path[-1] == "kernel" else a


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_draws(cfg, batch, rng):
    """The random parts of JAX's step (pretrain.py:124-153), as numpy."""
    r_qmask, r_pmask, r_neg1, r_neg2, r_tok = jax.random.split(rng, 5)
    B, A = batch.query_node_mask.shape[0], cfg.asin_num

    def keep(key, mask):
        return np.asarray(jax.random.uniform(key, mask.shape) > cfg.node_mask_prob,
                          np.float32)

    d = {"query_node_mask": keep(r_qmask, batch.query_node_mask),
         "product_node_mask": keep(r_pmask, batch.product_node_mask),
         "neg_next": np.asarray(jax.random.uniform(r_neg1, (B, A)) < cfg.neg_sample_count / A),
         "neg_all": np.asarray(jax.random.uniform(r_neg2, (B, A)) < cfg.neg_sample_count / A)}
    if cfg.token_w > 0:
        r_tok, r_tok2 = jax.random.split(r_tok)
        d["query_corrupt"] = np.asarray(j_losses.make_token_mask(
            r_tok, jnp.asarray(batch.query_input_ids), cfg.mask_token_ratio))
        d["product_corrupt"] = np.asarray(j_losses.make_token_mask(
            r_tok2, jnp.asarray(batch.product_input_ids), cfg.mask_token_ratio))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _port_graph(batch):
    return to_device(SessionGraph(*(np.asarray(a) for a in batch)), CPU)


@pytest.fixture(scope="module")
def shared():
    """Sessions with products (asin 0's placeholder node gathers asin 0's
    real title under a title table), a batch and a view batch."""
    cfg = j_tiny()
    tok = get_tokenizer(cfg.vocab_size)
    gen = JGen(asin_num=cfg.asin_num, seed=11)
    data = [d for d in gen.dataset(40) if any(a[1] != "s" for a in d[0])][:16]
    rng = np.random.default_rng(0)
    view = [random_exchange_order(d, rng) for d in data]
    return {"tok": tok, "gen": gen, "data": data,
            "batch": j_build_batch(data, tok, cfg.dims),
            "view": j_build_batch(view, tok, cfg.dims), "cache": {}}


def _tables(shared, jcfg, jparams, tmodel):
    """Title and keyword tables of both packages from the same weights, and
    the batch's keyword ids."""
    tok, gen, data = shared["tok"], shared["gen"], shared["data"]
    kws = sorted({a[2] or "" for d in data for a in d[0] + d[1] if a[1] == "s"})
    enc_mod, enc_vars = j_build_enc(jcfg), {"params": jparams["encoder"]}
    j_title = jh.build_title_table(jcfg, tok, gen.titles, enc_mod, enc_vars, batch_size=256)
    j_q, j_lookup = jh.build_keyword_table(jcfg, tok, kws, enc_mod, enc_vars, batch_size=256)
    kw = jh.keyword_ids(j_lookup, np.asarray(shared["batch"].query_input_ids))
    assert kw is not None, "the keyword table must cover the batch"
    tcfg = t_tiny()
    t_title = th.build_title_table(tcfg, tok, gen.titles, tmodel.encoder, batch_size=256)
    t_q, t_lookup = th.build_keyword_table(tcfg, tok, kws, tmodel.encoder, batch_size=256)
    t_kw = th.keyword_ids(t_lookup, np.asarray(shared["batch"].query_input_ids))
    return ({"title_table": j_title, "query_table": j_q, "query_kw": jnp.asarray(kw)},
            {"title_table": t_title, "query_table": t_q, "query_kw": torch.from_numpy(t_kw)})


def _build(shared, name):
    overrides = CONFIGS[name]
    jcfg, tcfg = j_tiny(**overrides), t_tiny(**overrides)
    batch = jax.tree.map(jnp.asarray, shared["batch"])
    view = jax.tree.map(jnp.asarray, shared["view"]) if jcfg.ctv_w > 0 else None
    rng = jax.random.PRNGKey(3)
    model = jp.PretrainModel(jcfg)
    variables = jax.jit(lambda r, b: model.init(r, b, r, deterministic=True))(
        jax.random.PRNGKey(0), batch)
    tx = j_adam(jcfg.lr, jcfg.grad_clip_norm, jcfg.weight_decay)
    jstate = JState.create(apply_fn=model.apply, params=variables["params"], tx=tx,
                           batch_stats=variables["batch_stats"])

    # the port from the JAX init, with its (zero) Adam state
    tmodel, tstate = tp.create_pretrain_state(tcfg, CPU)
    load_flax_train_state(tstate, jax.tree.map(np.asarray, {
        "step": jstate.step, "params": jstate.params, "batch_stats": jstate.batch_stats,
        "opt_state": jstate.opt_state}))

    j_tables = t_tables = None
    if name == "cached":
        j_tables, t_tables = _tables(shared, jcfg, jstate.params, tmodel)

    @jax.jit
    def jstep(state, batch, rng, view, tables):
        # make_train_step's step (pretrain.py:304-333), with its gradients
        def loss_fn(params):
            (loss, metrics), upd = state.apply_fn(
                {"params": params, "batch_stats": state.batch_stats}, batch, rng, view,
                deterministic=False, tables=tables, mutable=["batch_stats"],
                rngs={"dropout": rng})
            return loss, (metrics, upd["batch_stats"])

        grads, (metrics, new_bs) = jax.grad(loss_fn, has_aux=True)(state.params)
        clipped, _ = optax.clip_by_global_norm(jcfg.grad_clip_norm).update(grads, None)
        new = state.apply_gradients(grads=grads).replace(batch_stats=new_bs)
        return new, metrics, clipped

    jnew, jmetrics, jgrads = jstep(jstate, batch, rng, view, j_tables)

    draws = jax_draws(jcfg, shared["batch"], rng)
    tgraph = _port_graph(shared["batch"])
    tview = _port_graph(shared["view"]) if view is not None else None
    step = tp.make_train_step(tmodel, has_view=view is not None)
    tstate, tmetrics = step(tstate, tgraph, tview, t_tables, draws)
    return {"name": name, "jcfg": jcfg, "tcfg": tcfg, "jmodel": model, "jstate": jstate,
            "jnew": jnew, "jmetrics": jmetrics, "jgrads": jgrads, "tmodel": tmodel,
            "tstate": tstate, "tmetrics": tmetrics, "tgraph": tgraph, "batch": batch,
            "rng": rng, "j_tables": j_tables, "t_tables": t_tables}


def _run(shared, name):
    cache = shared["cache"]
    if name not in cache:
        cache[name] = _build(shared, name)
    return cache[name]


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request, shared):
    return _run(shared, request.param)


def _grad_bound(run):
    return GRAD_REL * max(float(np.abs(g).max()) for _, g in _leaves(run["jgrads"]))


def _named(run):
    return dict(run["tmodel"].named_parameters())


def test_loss_and_every_metric(run):
    jm, tm = run["jmetrics"], run["tmetrics"]
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg=k)
    assert np.isfinite(float(tm["loss"])) and run["tstate"].step == 1


def test_every_gradient_leaf_after_the_clip(run):
    named, bound = _named(run), _grad_bound(run)
    leaves = list(_leaves(run["jgrads"]))
    assert len(leaves) == len(named)
    for path, g in leaves:
        got = _jax_layout(path, named[torch_key(path)].grad)
        np.testing.assert_allclose(got, g, atol=bound, rtol=GRAD_RTOL,
                                   err_msg=torch_key(path))


def test_batch_stats_after_the_step(run):
    buffers = dict(run["tmodel"].named_buffers())
    leaves = list(_leaves(run["jnew"].batch_stats))
    assert len(leaves) == len(buffers) > 0
    for path, v in leaves:
        np.testing.assert_allclose(_np(buffers[torch_key(path)]), v, rtol=BN_RTOL,
                                   atol=BN_ATOL, err_msg=torch_key(path))


def _adam(run):
    opt = run["tstate"].optimizer
    named = _named(run)
    return {name: opt.state[p] for name, p in named.items()}


def test_adam_moments_after_the_step(run):
    from sessionsimilaritysearch_tpu_torch.weights import _adam_state

    adam, bound = _adam(run), _grad_bound(run)
    jadam = _adam_state(run["jnew"].opt_state)
    assert int(jadam["count"]) == 1
    for (path, mu), (_, nu) in zip(_leaves(jadam["mu"]), _leaves(jadam["nu"])):
        st = adam[torch_key(path)]
        assert float(st["step"]) == 1.0
        np.testing.assert_allclose(_jax_layout(path, st["exp_avg"]), mu, rtol=GRAD_RTOL,
                                   atol=0.1 * bound, err_msg=torch_key(path))
        np.testing.assert_allclose(_jax_layout(path, st["exp_avg_sq"]), nu, rtol=1e-3,
                                   atol=0.001 * bound * bound * 4, err_msg=torch_key(path))


def test_parameters_after_the_step(run):
    named = _named(run)
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


def _port_after(run):
    """A fresh port state loaded with JAX's state after the step."""
    model, state = tp.create_pretrain_state(run["tcfg"], CPU)
    j = run["jnew"]
    load_flax_train_state(state, jax.tree.map(np.asarray, {
        "step": j.step, "params": j.params, "batch_stats": j.batch_stats,
        "opt_state": j.opt_state}))
    assert state.step == 1
    return model, state


def _out_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=OUT_RTOL,
                               atol=OUT_REL * max(float(np.abs(want).max()), 1.0))


def test_eval_step(run):
    model, state = _port_after(run)
    rng = jax.random.PRNGKey(9)
    want = jp.make_eval_step(run["jmodel"])(run["jnew"], run["batch"], rng)
    got = tp.make_eval_step(model)(state, run["tgraph"],
                                   draws=jax_draws(run["jcfg"], run["batch"], rng))
    assert set(got) == set(want)
    for k in want:
        _out_close(got[k], want[k])


def test_encode(run):
    model, state = _port_after(run)
    want = jp.make_encode_fn(run["jmodel"])(run["jnew"], run["batch"])
    _out_close(tp.make_encode_fn(model)(state, run["tgraph"]), want)


def test_retrieval_metrics(run):
    model, _ = _port_after(run)
    j = run["jnew"]
    fn = jax.jit(lambda v, b: run["jmodel"].apply(v, b, 5,
                                                   method=run["jmodel"].retrieval_metrics))
    want = fn({"params": j.params, "batch_stats": j.batch_stats}, run["batch"])
    with torch.no_grad():
        got = model.retrieval_metrics(run["tgraph"], 5)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), abs=1e-6)


def test_tables_step_matches_the_uncached_step(shared):
    """The port's cached-table step against its own uncached step from the
    same state and draws: the frozen backbone makes the gather the same
    forward."""
    run = _run(shared, "cached")
    model, state = _port_after(run)
    step = tp.make_train_step(model)
    draws = jax_draws(run["jcfg"], shared["batch"], jax.random.PRNGKey(4))
    _, cached = step(state, run["tgraph"], tables=run["t_tables"], draws=draws)
    model2, state2 = _port_after(run)
    _, uncached = tp.make_train_step(model2)(state2, run["tgraph"], draws=draws)
    np.testing.assert_allclose(_np(cached["loss"]), _np(uncached["loss"]), rtol=1e-5)
    for name, p in model.named_parameters():
        if not name.startswith("encoder.query_node_embedder"):
            np.testing.assert_allclose(_np(p), _np(dict(model2.named_parameters())[name]),
                                       atol=2e-5, err_msg=name)


def test_adamw_decays_the_frozen_backbone_like_jax(shared):
    """optax.adamw decays the zero-gradient text backbone; torch would skip a
    parameter without a gradient, so the port fills zeros first."""
    run = _run(shared, "wd")
    cfg, named = run["jcfg"], _named(run)
    moved = 0
    for path, new in _leaves(run["jnew"].params["encoder"]["query_node_embedder"]):
        old = np.asarray(_leaf(run["jstate"].params["encoder"]["query_node_embedder"], path))
        np.testing.assert_allclose(new, old * (1 - cfg.lr * cfg.weight_decay), rtol=1e-6)
        got = _jax_layout(path, named[torch_key(("encoder", "query_node_embedder") + path)])
        np.testing.assert_allclose(got, new, rtol=1e-6, atol=1e-9)
        moved += int((new != old).sum())
    assert moved > 0


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def test_cached_tables_refuse_token_auxiliaries(shared):
    run = _run(shared, "aux")
    with pytest.raises(ValueError, match="cached text tables"):
        run["tmodel"](run["tgraph"], run["tstate"].generator,
                      tables={"title_table": torch.zeros(1, 1)})


def test_port_draws_follow_the_config(shared):
    """The port's own draws: keep-masks at 1 - node_mask_prob, about
    neg_sample_count negatives a row, corruption only of maskable ids."""
    run = _run(shared, "aux")
    cfg, g = run["tcfg"], torch.Generator().manual_seed(0)
    d = run["tmodel"].draw(run["tgraph"], g)
    assert set(d) == {"query_node_mask", "product_node_mask", "neg_next", "neg_all",
                      "query_corrupt", "product_corrupt"}
    assert d["query_node_mask"].dtype == torch.float32
    assert abs(float(d["neg_next"].float().sum(1).mean()) - cfg.neg_sample_count) < 10
    ids = run["tgraph"].product_input_ids
    assert not bool((d["product_corrupt"] & (ids < 5)).any())


# ---------------------------------------------------------------------------
# each loss alone against JAX's, on seeded random inputs
# ---------------------------------------------------------------------------

def _loss_inputs():
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ids = rng.integers(0, 40, (4, 6, 7)).astype(np.int32)
    corrupt = np.where(rng.random(ids.shape) < 0.3, 4, ids).astype(np.int32)
    return {
        "contrastive_loss": ((f(6, 8), f(6, 8)), {}),
        "electra_loss": ((rng.random((4, 6, 7)).astype(np.float32), corrupt, ids,
                          (rng.random((4, 6, 7)) < 0.8).astype(np.float32)), {}),
        "all_text_embedding_loss": ((f(4, 8), f(4, 5, 8),
                                     (rng.random((4, 5)) < 0.7).astype(np.float32),
                                     (rng.random((4, 5)) < 0.5).astype(np.float32)), {}),
        "node_reconstruction_loss": ((f(4, 5, 8), f(4, 5, 8),
                                      (rng.random((4, 5)) < 0.6).astype(np.float32),
                                      (rng.random((4, 5)) < 0.8).astype(np.float32)), {}),
        "qaea_distill_loss": ((f(6, 8), f(6, 8)), {}),
        "cosine_similarity": ((f(6, 8), np.zeros((6, 8), np.float32)), {}),
    }


@pytest.mark.parametrize("name", list(_loss_inputs()))
def test_loss_function_matches_jax(name):
    from sessionsimilaritysearch_tpu_torch.training import losses as t_losses

    args, kw = _loss_inputs()[name]
    want = getattr(j_losses, name)(*(jnp.asarray(a) for a in args), **kw)
    got = getattr(t_losses, name)(*(torch.from_numpy(a) for a in args), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_asin_losses_keep_a_target_at_asin_zero():
    """The one-hot is a scatter-max: a padded target (asin 0, mask 0) must
    not erase a real target at asin 0; the loss and top-k metrics follow."""
    from sessionsimilaritysearch_tpu_torch.training import losses as t_losses

    rng = np.random.default_rng(6)
    y = np.array([[0, 3, 0, 0], [5, 0, 0, 0], [2, 2, 7, 0]], np.int32)
    m = np.array([[1, 1, 0, 0], [1, 0, 0, 0], [1, 1, 1, 0]], np.float32)
    want = np.asarray(j_losses.product_target_onehot(jnp.asarray(y), jnp.asarray(m), 9))
    got = _np(t_losses.product_target_onehot(torch.from_numpy(y), torch.from_numpy(m), 9))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 1.0 and got[1, 0] == 0.0
    rep = rng.standard_normal((3, 8)).astype(np.float32)
    table = rng.standard_normal((9, 8)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    # JAX draws its negatives from the key: rebuild them as the function does
    jneg = np.asarray(jax.random.uniform(key, (3, 9)) < 4 / 9)
    want = j_losses.product_asin_loss(key, jnp.asarray(rep), jnp.asarray(table),
                                      jnp.asarray(y), jnp.asarray(m), 4)
    got = t_losses.product_asin_loss(torch.from_numpy(rep), torch.from_numpy(table),
                                     torch.from_numpy(y), torch.from_numpy(m),
                                     torch.from_numpy(np.array(jneg)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    for k in (1, 3):
        w = j_losses.product_asin_precision_recall(jnp.asarray(rep), jnp.asarray(table),
                                                   jnp.asarray(y), jnp.asarray(m), k)
        g = t_losses.product_asin_precision_recall(torch.from_numpy(rep),
                                                   torch.from_numpy(table),
                                                   torch.from_numpy(y), torch.from_numpy(m), k)
        np.testing.assert_allclose([float(v) for v in g], [float(v) for v in w], atol=1e-6)
