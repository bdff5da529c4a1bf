"""The port's similarity fine-tuner against the JAX package's.

``FinetuneHeads`` at both parities, two alternating steps (parameters, both
Adam states and the step), ``shared_init``, ``make_valid_fn``,
``make_code_fns``, ``build_triplet_batches``, the fine-tune losses,
``BinarizeHead`` with its MLP, ``TextSessionEncoder`` and
``load_flax_finetune_state``. Inputs are made from numpy seeds; JAX's
weights are carried across by ``weights.load_flax_finetune_state`` /
``flax_to_state_dict`` (strict).

Tolerances (float32 on the CPU on both sides):

- losses, metrics and module outputs: rtol 1e-5, atol 1e-6 (module outputs:
  atol 1e-5 of the largest |output|);
- the Adam moments: mu (0.1 g) within rtol 1e-4 and atol 1e-9, nu
  (0.001 g^2) as |g| = sqrt(nu / 0.001) within rtol 1e-4 and atol 1e-8;
- the parameters: atol 1e-6, rtol 1e-6 on the elements whose Adam update
  g / (|g| + 1e-8) is the same to 1e-3 from either side's gradient (at
  least 90% of them), as for the pretrainer;
- hard codes: equal wherever |pre-activation| > 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sessionsimilaritysearch_tpu.config import tiny_test_config as j_tiny
from sessionsimilaritysearch_tpu.data import SyntheticSessionGenerator as JGen
from sessionsimilaritysearch_tpu.data import build_graph_batch as j_build_batch
from sessionsimilaritysearch_tpu.models import heads as j_heads
from sessionsimilaritysearch_tpu.models.encoder import build_text_session_encoder as j_bts
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu.training import finetune as jft
from sessionsimilaritysearch_tpu.training import losses as j_losses
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config as t_tiny
from sessionsimilaritysearch_tpu_torch.data.graph import SessionGraph
from sessionsimilaritysearch_tpu_torch.evalharness.harness import to_device
from sessionsimilaritysearch_tpu_torch.models import heads as t_heads
from sessionsimilaritysearch_tpu_torch.models.encoder import build_text_session_encoder
from sessionsimilaritysearch_tpu_torch.training import finetune as tft
from sessionsimilaritysearch_tpu_torch.training import losses as t_losses
from sessionsimilaritysearch_tpu_torch.weights import (
    _adam_state,
    flax_to_state_dict,
    load_flax_finetune_state,
    torch_key,
)

RTOL, ATOL = 1e-5, 1e-6
MU_ATOL, G_ATOL, MOMENT_RTOL = 1e-9, 1e-8, 1e-4
PARAM_TOL, SURE_U, SURE_SHARE = 1e-6, 1e-3, 0.9
CODE_MARGIN = 1e-6
EMB = 24


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _jax_layout(path, t):
    a = _np(t)
    return a.T if path[-1] == "kernel" else a


def _arrays(seed, b=6, d=EMB):
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [g(b, d), g(b, d), g(b, d), g(b, d), rng.random(b).astype(np.float32),
            rng.random(b).astype(np.float32), rng.random(b).astype(np.float32),
            g(b, d), g(b, d)]


def _batches(seed):
    a = _arrays(seed)
    return (jft.TripletBatch(*(jnp.asarray(x) for x in a)),
            tft.TripletBatch(*(torch.from_numpy(x) for x in a)))


def _tree(state):
    return jax.tree.map(np.asarray, state._asdict())


def _pair(shared_init=False, **kw):
    """A JAX fine-tune state and a port state loaded from it."""
    jcfg, tcfg = j_tiny(**kw), t_tiny(**kw)
    jmodel, jstate, tx = jft.create_finetune_state(jcfg, jax.random.PRNGKey(0), emb_dim=EMB,
                                                   shared_init=shared_init)
    tmodel, tstate = tft.create_finetune_state(tcfg, "cpu", emb_dim=EMB,
                                               shared_init=shared_init)
    load_flax_finetune_state(tstate, _tree(jstate))
    return jcfg, tcfg, jmodel, jstate, tx, tmodel, tstate


@pytest.fixture(scope="module")
def steps():
    """Two alternating steps on each side, from the same state and batches."""
    jcfg, tcfg, jmodel, jstate, tx, tmodel, tstate = _pair()
    jstep, tstep = jft.make_finetune_step(jmodel, tx, jcfg), tft.make_finetune_step(tmodel,
                                                                                   tcfg)
    out = {"jmetrics": [], "tmetrics": [], "params0": _tree(jstate)["params"]}
    for seed in (1, 2):
        jb, tb = _batches(seed)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        out["jmetrics"].append(jm)
        out["tmetrics"].append(tm)
    out.update(jstate=jstate, tstate=tstate, tmodel=tmodel, jmodel=jmodel, jcfg=jcfg,
               tcfg=tcfg, tx=tx)
    return out


@pytest.mark.parametrize("parity", [0, 1])
def test_heads_at_both_parities(parity):
    jcfg, tcfg, jmodel, jstate, _, tmodel, _ = _pair()
    jb, tb = _batches(7)
    want_loss, want = jmodel.apply({"params": jstate.params}, jb, parity, jcfg.loss_type,
                                   jcfg.aux_w, jcfg.bin_w, jcfg.rec_w)
    got_loss, got = tmodel(tb, parity, tcfg.loss_type, tcfg.aux_w, tcfg.bin_w, tcfg.rec_w)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    got_loss.backward()  # both towers get gradients; the step picks one side's


@pytest.mark.parametrize("i", [0, 1])
def test_alternating_steps_metrics(steps, i):
    jm, tm = steps["jmetrics"][i], steps["tmetrics"][i]
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _grads(adam):
    """Each leaf's clipped gradient of a side's one step, mu / 0.1."""
    return {path: mu / 0.1 for path, mu in _leaves(adam["mu"])}


def test_alternating_steps_adam_states(steps):
    tstate, jstate = steps["tstate"], steps["jstate"]
    assert tstate.step == int(jstate.step) == 2
    named = dict(tstate.model.named_parameters())
    for side, jopt, topt in (("db", jstate.opt_db, tstate.opt_db),
                             ("q", jstate.opt_q, tstate.opt_q)):
        adam = _adam_state(jopt)
        assert int(adam["count"]) == 1
        own = {n for n, _ in tstate.model.side_parameters(side)}
        assert {id(p) for g in topt.param_groups for p in g["params"]} == {
            id(named[n]) for n in own}
        for (path, mu), (_, nu) in zip(_leaves(adam["mu"]), _leaves(adam["nu"])):
            key = torch_key(path)
            if key not in own:  # the masked side: zero moments in JAX, no state here
                assert not mu.any() and not nu.any(), key
                continue
            st = topt.state[named[key]]
            assert float(st["step"]) == 1.0
            np.testing.assert_allclose(_jax_layout(path, st["exp_avg"]), mu,
                                       rtol=MOMENT_RTOL, atol=MU_ATOL, err_msg=key)
            np.testing.assert_allclose(np.sqrt(_jax_layout(path, st["exp_avg_sq"]) / 0.001),
                                       np.sqrt(nu / 0.001), rtol=MOMENT_RTOL, atol=G_ATOL,
                                       err_msg=key)


def test_alternating_steps_parameters(steps):
    tstate, jstate = steps["tstate"], steps["jstate"]
    named = dict(tstate.model.named_parameters())
    jg = {}
    for side, opt in (("db", jstate.opt_db), ("q", jstate.opt_q)):  # each tower's own leaves
        jg.update({p: g for p, g in _grads(_adam_state(opt)).items()
                   if p[0] in tft.SIDES[side]})
    checked = total = 0
    for path, new in _leaves(jax.tree.map(np.asarray, jstate.params)):
        key = torch_key(path)
        side = tstate.opt_db if key.split(".")[0] in tft.SIDES["db"] else tstate.opt_q
        g_port = _jax_layout(path, side.state[named[key]]["exp_avg"]) / 0.1
        sure = np.abs(jg[path] / (np.abs(jg[path]) + 1e-8)
                      - g_port / (np.abs(g_port) + 1e-8)) <= SURE_U
        np.testing.assert_allclose(_jax_layout(path, named[key])[sure], new[sure],
                                   atol=PARAM_TOL, rtol=PARAM_TOL, err_msg=key)
        checked += int(sure.sum())
        total += new.size
    assert checked >= SURE_SHARE * total, (checked, total)
    # each tower moved on its own step
    for key in ("db_bin.lin1.weight", "q_bin.lin1.weight"):
        path = tuple(key.replace("weight", "kernel").split("."))
        assert (np.abs(_jax_layout(path, named[key])
                       - dict(_leaves(steps["params0"]))[path]) > 0).any(), key


def test_shared_init_ties_the_towers():
    jcfg, tcfg, jmodel, jstate, _, tmodel, tstate = _pair(shared_init=True, code_len=16)
    _, own = tft.create_finetune_state(tcfg, "cpu", emb_dim=EMB, shared_init=True)
    for a, b in zip(own.model.q_bin.parameters(), own.model.db_bin.parameters()):
        assert torch.equal(a, b)
    emb = np.random.default_rng(3).standard_normal((7, EMB)).astype(np.float32)
    db_fn, q_fn = tft.make_code_fns(tmodel)
    assert torch.equal(db_fn(tstate, torch.from_numpy(emb)), q_fn(tstate, torch.from_numpy(emb)))


def test_code_fns_match_jax_where_the_sign_is_clear(steps):
    tstate, jstate = steps["tstate"], steps["jstate"]
    emb = np.random.default_rng(4).standard_normal((64, EMB)).astype(np.float32)
    jdb, jq = jft.make_code_fns(steps["jmodel"])
    tdb, tq = tft.make_code_fns(steps["tmodel"])
    for jfn, tfn, head in ((jdb, tdb, tstate.model.db_bin), (jq, tq, tstate.model.q_bin)):
        got = _np(tfn(tstate, torch.from_numpy(emb)))
        want = np.asarray(jfn(jstate, jnp.asarray(emb)))
        assert set(np.unique(got)) <= {-1.0, 1.0}
        with torch.no_grad():
            pre = _np(head.lin1(torch.from_numpy(emb)))
        clear = np.abs(pre) > CODE_MARGIN
        assert clear.mean() > 0.99
        np.testing.assert_array_equal(got[clear], want[clear])


def test_valid_fn(steps):
    jb, tb = _batches(9)
    want = jft.make_valid_fn(steps["jmodel"], steps["jcfg"])(steps["jstate"], jb)
    got = tft.make_valid_fn(steps["tmodel"], steps["tcfg"])(steps["tstate"], tb)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_load_flax_finetune_state(steps):
    """JAX's state after two steps loaded into a fresh port state: the same
    parameters, moments and step, and the same next step."""
    jstate = steps["jstate"]
    _, state = tft.create_finetune_state(steps["tcfg"], "cpu", emb_dim=EMB)
    load_flax_finetune_state(state, _tree(jstate))
    assert state.step == 2
    named = dict(state.model.named_parameters())
    for path, v in _leaves(jax.tree.map(np.asarray, jstate.params)):
        np.testing.assert_array_equal(_jax_layout(path, named[torch_key(path)]), v)
    for side, opt in (("db", jstate.opt_db), ("q", jstate.opt_q)):
        adam = _adam_state(opt)
        topt = getattr(state, f"opt_{side}")
        for path, mu in _leaves(adam["mu"]):
            if torch_key(path) in dict(state.model.side_parameters(side)):
                np.testing.assert_array_equal(
                    _jax_layout(path, topt.state[named[torch_key(path)]]["exp_avg"]), mu)
    jb, tb = _batches(11)
    _, jm = jft.make_finetune_step(steps["jmodel"], steps["tx"], steps["jcfg"])(jstate, jb)
    _, tm = tft.make_finetune_step(state.model, steps["tcfg"])(state, tb)
    for k in jm:
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_build_triplet_batches_same_seed_same_batches():
    rng = np.random.default_rng(5)
    triplets = [(f"o{i}", f"p{i}", f"h{i}", f"n{i}", 0.9, 0.5, 0.1 * (i % 3))
                for i in range(10)]
    aux_pairs = [(f"x{i}", f"y{i}") for i in range(5)]
    table = {k: rng.standard_normal(EMB).astype(np.float32)
             for t in triplets for k in t[:4]}
    table.update({k: rng.standard_normal(EMB).astype(np.float32)
                  for a in aux_pairs for k in a})

    def embed_fn(items):
        return np.stack([table[k] for k in items])

    want = list(jft.build_triplet_batches(triplets, embed_fn, aux_pairs, 4,
                                          np.random.default_rng(0))())
    got = list(tft.build_triplet_batches(triplets, embed_fn, aux_pairs, 4,
                                         np.random.default_rng(0), device="cpu")())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(_np(a), np.asarray(b))


def _ft_loss_inputs():
    rng = np.random.default_rng(8)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lab = rng.random(6).astype(np.float32)
    return {
        "binary_regularize": (f(6, 8),),
        "pair_loss[MSE]": (f(6, 8), f(6, 8), lab, "MSE"),
        "pair_loss[L1]": (f(6, 8), f(6, 8), lab, "L1"),
        "pair_matrix_loss": (f(6, 8), f(6, 8), lab, "MSE"),
        "sim_matrix_loss": (f(6, 8), (rng.random((6, 6)) < 0.3).astype(np.float32), "L1"),
        "triplet_loss": (f(6, 8), f(6, 8), f(6, 8), lab, rng.random(6).astype(np.float32)),
        "aux_consistency_loss": (f(5, 8), f(4, 8), f(5, 4)),
        "reconstruction_loss": (f(6, 8), f(6, 8)),
    }


@pytest.mark.parametrize("name", list(_ft_loss_inputs()))
def test_finetune_loss_matches_jax(name):
    args = _ft_loss_inputs()[name]
    fn = name.split("[")[0]
    conv = [(jnp.asarray(a), torch.from_numpy(a)) if isinstance(a, np.ndarray) else (a, a)
            for a in args]
    want = getattr(j_losses, fn)(*(j for j, _ in conv))
    got = getattr(t_losses, fn)(*(t for _, t in conv))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_criterion_refuses_an_unknown_type():
    with pytest.raises(ValueError, match="unrecognized loss type"):
        t_losses.pair_loss(torch.ones(2, 3), torch.ones(2, 3), torch.ones(2), "huber")


@pytest.mark.parametrize("jump", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_binarize_head_with_its_mlp(jump, train):
    x = np.random.default_rng(10).standard_normal((8, EMB)).astype(np.float32)
    jm = j_heads.BinarizeHead(16, use_mlp=True, mlp_hidden=12, jump=jump)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), train=False)
    want, upd = jm.apply(v, jnp.asarray(x), train=train, mutable=["batch_stats"])
    tm = t_heads.BinarizeHead(EMB, 16, use_mlp=True, mlp_hidden=12, jump=jump)
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, v["params"]),
                                          jax.tree.map(np.asarray, v["batch_stats"])))
    got = tm(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=1e-5)
    buffers = dict(tm.named_buffers())
    for path, s in _leaves(jax.tree.map(np.asarray, upd["batch_stats"])):
        np.testing.assert_allclose(_np(buffers[torch_key(path)]), s, rtol=RTOL, atol=ATOL)


def test_text_session_encoder():
    cfg = j_tiny()
    tok = get_tokenizer(cfg.vocab_size)
    data = JGen(asin_num=cfg.asin_num, seed=3).dataset(6)
    batch = j_build_batch(data, tok, cfg.dims)
    jm = j_bts(cfg)
    jb = jax.tree.map(jnp.asarray, batch)
    v = jm.init(jax.random.PRNGKey(0), jb)
    want = np.asarray(jm.apply(v, jb))
    tm = build_text_session_encoder(t_tiny(), "cpu")
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, v)), strict=True)
    with torch.no_grad():
        got = _np(tm(to_device(SessionGraph(*(np.asarray(a) for a in batch)),
                               torch.device("cpu"))))
    assert got.shape == (6, cfg.n_out)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-5 * max(float(np.abs(want).max()), 1.0))
