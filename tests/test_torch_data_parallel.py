"""The port's data-parallel pretrain step over two gloo processes against
the one-process port step on the same global batch of 8 and the same
draws, and its loss against JAX's own sharded step on the 8-device CPU
mesh (``tests/test_pretrain.py:198``).

One pair of processes (this file run as a script, ``__main__`` below)
serves every case: the parent writes each case's weights, global batch and
draws to a file; each rank loads them, row-shards ``target_asin_embedding``
and ``tok_emb`` (``shard_params(min_rows=512)``), takes its half of the
batch and runs one data-parallel step, then writes its loss, metrics,
gradients after the clip, BatchNorm statistics and Adam moments. The
workers import torch and the port only. Cases:

- ``default``: the next-product objective; draws from the states'
  generators (one seed on every rank and in the parent), so the global
  draws cut per rank are checked too;
- ``aux``: every auxiliary on (all products, queries, titles, qaea, node
  reconstruction, token ELECTRA through the sharded ``tok_emb``,
  contrastive views), generator draws;
- ``unequal``: every auxiliary on, the batch ordered so that the halves
  hold different numbers of real nodes and targets, explicit draws;
- ``cached``: the ``tables=`` step on a title table (an input, the same
  on every rank), generator draws;
- ``jax``: JAX's draws (``pretrain.py:124-153``) and JAX's sharded step
  on the same weights (the port's init carried into a Flax tree).

Tolerances (``test_torch_pretrain.py``'s): the loss and every metric rtol
1e-5, atol 1e-6; gradients atol 2e-5 of the largest |gradient|, rtol 1e-4;
BatchNorm statistics rtol 1e-5, atol 1e-6; Adam moments mu rtol 1e-4 and
0.1 x the gradient bound, nu rtol 1e-3 and 0.004 x its square plus what a
gradient within its bound moves nu = 0.001 g^2 by, 0.002 |g| x the bound
(the summation orders of the two ranks and of one process differ by up
to ~1e-7 on a gradient of ~1e-4, inside the gradient bound, which moves
such an element's nu by ~1.5e-3 of itself). Against
JAX's sharded step: the loss at rtol 2e-3, the bound JAX's own test holds
its sharded step to.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # a worker: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sessionsimilaritysearch_tpu_torch.config import tiny_test_config  # noqa: E402
from sessionsimilaritysearch_tpu_torch.data.graph import SessionGraph  # noqa: E402
from sessionsimilaritysearch_tpu_torch.parallel import create_mesh  # noqa: E402
from sessionsimilaritysearch_tpu_torch.training import pretrain as tp  # noqa: E402

WORKER_TIMEOUT_S = 120
CPU = torch.device("cpu")
AUX = dict(ph_w=0.1, qh_w=0.1, pt_w=0.1, qaea_w=0.1, node_w=0.1, token_w=0.1, ctv_w=0.1)
CASES = {"default": {}, "aux": AUX, "unequal": AUX, "cached": {}, "jax": {}}
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-6
GRAD_REL, GRAD_RTOL = 2e-5, 1e-4
BN_RTOL, BN_ATOL = 1e-5, 1e-6
JAX_SHARDED_RTOL = 2e-3
TABLES = {"target_asin_embedding.weight", "encoder.query_node_embedder.tok_emb.weight"}


def _graph(arrays: dict):
    return SessionGraph(**{k: torch.as_tensor(v) for k, v in arrays.items()})


def _record(model, state, metrics) -> dict:
    opt = state.optimizer
    named = dict(model.named_parameters())
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in named.items()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "exp_avg": {n: opt.state[p]["exp_avg"].clone() for n, p in named.items()},
            "exp_avg_sq": {n: opt.state[p]["exp_avg_sq"].clone() for n, p in named.items()}}


def _one_step(case: dict, mesh=None) -> dict:
    """One step of ``case`` (the whole batch, or with ``mesh`` this rank's
    rows of it) from its weights."""
    from sessionsimilaritysearch_tpu_torch.parallel import host_local_batch_to_global, shard_batch
    from sessionsimilaritysearch_tpu_torch.parallel.sharding import row_shards, shard_params

    cfg = tiny_test_config(**CASES[case["name"]])
    model, state = tp.create_pretrain_state(cfg, CPU)
    model.load_state_dict(case["weights"], strict=True)
    graph, view = _graph(case["batch"]), case["view"] and _graph(case["view"])
    if mesh is not None:
        shard_params(state, mesh, min_rows=512)
        assert set(row_shards(model)) == TABLES
        # this rank's rows both ways: cut from the global batch, or its own
        graph = shard_batch(graph, mesh)
        if view is not None:
            lo, hi = mesh.rank * 4, mesh.rank * 4 + 4
            view = host_local_batch_to_global(view._replace(**{
                k: v[lo:hi] for k, v in view._asdict().items()}), mesh)
    step = tp.make_train_step(model, has_view=view is not None, mesh=mesh)
    state, metrics = step(state, graph, view, tables=case["tables"], draws=case["draws"])
    out = _record(model, state, metrics)
    out["shards"] = {n: (s.start, s.stop) for n, s in row_shards(model).items()}
    return out


def _worker(rank: int, world: int, port: int, path: str) -> None:
    import torch.distributed as dist

    from sessionsimilaritysearch_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize_distributed(f"localhost:{port}", world, rank)
    mesh = multihost.global_mesh(local_devices=[CPU])
    cases = torch.load(path, weights_only=False)
    out = {name: _one_step(case, mesh) for name, case in cases.items()}
    torch.save(out, f"{path}.rank{rank}")
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK_{rank}_OK", flush=True)


def _start_pair(path: str) -> list:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), "2", str(port), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
    ) for rank in range(2)]


def _finish_pair(procs: list) -> None:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert f"RANK_{rank}_OK" in out


def _arrays(batch) -> dict:
    return {k: np.asarray(v) for k, v in batch._asdict().items()}


def _flax_tree(model, named) -> dict:
    """``named`` tensors of the port ``model`` as a Flax tree (the inverse
    of ``weights.torch_key``; kernels transposed)."""
    from sessionsimilaritysearch_tpu_torch.weights import flax_path

    tree = {}
    for name, t in named:
        path, _ = flax_path(model, name)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        arr = t.detach().numpy()
        node[path[-1]] = arr.T if path[-1] == "kernel" else arr
    return tree


def _jax_draws(data, tok, key=5):
    """The random parts of JAX's step (pretrain.py:124-153; token_w is 0)
    for key ``key``, as tensors."""
    import jax

    from sessionsimilaritysearch_tpu.config import tiny_test_config as j_tiny
    from sessionsimilaritysearch_tpu.data import build_graph_batch

    cfg = j_tiny()
    host = build_graph_batch(data, tok, cfg.dims)
    r_qmask, r_pmask, r_neg1, _, _ = jax.random.split(jax.random.PRNGKey(key), 5)
    B, A = host.query_node_mask.shape[0], cfg.asin_num

    def keep(k, mask):
        return np.asarray(jax.random.uniform(k, mask.shape) > cfg.node_mask_prob, np.float32)

    draws = {"query_node_mask": keep(r_qmask, host.query_node_mask),
             "product_node_mask": keep(r_pmask, host.product_node_mask),
             "neg_next": np.asarray(jax.random.uniform(r_neg1, (B, A)) < cfg.neg_sample_count / A)}
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _jax_sharded_loss(data, tok, tmodel, key=5) -> float:
    """The loss of JAX's sharded step (the global batch over the 8-device
    CPU mesh, the tables row-sharded with min_rows 512) from the port
    model's weights, with key ``key`` (the draws of :func:`_jax_draws`)."""
    import jax
    import jax.numpy as jnp

    from sessionsimilaritysearch_tpu.config import tiny_test_config as j_tiny
    from sessionsimilaritysearch_tpu.data import build_graph_batch
    from sessionsimilaritysearch_tpu.parallel import create_mesh as j_mesh
    from sessionsimilaritysearch_tpu.parallel import shard_batch as j_shard_batch
    from sessionsimilaritysearch_tpu.parallel import shard_params as j_shard_params
    from sessionsimilaritysearch_tpu.training import pretrain as jp
    from sessionsimilaritysearch_tpu.training.train_state import TrainState, adam_with_clip

    cfg = j_tiny()
    batch = jax.tree.map(jnp.asarray, build_graph_batch(data, tok, cfg.dims))
    model = jp.PretrainModel(cfg)
    bn = [(n, b) for n, b in tmodel.named_buffers() if n.endswith((".mean", ".var"))]
    state = TrainState.create(
        apply_fn=model.apply, tx=adam_with_clip(cfg.lr, cfg.grad_clip_norm, cfg.weight_decay),
        params=jax.tree.map(jnp.asarray, _flax_tree(tmodel, tmodel.named_parameters())),
        batch_stats=jax.tree.map(jnp.asarray, _flax_tree(tmodel, bn)))
    mesh = j_mesh()
    sharded = state.replace(params=j_shard_params(state.params, mesh, min_rows=512))
    _, metrics = jp.make_train_step(model, has_view=False)(sharded, j_shard_batch(batch, mesh),
                                                          jax.random.PRNGKey(key))
    return float(metrics["loss"])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes run best on one thread, as the ranks run, and the
    suite's workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's weights, batch and draws; the two ranks' results and
    the one-process step's."""
    from sessionsimilaritysearch_tpu_torch.data import SyntheticSessionGenerator
    from sessionsimilaritysearch_tpu_torch.data.graph import build_graph_batch
    from sessionsimilaritysearch_tpu_torch.evalharness import harness as th
    from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer

    cfg = tiny_test_config()
    tok = get_tokenizer(cfg.vocab_size)
    gen = SyntheticSessionGenerator(asin_num=cfg.asin_num, seed=11)
    data = gen.dataset(8)
    # the unequal halves: the longest sessions first
    ordered = sorted(data, key=lambda d: -len(d[0]) - len(d[1]))
    cases, models = {}, {}
    for name, overrides in CASES.items():
        ccfg = tiny_test_config(**overrides)
        batch = build_graph_batch(ordered if name == "unequal" else data, tok, ccfg.dims)
        models[name], _ = tp.create_pretrain_state(ccfg, CPU)
        draws = tables = None
        if name == "unequal":
            draws = models[name].draw(_graph(_arrays(batch)), torch.Generator().manual_seed(3))
        if name == "jax":
            draws = _jax_draws(data, tok)
        if name == "cached":
            tables = {"title_table": th.build_title_table(ccfg, tok, gen.titles,
                                                          models[name].encoder)}
        cases[name] = {"name": name, "batch": _arrays(batch), "draws": draws, "tables": tables,
                       "weights": {k: v.clone() for k, v in models[name].state_dict().items()},
                       "view": _arrays(batch) if ccfg.ctv_w > 0 else None}
    path = str(tmp_path_factory.mktemp("dp") / "cases.pt")
    torch.save(cases, path)
    procs = _start_pair(path)
    # the parent's work overlaps the ranks': the one-process steps and JAX's
    try:
        one = {name: _one_step(case) for name, case in cases.items()}
        jax_loss = _jax_sharded_loss(data, tok, models["jax"])
    finally:
        _finish_pair(procs)
    ranks = [torch.load(f"{path}.rank{r}", weights_only=False) for r in range(2)]
    return {name: {"case": case, "ranks": [r[name] for r in ranks], "one": one[name]}
            for name, case in cases.items()} | {"jax_loss": jax_loss}


def _assembled(run, key) -> dict:
    """The ranks' ``key`` tensors as one tree: a sharded table's rows
    concatenated in rank order; every replicated tensor equal on both."""
    a, b = (r[key] for r in run["ranks"])
    out = {}
    for name in a:
        if name in run["ranks"][0]["shards"]:
            out[name] = torch.cat([a[name], b[name]])
        else:
            assert torch.equal(a[name], b[name]), f"{key} {name} differs between the ranks"
            out[name] = a[name]
    return out


def _bound(run):
    return GRAD_REL * max(float(g.abs().max()) for g in run["one"]["grads"].values())


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_metric(runs, case):
    run = runs[case]
    want = run["one"]["metrics"]
    for r in run["ranks"]:
        assert set(r["metrics"]) == set(want)
        for k in want:
            np.testing.assert_allclose(r["metrics"][k], want[k], rtol=METRIC_RTOL,
                                       atol=METRIC_ATOL, err_msg=k)
    assert run["ranks"][0]["metrics"] == run["ranks"][1]["metrics"]
    assert np.isfinite(want["loss"])


@pytest.mark.parametrize("case", list(CASES))
def test_every_gradient_leaf_after_the_clip(runs, case):
    run = runs[case]
    assert {n: s for n, s in run["ranks"][1]["shards"].items()} == {
        "target_asin_embedding.weight": (500, 1000),
        "encoder.query_node_embedder.tok_emb.weight": (500, 1000)}
    got, bound = _assembled(run, "grads"), _bound(run)
    want = run["one"]["grads"]
    assert set(got) == set(want)
    for n, g in want.items():
        np.testing.assert_allclose(got[n].numpy(), g.numpy(), atol=bound, rtol=GRAD_RTOL,
                                   err_msg=n)


@pytest.mark.parametrize("case", list(CASES))
def test_batch_stats_after_the_step(runs, case):
    run = runs[case]
    want = run["one"]["buffers"]
    assert any(n.endswith(".mean") for n in want)
    for r in run["ranks"]:
        for n, v in want.items():
            np.testing.assert_allclose(r["buffers"][n].numpy(), v.numpy(), rtol=BN_RTOL,
                                       atol=BN_ATOL, err_msg=n)


@pytest.mark.parametrize("case", list(CASES))
def test_adam_moments_after_the_step(runs, case):
    run = runs[case]
    bound = _bound(run)
    mu, nu = _assembled(run, "exp_avg"), _assembled(run, "exp_avg_sq")
    for n, want in run["one"]["exp_avg"].items():
        np.testing.assert_allclose(mu[n].numpy(), want.numpy(), rtol=GRAD_RTOL,
                                   atol=0.1 * bound, err_msg=n)
        # nu = 0.001 g^2, so a gradient within the bound moves it by up to
        # 0.002 |g| bound + 0.001 bound^2
        g = np.abs(run["one"]["grads"][n].numpy())
        got, want_nu = nu[n].numpy(), run["one"]["exp_avg_sq"][n].numpy()
        err = np.abs(got - want_nu) - (1e-3 * np.abs(want_nu) + 0.004 * bound * bound
                                       + 0.002 * g * bound)
        assert (err <= 0).all(), (n, float(err.max()))


def test_loss_matches_jax_sharded_step(runs):
    got = runs["jax"]["ranks"][0]["metrics"]["loss"]
    np.testing.assert_allclose(got, runs["jax_loss"], rtol=JAX_SHARDED_RTOL)
    # the difference found, for the record
    print(f"port data-parallel loss {got!r} vs JAX sharded {runs['jax_loss']!r}: "
          f"rel {abs(got - runs['jax_loss']) / abs(runs['jax_loss']):.3g}")


def test_the_unequal_halves_hold_different_counts(runs):
    batch = runs["unequal"]["case"]["batch"]
    for key in ("product_target_mask", "product_node_mask", "query_node_mask",
                "query_attention_mask"):
        halves = [float(batch[key][:4].sum()), float(batch[key][4:].sum())]
        assert halves[0] != halves[1], (key, halves)
    draws = runs["unequal"]["case"]["draws"]
    for key in ("query_node_mask", "product_node_mask"):  # the nodes to reconstruct
        dropped = (1.0 - draws[key].numpy()) * batch[key]
        assert dropped[:4].sum() != dropped[4:].sum(), key


def test_a_mesh_of_several_local_shards_raises():
    model, state = tp.create_pretrain_state(tiny_test_config(), CPU)
    four = create_mesh(devices=[CPU] * 4)
    from sessionsimilaritysearch_tpu_torch.parallel import shard_batch, shard_params

    for call in (lambda: tp.make_train_step(model, mesh=four),
                 lambda: shard_params(state, four, min_rows=512),
                 lambda: shard_batch({"x": np.zeros((8, 2))}, four)):
        with pytest.raises(ValueError, match="one process per device"):
            call()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
