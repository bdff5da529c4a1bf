"""The port's data-parallel layout in one process: ``param_shardings``
against JAX's on the same Flax tree, ``flax_path`` (the inverse of
``weights.torch_key``), the batch layouts (``shard_batch``,
``process_slice``, ``host_local_batch_to_global`` with the rank and world
patched, as ``test_torch_multihost.py`` does), ``shard_params`` and the
data-parallel step on a mesh of one shard (the collectives are the
identity, so it is the one-process step), and the losses of item 7e
(``mlm_loss``, ``next_text_embedding_loss``) against JAX's on numpy-seeded
inputs.

Tolerances: the one-shard data-parallel step against the one-process step
on the loss and metrics rtol 1e-5, gradients 2e-5 of the largest
|gradient| (``test_torch_pretrain.py``'s); the losses rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sessionsimilaritysearch_tpu.config import tiny_test_config as j_tiny
from sessionsimilaritysearch_tpu.data import SyntheticSessionGenerator as JGen
from sessionsimilaritysearch_tpu.data import build_graph_batch as j_build_batch
from sessionsimilaritysearch_tpu.parallel import create_mesh as j_create_mesh
from sessionsimilaritysearch_tpu.parallel import param_shardings as j_param_shardings
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu.training import losses as j_losses
from sessionsimilaritysearch_tpu.training import pretrain as jp
from sessionsimilaritysearch_tpu_torch.config import tiny_test_config as t_tiny
from sessionsimilaritysearch_tpu_torch.data.graph import SessionGraph
from sessionsimilaritysearch_tpu_torch.models.embedding import RowShardedEmbedding
from sessionsimilaritysearch_tpu_torch.parallel import (
    batch_sharding,
    create_mesh,
    host_local_batch_to_global,
    multihost,
    param_shardings,
    process_slice,
    replicated,
    shard_batch,
    shard_params,
)
from sessionsimilaritysearch_tpu_torch.parallel.mesh import Mesh
from sessionsimilaritysearch_tpu_torch.parallel.sharding import BatchGroup, row_shards
from sessionsimilaritysearch_tpu_torch.training import losses as t_losses
from sessionsimilaritysearch_tpu_torch.training import pretrain as tp
from sessionsimilaritysearch_tpu_torch.training.train_state import clip_by_global_norm
from sessionsimilaritysearch_tpu_torch.weights import flax_path, torch_key

CPU = torch.device("cpu")
AUX = dict(ph_w=0.1, qh_w=0.1, pt_w=0.1, qaea_w=0.1, node_w=0.1, token_w=0.1, ctv_w=0.1)
TABLES = {"target_asin_embedding.weight", "encoder.query_node_embedder.tok_emb.weight"}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes run best on one thread, and the suite's workers share
    the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batch():
    cfg = j_tiny()
    data = JGen(asin_num=cfg.asin_num, seed=11).dataset(8)
    return j_build_batch(data, get_tokenizer(cfg.vocab_size), cfg.dims)


@pytest.fixture(scope="module")
def jax_tree(batch):
    """The shapes of JAX's PretrainModel parameters at 1024 asins, every
    head on (traced, not run)."""
    model = jp.PretrainModel(j_tiny(asin_num=1024, **AUX))
    b = jax.tree.map(jnp.asarray, batch)
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: model.init(key, b, key, deterministic=True))["params"]


@pytest.mark.parametrize("shards,min_rows", [(8, 512), (8, 8192), (5, 512)])
def test_param_shardings_pick_jax_leaves(jax_tree, shards, min_rows):
    """The same leaves shard on the same tree: over 5 shards the 1024 asin
    rows do not divide (the 1000 token rows do), 8192 rows are more than
    either table has."""
    j_mesh = j_create_mesh(shape=(shards,), devices=jax.devices()[:shards])
    specs = j_param_shardings(jax_tree, j_mesh, min_rows=min_rows)
    want = {torch_key(path) for path, s in _leaves(specs)
            if s.spec == jax.sharding.PartitionSpec("data", None)}
    model, _ = tp.create_pretrain_state(t_tiny(asin_num=1024, **AUX), CPU)
    mesh = create_mesh(devices=[CPU] * shards)
    layout = param_shardings(model, mesh, min_rows=min_rows)
    got = {n for n, spec in layout.items() if spec == batch_sharding(mesh)}
    assert got == want
    expect = {(8, 512): TABLES, (8, 8192): set(),
              (5, 512): {"encoder.query_node_embedder.tok_emb.weight"}}
    assert got == expect[(shards, min_rows)]
    assert set(layout.values()) <= {("data",), ()}


def test_flax_path_inverts_torch_key(jax_tree):
    """Every port parameter's Flax path and Flax-layout shape are a leaf of
    JAX's tree, and every JAX leaf is one of them."""
    tree = {path: tuple(v.shape) for path, v in _leaves(jax_tree)}
    model, _ = tp.create_pretrain_state(t_tiny(asin_num=1024, **AUX), CPU)
    got = dict(flax_path(model, n) for n, _ in model.named_parameters())
    assert got == tree
    for n, _ in model.named_parameters():
        assert torch_key(flax_path(model, n)[0]) == n


def test_layout_descriptions():
    mesh = create_mesh(devices=[CPU] * 2)
    assert batch_sharding(mesh) == ("data",) and replicated(mesh) == ()
    with pytest.raises(ValueError, match="axis"):
        batch_sharding(mesh, "model")


def _world(monkeypatch, rank, world):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda: world)


def _rank_mesh(world):
    """A global mesh of one CPU shard per rank, as global_mesh builds it."""
    devices = np.empty(world, dtype=object)
    devices[:] = [CPU] * world
    return Mesh(devices, ("data",), owners=np.arange(world), distributed=True)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_shard_batch_takes_this_ranks_rows(monkeypatch, batch, rank):
    _world(monkeypatch, rank, 4)
    mesh = _rank_mesh(4)
    local = shard_batch(batch, mesh)
    assert type(local) is type(batch)  # the batch keeps its structure
    lo, hi = process_slice(8)
    assert (lo, hi) == (2 * rank, 2 * rank + 2)
    for a, b in zip(local, batch):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[lo:hi])
    with pytest.raises(ValueError, match="divides"):
        shard_batch({"x": np.zeros((6, 2))}, mesh)


def test_host_local_batch_to_global_checks_the_counts(monkeypatch):
    _world(monkeypatch, 1, 2)
    mesh = _rank_mesh(2)
    rows = {"x": np.arange(6.0).reshape(3, 2), "y": np.arange(3)}
    monkeypatch.setattr(multihost, "_gather_ints", lambda values, device: [[3], [3]])
    out = host_local_batch_to_global(rows, mesh)
    assert out["x"].device == CPU and torch.equal(out["y"], torch.arange(3))
    monkeypatch.setattr(multihost, "_gather_ints", lambda values, device: [[3], [4]])
    with pytest.raises(ValueError, match="as many rows"):
        host_local_batch_to_global(rows, mesh)
    with pytest.raises(ValueError, match="one count"):
        host_local_batch_to_global({"x": np.zeros((3, 1)), "y": np.zeros(2)}, mesh)


def _port_batch(batch):
    return SessionGraph(*(torch.as_tensor(np.asarray(a)) for a in batch))


def _grad_bound(model):
    return 2e-5 * max(float(p.grad.abs().max()) for p in model.parameters())


def test_one_shard_step_is_the_one_process_step(batch):
    """shard_params and make_train_step(mesh=) on a mesh of this process's
    one shard: the tables keep every row, and the step (the collectives are
    the identity) equals the plain step. Every auxiliary is reached across
    two ranks in test_torch_data_parallel.py."""
    cfg = t_tiny()
    graph = _port_batch(batch)
    view = graph if cfg.ctv_w > 0 else None
    ref_model, ref = tp.create_pretrain_state(cfg, CPU)
    _, want = tp.make_train_step(ref_model, has_view=view is not None)(ref, graph, view)
    model, state = tp.create_pretrain_state(cfg, CPU)
    mesh = create_mesh(devices=[CPU])
    shard_params(state, mesh, min_rows=512)
    shards = row_shards(model)
    assert set(shards) == TABLES
    assert all((s.start, s.stop, s.n_shards) == (0, s.rows, 1) for s in shards.values())
    assert isinstance(model.encoder.query_node_embedder.tok_emb, RowShardedEmbedding)
    _, got = tp.make_train_step(model, has_view=view is not None, mesh=mesh)(state, graph, view)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    bound = _grad_bound(ref_model)
    named = dict(model.named_parameters())
    for n, p in ref_model.named_parameters():
        np.testing.assert_allclose(named[n].grad.numpy(), p.grad.numpy(), atol=bound,
                                   rtol=1e-4, err_msg=n)


def test_a_sharded_model_needs_the_data_parallel_step(batch):
    model, state = tp.create_pretrain_state(t_tiny(), CPU)
    shard_params(state, create_mesh(devices=[CPU]), min_rows=512)
    with pytest.raises(ValueError, match="mesh="):
        tp.make_train_step(model)
    graph = _port_batch(batch)
    with pytest.raises(ValueError, match="row-sharded"):
        model(graph, state.generator)
    with pytest.raises(ValueError, match="row shard"):
        model.retrieval_metrics(graph, 5)
    with pytest.raises(ValueError, match="nn.Embedding"):
        shard_params(state, create_mesh(devices=[CPU]), min_rows=512)  # already sharded


def test_the_step_refuses_dropout_in_the_heads():
    model, _ = tp.create_pretrain_state(t_tiny(ph_dropout=0.1), CPU)
    with pytest.raises(ValueError, match="dropout"):
        tp.make_train_step(model, mesh=create_mesh(devices=[CPU]))


def test_world_one_group_pieces():
    g = BatchGroup()
    x = torch.randn(3, 4)
    assert g.rows(5) == (0, 5) and g.sum(x) is x and g.gather(x) is x
    assert g.scatter_sum(x) is x
    with pytest.raises(ValueError, match="process group"):
        BatchGroup(0, 2, distributed=False)
    grads = [torch.randn(5, 3), torch.randn(7)]
    want = [t.clone() for t in grads]
    n1 = clip_by_global_norm(want, 0.5)
    n2 = clip_by_global_norm(grads, 0.5, [True, False], g)
    np.testing.assert_allclose(float(n2), float(n1), rtol=1e-6)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# item 7e: the two losses no trainer calls, against JAX's
# ---------------------------------------------------------------------------

def _loss_inputs():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "mlm_loss": (f(3, 5, 11), rng.integers(0, 11, (3, 5)).astype(np.int32),
                     rng.random((3, 5)) < 0.4),
        "mlm_loss_nothing_masked": (f(2, 4, 7), rng.integers(0, 7, (2, 4)).astype(np.int32),
                                    np.zeros((2, 4), bool)),
        "next_text_embedding_loss": (f(6, 8), f(6, 8),
                                     (rng.random(6) < 0.6).astype(np.float32)),
    }


@pytest.mark.parametrize("case", list(_loss_inputs()))
def test_7e_loss_matches_jax(case):
    args = _loss_inputs()[case]
    name = case.replace("_nothing_masked", "")
    want = getattr(j_losses, name)(*(jnp.asarray(a) for a in args))
    got = getattr(t_losses, name)(*(torch.from_numpy(np.asarray(a)) for a in args))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
