"""Data-parallel layout (counterpart of
``sessionsimilaritysearch_tpu/parallel/sharding.py``: ``_spec_for`` :18,
``param_shardings`` :34, ``shard_params`` :53).

JAX replicates every parameter except the wide embedding tables, which it
shards row-wise over the mesh; GSPMD then inserts the collectives. The port
runs one ``torch.distributed`` process per device (a rank is the unit of
data parallelism), so the layout is explicit:

- :func:`param_shardings` applies JAX's rule to the Flax path of each of the
  port's parameters (``weights.flax_path``): a 2-D leaf whose path names
  "embedding" or "asin", with at least ``min_rows`` rows and a row count
  the axis divides, is row-sharded, ``("data",)``; every other leaf is
  replicated, ``()``.
- :func:`shard_params` keeps on each rank only its row range of each
  sharded table, and that range's Adam moments. The table's module becomes
  a :class:`~sessionsimilaritysearch_tpu_torch.models.embedding.RowShardedEmbedding`
  that records the range (:class:`RowShard`); its lookups gather the ids of
  every rank and reduce-scatter the rows back.
- :class:`BatchGroup` is the step's view of the ranks: which rows of the
  global batch this rank holds, and the collectives (sum, gather,
  reduce-scatter) with their backward, so that the sum of the ranks' losses
  is the global batch's loss and its gradient flows to whichever rank's
  activations it came from.
- :class:`ShardedTensor` is one leaf split by rows: this process's shards
  and their index boxes, what ``utils.checkpoint.save_sharded`` writes
  shard by shard.

Outside a process group the collectives are the identity: :data:`ALONE`,
the group of one process by itself, is what the one-process step runs
with, and a one-shard mesh of this process alone runs the data-parallel
code as the one-process step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from sessionsimilaritysearch_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    rank_device,
    replicated,
)

# words of a Flax path that mark an embedding table (JAX ``sharding.py:19``)
TABLE_WORDS = ("embedding", "asin")


def _dist():
    import torch.distributed as dist

    return dist


def _gather_rows(x: torch.Tensor, world: int) -> torch.Tensor:
    """Every rank's ``x`` (one shape on each), concatenated along dim 0 in
    rank order."""
    x = x.contiguous()
    out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
    _dist().all_gather_into_tensor(out, x)
    return out


def _scatter_sum(x: torch.Tensor, world: int) -> torch.Tensor:
    """The sum over ranks of ``x`` [world * n, ...], this rank's n rows."""
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // world,) + tuple(x.shape[1:]))
    _dist().reduce_scatter_tensor(out, x)
    return out


class _Sum(torch.autograd.Function):
    """All-reduce sum; its gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        _dist().all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _dist().all_reduce(g)
        return g


class _Gather(torch.autograd.Function):
    """All-gather along dim 0; its gradient reduce-scatters back."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return _gather_rows(x, world)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.world), None


class _ScatterSum(torch.autograd.Function):
    """Reduce-scatter along dim 0; its gradient all-gathers."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return _scatter_sum(x, world)

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.world), None


class BatchGroup:
    """The ranks of a data-parallel step: this rank's index, their number,
    and whether they form a ``torch.distributed`` group (the default one).
    Every rank holds as many rows of the global batch, rank-major."""

    def __init__(self, rank: int = 0, world: int = 1, distributed: bool = False):
        if not distributed and world != 1:
            raise ValueError("several ranks need a process group")
        self.rank, self.world, self.distributed = int(rank), int(world), bool(distributed)

    @classmethod
    def from_mesh(cls, mesh: Mesh, axis: str = "data") -> "BatchGroup":
        """The group of a mesh whose process holds exactly one shard along
        ``axis`` (one process per device); any other mesh raises."""
        shard, _ = rank_device(mesh, axis)
        if mesh.size != mesh.shape[axis] or mesh.shape[axis] != mesh.world:
            raise ValueError(f"{mesh}: data parallelism wants a 1-D mesh of one shard per rank")
        return cls(shard, mesh.world, mesh.distributed)

    def rows(self, n_local: int) -> Tuple[int, int]:
        """This rank's [start, stop) rows of the global batch."""
        return self.rank * n_local, (self.rank + 1) * n_local

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ranks, with its gradient."""
        return _Sum.apply(x) if self.distributed else x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, rank-major, with their gradient."""
        return _Gather.apply(x, self.world) if self.distributed else x

    def scatter_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of [world * n, ...] rows, this rank's n, with
        its gradient."""
        return _ScatterSum.apply(x, self.world) if self.distributed else x

    @torch.no_grad()
    def sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over ranks in place, all in one all-reduce."""
        if not self.distributed or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        _dist().all_reduce(flat)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


# the group of this process alone (the one-process step's)
ALONE = BatchGroup()


@dataclasses.dataclass(frozen=True)
class RowShard:
    """Rows [start, stop) of a table of ``rows`` rows, held by this rank of
    ``group``."""

    start: int
    stop: int
    rows: int
    group: BatchGroup

    @property
    def n_shards(self) -> int:
        return self.rows // (self.stop - self.start)


def row_shards(model: nn.Module) -> Dict[str, RowShard]:
    """{parameter name: its RowShard} of every row-sharded table of
    ``model``."""
    return {f"{name}.weight" if name else "weight": m.row_shard
            for name, m in model.named_modules() if getattr(m, "row_shard", None)}


class ShardedTensor:
    """One leaf of global ``shape`` split by rows into ``n_shards`` equal
    boxes; ``shards`` maps each shard this process holds to its tensor.
    ``distributed``: the other shards live in other processes of the
    default group."""

    def __init__(self, shape: Sequence[int], shards: Dict[int, torch.Tensor], n_shards: int,
                 distributed: bool = False):
        self.shape = tuple(int(s) for s in shape)
        self.shards = dict(shards)
        self.n_shards = int(n_shards)
        self.distributed = bool(distributed)
        if self.shape[0] % self.n_shards:
            raise ValueError(f"{self.shape[0]} rows do not split into {n_shards} shards")
        for s, t in self.shards.items():
            if tuple(t.shape) != self.box_shape:
                raise ValueError(f"shard {s} is {tuple(t.shape)}, want {self.box_shape}")

    @property
    def box_shape(self) -> Tuple[int, ...]:
        return (self.shape[0] // self.n_shards,) + self.shape[1:]

    def box(self, s: int) -> Tuple[Tuple[int, int], ...]:
        """Shard ``s``'s index box: (start, stop) per dimension, as JAX
        writes it."""
        per = self.shape[0] // self.n_shards
        return ((s * per, (s + 1) * per),) + tuple((0, d) for d in self.shape[1:])

    def local(self):
        """This process's shards, in shard order."""
        return [self.shards[s] for s in sorted(self.shards)]


def sharded_rows(shards: Sequence[torch.Tensor], mesh: Mesh, axis: str = "data") -> ShardedTensor:
    """A sharded index's per-shard list (in ``mesh.local_shards(axis)``
    order) as a :class:`ShardedTensor`."""
    n = mesh.shape[axis]
    shape = (n * shards[0].shape[0],) + tuple(shards[0].shape[1:])
    return ShardedTensor(shape, dict(zip(mesh.local_shards(axis), shards)), n,
                         mesh.distributed)


def _is_table(names: Sequence[str]) -> bool:
    return any(word in n.lower() for n in names for word in TABLE_WORDS)


def param_shardings(model: nn.Module, mesh: Mesh, shard_axis: str = "data",
                    min_rows: int = 8192) -> Dict[str, tuple]:
    """{parameter name: layout} for every parameter of ``model``: the
    embedding tables (JAX's rule on the Flax path and shape of each leaf)
    ``batch_sharding(mesh, shard_axis)``, every other leaf
    ``replicated(mesh)``."""
    from sessionsimilaritysearch_tpu_torch.weights import flax_path

    n = mesh.shape[shard_axis]
    out = {}
    for name, p in model.named_parameters():
        path, shape = flax_path(model, name)
        table = (_is_table(path) and len(shape) == 2 and shape[0] >= min_rows
                 and shape[0] % n == 0)
        out[name] = batch_sharding(mesh, shard_axis) if table else replicated(mesh)
    return out


def shard_params(state, mesh: Mesh, shard_axis: str = "data", min_rows: int = 8192):
    """Row-shard the tables that :func:`param_shardings` picks, in place:
    ``state`` is a ``TrainState``; each rank keeps its rows of each table
    (shard ``s`` of ``n`` holds rows [s R / n, (s + 1) R / n)) and of their
    Adam moments, the table's module records them (:class:`RowShard`), and
    the optimizer's global-norm clip learns which gradients are partial.
    Returns ``state``."""
    from sessionsimilaritysearch_tpu_torch.models.embedding import RowShardedEmbedding

    model, opt = state.model, state.optimizer
    layout = param_shardings(model, mesh, shard_axis, min_rows)
    group = BatchGroup.from_mesh(mesh, shard_axis)
    modules = dict(model.named_modules())
    sharded = []
    for name, spec in layout.items():
        if spec != batch_sharding(mesh, shard_axis):
            continue
        owner, _, leaf = name.rpartition(".")
        emb = modules[owner]
        if leaf != "weight" or type(emb) is not nn.Embedding:
            raise ValueError(f"{name}: only an nn.Embedding's table can be row-sharded")
        p = emb.weight
        rows = p.shape[0]
        per = rows // group.world
        start, stop = group.rank * per, (group.rank + 1) * per
        with torch.no_grad():
            p.data = p.data[start:stop].clone()
        p.grad = None
        for key, val in opt.state.get(p, {}).items():
            if isinstance(val, torch.Tensor) and val.shape[:1] == (rows,):
                opt.state[p][key] = val[start:stop].clone()
        emb.__class__ = RowShardedEmbedding
        emb.row_shard = RowShard(start, stop, rows, group)
        sharded.append(p)
    opt.norm_group = group
    opt.partial_grads = frozenset(id(p) for p in sharded)
    return state
