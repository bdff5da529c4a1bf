"""The port's device mesh (counterpart of
``sessionsimilaritysearch_tpu/parallel/mesh.py:19`` ``create_mesh``).

JAX's mesh is a ``jax.sharding.Mesh``, and XLA inserts the collectives. The
port's :class:`Mesh` is a plain object: an ordered array of
``torch.device``s, one per shard, reshaped to ``shape`` with
``axis_names``. ``mesh.shape['data']`` is the shard count, as in JAX.
Shards may share a device, so four shards on ``cuda:0`` make a valid mesh,
as the JAX tests' eight virtual CPU devices do.

A mesh that ``parallel.multihost.global_mesh`` builds spans the shards of
every process of a ``torch.distributed`` group. Each process holds its own
shards (:meth:`Mesh.local_shards`), and the sharded indexes merge their
results across processes through ``dist.all_gather``
(``parallel/collectives.py``). A mesh that :func:`create_mesh` builds
belongs to this process alone.

A layout is a plain description, JAX's ``PartitionSpec`` without the
``NamedSharding``: :func:`batch_sharding` is ``(axis,)`` (the leading axis
split over ``axis``), :func:`replicated` is ``()``. :func:`shard_batch`
(JAX :44) cuts the host's global batch to this rank's rows: the
data-parallel step runs one process per device.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.device import resolve_device


class Mesh:
    """Shards laid out over devices.

    Args:
      devices: object array of ``torch.device``, one per mesh position,
        already in the mesh's shape.
      axis_names: one name per axis of ``devices``.
      owners: int array of ``devices``' shape, the rank of the process
        holding each position (default: all this process's).
      distributed: the mesh spans a ``torch.distributed`` group, so a
        merge gathers every rank's candidates (also at world size 1).
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = ("data",),
                 owners: Optional[np.ndarray] = None, distributed: bool = False):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"{devices.ndim}-D devices need {devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, devices.shape))
        self.owners = (np.zeros(devices.shape, np.int64) if owners is None
                       else np.asarray(owners, np.int64).reshape(devices.shape))
        self.distributed = distributed
        if distributed:
            import torch.distributed as dist

            self.rank, self.world = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, self.world = 0, 1

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _along(self, arr: np.ndarray, axis: str) -> np.ndarray:
        """``arr``'s entries along ``axis``, at position 0 of every other
        axis: the shards that axis splits a corpus into."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}; its axes are {self.axis_names}")
        a = self.axis_names.index(axis)
        return np.moveaxis(arr, a, 0).reshape(self.shape[axis], -1)[:, 0]

    def shard_devices(self, axis: str = "data") -> List[torch.device]:
        """The device of each shard along ``axis``, in shard order."""
        return list(self._along(self.devices, axis))

    def local_shards(self, axis: str = "data") -> List[int]:
        """The shards along ``axis`` that this process holds, in order."""
        return [s for s, r in enumerate(self._along(self.owners, axis)) if r == self.rank]

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices.reshape(-1))
        return (f"Mesh({dict(self.shape)}, devices=[{devs}]"
                + (f", rank {self.rank} of {self.world}" if self.distributed else "") + ")")


def _object_array(items: Sequence) -> np.ndarray:
    """A 1-D object array of ``items`` (numpy would unpack sequences)."""
    arr = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        arr[i] = x
    return arr


def visible_cards() -> List[torch.device]:
    """One ``torch.device`` per visible CUDA card; raises without a card
    (there is no fallback to the CPU: pass CPU devices explicitly)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass devices= explicitly "
            "(e.g. [torch.device('cpu')] * 8 for a mesh of CPU shards)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(shape: Optional[Tuple[int, ...]] = None,
                axis_names: Sequence[str] = ("data",), devices=None) -> Mesh:
    """1-D data mesh over ``devices`` (default: one shard per visible card);
    pass ``shape`` for multi-axis layouts (e.g. (4, 2) with ('data',
    'model')). A device may appear more than once: each entry is a shard."""
    devices = visible_cards() if devices is None else [resolve_device(d) for d in devices]
    if shape is None or len(shape) == 0:
        shape = (len(devices),)
        axis_names = tuple(axis_names)[:1]
    n = int(np.prod(shape))
    if n > len(devices) or n < 1:
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, got {len(devices)}")
    return Mesh(_object_array(devices[:n]).reshape(shape), tuple(axis_names))


def batch_sharding(mesh: Mesh, axis: str = "data") -> tuple:
    """Leading-axis (batch) sharding over ``axis``: ``(axis,)``."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {mesh.axis_names}")
    return (axis,)


def replicated(mesh: Mesh) -> tuple:
    """Every shard holds the whole leaf: ``()``."""
    return ()


def map_batch(fn, batch):
    """``fn`` over every array of a batch: a ``SessionGraph`` (or another
    named tuple), a tuple, a list or a dict of arrays."""
    if isinstance(batch, dict):
        return {k: map_batch(fn, v) for k, v in batch.items()}
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(map_batch(fn, v) for v in batch))
    if isinstance(batch, (tuple, list)):
        return type(batch)(map_batch(fn, v) for v in batch)
    return fn(batch)


def rank_device(mesh: Mesh, axis: str = "data") -> Tuple[int, torch.device]:
    """This process's one shard along ``axis`` and its device; raises for a
    mesh whose process holds another number of shards (data parallelism
    runs one process per device)."""
    local = mesh.local_shards(axis)
    if len(local) != 1:
        raise ValueError(
            f"data parallelism runs one process per device, but this process holds "
            f"{len(local)} shards of {mesh}: build the mesh with one local device per rank "
            "(global_mesh(local_devices=[device])); meshes with several shards per process "
            "serve the sharded indexes")
    return local[0], mesh.shard_devices(axis)[local[0]]


def shard_batch(batch: Any, mesh: Mesh, axis: str = "data"):
    """This rank's rows of the host's global ``batch`` (numpy arrays or
    tensors), as tensors on its device: shard ``s`` of ``n`` takes rows
    [s B / n, (s + 1) B / n). The batch size must divide the axis size."""
    shard, device = rank_device(mesh, axis)
    n = mesh.shape[axis]
    sizes = {int(x.shape[0]) for x in _leaves(batch)}
    if len(sizes) != 1 or next(iter(sizes)) % n:
        raise ValueError(f"batch sizes {sorted(sizes)} must be one size that divides "
                         f"the mesh's {n} shards")
    per = next(iter(sizes)) // n
    return map_batch(lambda x: torch.as_tensor(x[shard * per: (shard + 1) * per]).to(device),
                     batch)


def _leaves(batch) -> list:
    out = []
    map_batch(out.append, batch)
    return out
