"""Multi-process helpers over ``torch.distributed`` (counterpart of
``sessionsimilaritysearch_tpu/parallel/multihost.py``:
``initialize_distributed`` :22, ``global_mesh`` :37,
``host_local_batch_to_global`` :46, ``process_slice`` :62).

Each process holds its own shards of a global mesh and keeps only their
rows: every rank calls a sharded index's ``add`` with the same global rows,
as JAX's global arrays have every process pass the whole batch
(``tests/multiproc_worker.py:104-107``). Searches scan the local shards and
merge every rank's candidates through ``dist.all_gather``
(``parallel/collectives.py``). The collectives run on NCCL for CUDA tensors
and on gloo for CPU ones.

Data-parallel training feeds each process its own rows: where JAX
assembles a global array from every process's slice
(``jax.make_array_from_process_local_data``), the port keeps each rank's
rows where they are (:func:`host_local_batch_to_global`) and the step's
collectives make the global batch's loss (``parallel/sharding.py``).
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.parallel.mesh import (
    Mesh,
    _leaves,
    _object_array,
    map_batch,
    rank_device,
    visible_cards,
)


# how long a rank waits for the others at the rendezvous and in a collective
TIMEOUT_S = 120.0


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """``torch.distributed.init_process_group`` over a TCP rendezvous at
    ``coordinator_address`` ('host:port'), ``num_processes`` ranks, this
    one ``process_id``. A no-op for one process without an address, as in
    JAX; given an address, one process forms a group of one (so that a
    single card runs the NCCL merge). CPU tensors go through gloo and CUDA
    ones through NCCL ('cpu:gloo,cuda:nccl'), or gloo alone where no card
    is visible; ranks wait ``TIMEOUT_S`` for each other."""
    if coordinator_address is None and (num_processes is None or num_processes <= 1):
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs coordinator_address, num_processes and process_id")
    dist.init_process_group(
        backend="cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 outside a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _gather_ints(values: Sequence[int], device: torch.device) -> List[List[int]]:
    """Every rank's ``values`` (the same length on each), by rank."""
    mine = torch.tensor(list(values), dtype=torch.int64, device=device)
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return [t.tolist() for t in out]


def global_mesh(axis_names: Sequence[str] = ("data",), shape=None,
                local_devices=None) -> Mesh:
    """Mesh over the shards of every process: each rank's
    ``local_devices`` (default: one per visible card), rank-major. Every
    rank must hold the same number of shards. Outside a process group this
    is ``create_mesh`` over ``local_devices``."""
    local = (visible_cards() if local_devices is None
             else [resolve_device(d) for d in local_devices])
    if not (dist.is_available() and dist.is_initialized()):
        devices, owners, distributed = local, [0] * len(local), False
    else:
        # a device is sent as its index (-1 for the CPU), on the device
        # that the backend moves for this mesh's tensors
        counts = _gather_ints([len(local)], local[0])
        if len({c[0] for c in counts}) != 1:
            raise ValueError(f"every rank must hold the same number of shards, got {counts}")
        idx = _gather_ints([-1 if d.type == "cpu" else d.index for d in local], local[0])
        devices = [torch.device("cpu") if i < 0 else torch.device("cuda", i)
                   for rank in idx for i in rank]
        owners = [r for r, rank in enumerate(idx) for _ in rank]
        distributed = True
    if shape is None:
        shape = (len(devices),)
        axis_names = tuple(axis_names)[:1]
    return Mesh(_object_array(devices).reshape(shape), tuple(axis_names),
                owners=np.asarray(owners).reshape(shape), distributed=distributed)


def process_slice(n_global: int) -> Tuple[int, int]:
    """This process's [start, end) slice of a length-``n_global`` leading
    axis split evenly over processes; the last takes the remainder."""
    p, n_proc = process_index(), process_count()
    per = n_global // n_proc
    return p * per, (p + 1) * per if p < n_proc - 1 else n_global


def host_local_batch_to_global(local_batch, mesh: Mesh, axis: str = "data"):
    """This process's rows of the global batch (each rank passes its own),
    as tensors on its device. Every rank must hold as many rows: the global
    batch is their concatenation in rank order."""
    _, device = rank_device(mesh, axis)
    sizes = {int(x.shape[0]) for x in _leaves(local_batch)}
    if len(sizes) != 1:
        raise ValueError(f"the batch's arrays have {sorted(sizes)} rows; want one count")
    if mesh.distributed:
        counts = _gather_ints([sizes.pop()], device)
        if len({c[0] for c in counts}) != 1:
            raise ValueError(f"every rank must hold as many rows, got {counts}")
    return map_batch(lambda x: torch.as_tensor(x).to(device), local_batch)
