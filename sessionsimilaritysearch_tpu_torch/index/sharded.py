"""The sharded dense index (counterpart of
``sessionsimilaritysearch_tpu/index/sharded.py``: ``plan_sharded_removal``
:30, ``global_id_positions`` :68, ``ShardedDenseIndex`` :90).

Rows stripe across the mesh's ``data`` axis a batch at a time: row i of an
m-row batch lands on shard i // (m / shards), so each shard holds a ring of
rows in global insertion order. Each shard keeps its own buffer, its rows'
global ids and, for int8 storage, their scales, on its own device; the host
mirrors (per-shard fills, each slot's global id, the next id) cover every
shard, as in JAX. A search scans every shard with the port's kernels and
merges the per-shard candidates (``parallel/collectives.py``). Global ids
are stable: a removal compacts each owning shard swap-with-last, and ids
move with their rows.

``_ShardedRows`` holds the bookkeeping that the three sharded indexes
share (this one, ``ShardedBinaryIndex`` and ``ShardedTwoStageIndex``).
Snapshots are the JAX index's npz, key for key, so each package loads the
other's, re-striped onto a different shard count.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.index.dense import (
    _DTYPE_NAMES,
    _DTYPES,
    _named_dtype,
    _range_from_search,
    compaction_plan,
)
from sessionsimilaritysearch_tpu_torch.ops import mips_int8
from sessionsimilaritysearch_tpu_torch.ops.topk import check_selection, l2_normalize
from sessionsimilaritysearch_tpu_torch.parallel.collectives import gather_shards, sharded_topk
from sessionsimilaritysearch_tpu_torch.parallel.mesh import Mesh
from sessionsimilaritysearch_tpu_torch.parallel.sharding import ShardedTensor, sharded_rows


def plan_sharded_removal(host_ids, fills, gids):
    """Per-shard swap-with-last plans for removing global ids from a
    striped corpus. ``host_ids``: [ndev, shard_rows] host mirror of each
    slot's global id (-1 = empty); ``fills``: [ndev] per-shard fill.

    Returns (src [ndev, P], dst [ndev, P], new_fills [ndev]) with every
    shard's move list padded to a common power-of-two length P (min 8)
    using identity moves of the shard's LAST slot (never a real
    destination). Unlike the single-device compaction, global ids move WITH
    their rows -- surviving ids never change. Raises if any gid is
    absent."""
    ndev, shard_rows = host_ids.shape
    gids = np.unique(np.asarray(gids, np.int64).reshape(-1))
    plans = []
    found = 0
    for s in range(ndev):
        valid = host_ids[s, : fills[s]]
        local = np.flatnonzero(np.isin(valid, gids))
        found += local.size
        plans.append(compaction_plan(int(fills[s]), local))
    if found != gids.size:
        present = np.isin(gids, host_ids[host_ids >= 0])
        missing = gids[~present]
        raise ValueError(
            f"{missing.size} ids not present (already removed or never "
            f"inserted), e.g. {missing[:5].tolist()}"
        )
    width = max(max((p[0].size for p in plans), default=0), 1)
    P = max(8, 1 << (width - 1).bit_length())
    src = np.full((ndev, P), shard_rows - 1, np.int32)
    dst = np.full((ndev, P), shard_rows - 1, np.int32)
    new_fills = np.empty(ndev, np.int64)
    for s, (ps, pd, nf) in enumerate(plans):
        src[s, : ps.size], dst[s, : pd.size] = ps, pd
        new_fills[s] = nf
    return src, dst, new_fills


def global_id_positions(host_ids, fills, gids) -> np.ndarray:
    """Locate global ids in a striped corpus: [m] global row positions
    (shard-major: shard * shard_rows + slot) for ``gids``, in the order
    given. ``host_ids``/``fills`` as in :func:`plan_sharded_removal`.
    Raises KeyError for ids that are absent (never inserted, or removed)."""
    gids = np.asarray(gids, np.int64).reshape(-1)
    ndev, shard_rows = host_ids.shape
    valid = np.arange(shard_rows)[None, :] < np.asarray(fills)[:, None]
    flat_ids = np.where(valid, host_ids, -1).reshape(-1)
    order = np.argsort(flat_ids, kind="stable")
    pos_in_sorted = np.searchsorted(flat_ids, gids, sorter=order)
    if gids.size:
        bad = (pos_in_sorted >= flat_ids.size) | (
            flat_ids[order[np.minimum(pos_in_sorted, flat_ids.size - 1)]]
            != gids
        )
        if bad.any():
            raise KeyError(f"ids not present: {gids[bad][:8].tolist()}")
    return order[pos_in_sorted]


def _load_npz(path: str):
    return np.load(path if path.endswith(".npz") else path + ".npz")


def _restripe(z, key: str, saved_ndev: int, fills: np.ndarray, order: np.ndarray,
              width: Optional[int] = None) -> np.ndarray:
    """The saved shards' valid rows of ``z[key]`` ([saved_ndev * rows, ...]),
    concatenated and put in global id order."""
    a = np.asarray(z[key])
    a = a.reshape(saved_ndev, -1, *a.shape[1:]) if width is None else \
        a.reshape(saved_ndev, -1, width)
    return np.concatenate([a[s, : fills[s]] for s in range(saved_ndev)])[order]


class _ShardedRows:
    """Host bookkeeping of a striped corpus: the mesh's local shards and
    their devices, per-shard fills, each slot's global id (``_host_ids``),
    the next id, one device id tensor per local shard (``_ids``), and the
    removal and lookup plans built on them."""

    def _init_rows(self, mesh: Mesh, axis: str, capacity: int, slot_group: int = 1):
        self.mesh, self.axis = mesh, axis
        self.ndev = mesh.shape[axis]
        if capacity % self.ndev:
            raise ValueError(f"capacity {capacity} must divide evenly over {self.ndev} shards")
        self.capacity = capacity
        self.shard_rows = capacity // self.ndev
        self._local = mesh.local_shards(axis)
        if not self._local:
            raise ValueError("this process holds no shard of the mesh")
        devs = mesh.shard_devices(axis)
        self._devices = [devs[s] for s in self._local]
        self.size = 0
        # per-shard fills: equal while append-only, divergent after removals
        self._fill = np.zeros(self.ndev, np.int64)
        # ids are stable under removal and never reused
        self._next_id = 0
        self._host_ids = np.full((self.ndev, self.shard_rows), -1, np.int64)
        # device ids per physical slot: a shard's slots round up to whole
        # ``slot_group``s (packed shards)
        self.slots_pad = -(-self.shard_rows // slot_group) * slot_group
        self._ids = [torch.full((self.slots_pad,), -1, dtype=torch.int64, device=d)
                     for d in self._devices]

    @property
    def ntotal(self) -> int:
        return self.size

    def _stripe(self, m: int, what: str) -> int:
        """Rows per shard of an m-row batch; raises unless m divides over
        the shards and fits."""
        if m % self.ndev:
            raise ValueError(f"insert batch {m} not divisible by {self.ndev} shards")
        per = m // self.ndev
        if int(self._fill.max()) + per > self.shard_rows:
            raise ValueError(f"{what} full")
        return per

    def _write_ids(self, j: int, s: int, per: int) -> None:
        """Global ids of shard s's part of the batch being added, at its fill."""
        f = int(self._fill[s])
        first = self._next_id + s * per
        self._ids[j][f: f + per] = torch.arange(first, first + per, device=self._devices[j])

    def _commit_add(self, m: int, per: int) -> None:
        for s in range(self.ndev):
            f = int(self._fill[s])
            self._host_ids[s, f: f + per] = np.arange(
                self._next_id + s * per, self._next_id + (s + 1) * per)
        self._next_id += m
        self._fill += per
        self.size += m

    def _remove(self, gids, move: Callable) -> int:
        """Remove global ids: ``move(j, src, dst, new_fill, old_fill)``
        applies local shard j's swap-with-last moves (int64 tensors on its
        device, identity padding dropped) to its buffers; the ids move here.
        Returns the number of rows removed; raises if any id is absent."""
        gids = np.unique(np.asarray(gids, np.int64).reshape(-1))
        if gids.size == 0:
            return 0
        src, dst, new_fills = plan_sharded_removal(self._host_ids, self._fill, gids)
        for j, s in enumerate(self._local):
            real = src[s] != dst[s]
            ps = torch.from_numpy(src[s][real].astype(np.int64)).to(self._devices[j])
            pd = torch.from_numpy(dst[s][real].astype(np.int64)).to(self._devices[j])
            move(j, ps, pd, int(new_fills[s]), int(self._fill[s]))
            if ps.numel():
                self._ids[j][pd] = self._ids[j][ps]  # src >= new fill > dst
        for s in range(self.ndev):
            self._host_ids[s, dst[s]] = self._host_ids[s, src[s]]
            self._host_ids[s, new_fills[s]:] = -1
        removed = self.size - int(new_fills.sum())
        self._fill = new_fills
        self.size = int(new_fills.sum())
        return removed

    def _rows_by_id(self, gids, width: int, fetch: Callable) -> np.ndarray:
        """[m, width] f32 rows of global ids, in the order given:
        ``fetch(j, slots)`` gives local shard j's rows at the slot tensor;
        rows of other ranks' shards arrive through an all-reduce (each row
        is nonzero on one rank only, so the sum is exact)."""
        gids = np.asarray(gids, np.int64).reshape(-1)
        pos = global_id_positions(self._host_ids, self._fill, gids)
        shard, slot = pos // self.shard_rows, pos % self.shard_rows
        out = torch.zeros((gids.size, width), dtype=torch.float32, device=self._devices[0])
        for j, s in enumerate(self._local):
            sel = np.flatnonzero(shard == s)
            if sel.size:
                rows = fetch(j, torch.from_numpy(slot[sel]).to(self._devices[j]))
                out[torch.from_numpy(sel).to(out.device)] = rows.float().to(out.device)
        if self.mesh.distributed:
            import torch.distributed as dist

            dist.all_reduce(out)
        return out.cpu().numpy()

    def _slot_masks(self, row_mask) -> Optional[List[torch.Tensor]]:
        """A bool mask keyed by GLOBAL id -> one bool mask per local shard
        over its slots; None for None."""
        if row_mask is None:
            return None
        gmask = np.asarray(row_mask, bool)
        if gmask.shape[0] < self._next_id:
            raise ValueError(
                f"row_mask length {gmask.shape[0]} < highest issued id {self._next_id} "
                "(masks are keyed by GLOBAL id)")
        out = []
        for j, s in enumerate(self._local):
            f = int(self._fill[s])
            m = np.zeros(self.slots_pad, bool)
            m[:f] = gmask[self._host_ids[s, :f]]
            out.append(torch.from_numpy(m).to(self._devices[j]))
        return out

    def _host(self, shards: List[torch.Tensor]) -> np.ndarray:
        """Every shard of a sharded tensor, concatenated in shard order, as
        one numpy array (bf16 as f32)."""
        full = torch.cat([t.cpu() for t in gather_shards(self.mesh, shards, self.axis)])
        return (full.float() if full.dtype == torch.bfloat16 else full).numpy()

    def _sharded(self, shards: List[torch.Tensor]) -> ShardedTensor:
        return sharded_rows(shards, self.mesh, self.axis)

    def _book_state(self) -> dict:
        return {"size": np.asarray(self.size), "fills": np.asarray(self._fill),
                "next_id": np.asarray(self._next_id), "host_ids": np.asarray(self._host_ids)}

    def _load_book(self, state: dict) -> None:
        self.size = int(state["size"])
        self._fill = np.asarray(state["fills"], np.int64).copy()
        self._next_id = int(state["next_id"])
        self._host_ids = np.asarray(state["host_ids"], np.int64).copy()

    def _set_even_fill(self, ids: np.ndarray) -> None:
        """After a re-striped load: ``ids`` (in insertion order) sit evenly
        at the head of every shard."""
        per = ids.size // self.ndev
        self.size = int(ids.size)
        self._fill = np.full(self.ndev, per, np.int64)
        self._host_ids[:, :per] = ids.reshape(self.ndev, per)


class ShardedDenseIndex(_ShardedRows):
    """Flat exact index over a corpus sharded across a mesh axis.

    Semantics match ``DenseIndex`` ('cos' / 'ip' metrics, FAISS-style (D, I)
    results) with GLOBAL insertion-order ids. ``quantize``: None, 'int8'
    (int8 codes and per-row scales per shard, bf16 queries) or 'int8x8'
    (queries quantized too, each shard's scan through K2). ``mode``: the
    per-chunk selection of ``ops.topk.chunked_topk``; ``chunk_size`` is
    clamped to the shard's rows.
    """

    def __init__(
        self,
        dim: int,
        capacity: int,
        mesh: Mesh,
        axis: str = "data",
        metric: str = "cos",
        dtype: torch.dtype = torch.float32,
        chunk_size: int = 262144,
        mode: str = "exact",
        quantize: Optional[str] = None,
        score_dtype: torch.dtype = torch.float32,
    ):
        if metric not in ("cos", "ip"):
            raise ValueError(f"unknown metric {metric!r} (the sharded index ranks 'cos'/'ip')")
        if quantize not in (None, "int8", "int8x8"):
            raise ValueError(f"unknown quantize {quantize!r}")
        if dtype not in _DTYPES or score_dtype not in _DTYPES:
            raise TypeError(
                f"dtype and score_dtype must be float32 or bfloat16, got {dtype} and {score_dtype}")
        check_selection(mode, 0.95)
        self._init_rows(mesh, axis, capacity)
        self.dim = dim
        self.metric = metric
        self.quantize = quantize
        self.dtype = torch.int8 if quantize else dtype
        self.score_dtype = score_dtype
        self.chunk_size = chunk_size
        self.mode = mode
        self._buf = [torch.zeros((self.shard_rows, dim), dtype=self.dtype, device=d)
                     for d in self._devices]
        self._scales = ([torch.zeros(self.shard_rows, dtype=torch.float32, device=d)
                         for d in self._devices] if quantize else None)

    def _write(self, j: int, start: int, rows: torch.Tensor,
               scales: Optional[torch.Tensor]) -> None:
        """Stored-form rows (and scales) into local shard j at ``start``."""
        dev = self._devices[j]
        self._buf[j][start: start + rows.shape[0]] = rows.to(dev, self.dtype)
        if scales is not None:
            self._scales[j][start: start + rows.shape[0]] = scales.to(dev)

    def add(self, emb) -> None:
        """Append [m, d] (numpy or tensor); m must be divisible by the shard
        count (pad on the host if needed). Each shard normalizes ('cos') and
        quantizes its own part, row by row as the whole batch would be. Rows
        keep global insertion-order ids."""
        emb = emb if isinstance(emb, torch.Tensor) else torch.as_tensor(np.asarray(emb))
        if emb.dim() != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"expected [m, {self.dim}] rows, got {tuple(emb.shape)}")
        m = emb.shape[0]
        per = self._stripe(m, "sharded index")
        for j, s in enumerate(self._local):
            x = emb[s * per: (s + 1) * per].to(
                self._devices[j], torch.float32 if self.quantize else self.dtype)
            if self.metric == "cos":
                x = l2_normalize(x)
            scales = None
            if self.quantize:
                x, scales = mips_int8.quantize_rows_int8(x)
            self._write(j, int(self._fill[s]), x, scales)
            self._write_ids(j, s, per)
        self._commit_add(m, per)

    def remove_ids(self, gids) -> int:
        """Remove rows by GLOBAL id (``faiss.Index.remove_ids``): each owning
        shard compacts swap-with-last, and ids move WITH their rows, so
        surviving ids are STABLE (the single-device ``DenseIndex``
        renumbers). Returns the number of rows removed; raises if any id is
        absent."""
        def move(j, src, dst, new_fill, old_fill):
            if src.numel():
                for buf in (self._buf, self._scales):
                    if buf is not None:
                        buf[j][dst] = buf[j][src]

        return self._remove(gids, move)

    def reconstruct_batch(self, gids) -> np.ndarray:
        """Stored rows by GLOBAL id, [m, d] float32 in the order given:
        unit-normalized under 'cos', code x scale under int8. Absent ids
        raise KeyError."""
        def fetch(j, slots):
            rows = self._buf[j][slots].float()
            return rows * self._scales[j][slots][:, None] if self.quantize else rows

        return self._rows_by_id(gids, self.dim, fetch)

    def reconstruct(self, gid: int) -> np.ndarray:
        """Single-row form: [d] float32 for one global id."""
        return self.reconstruct_batch([int(gid)])[0]

    # --- live state: the buffers (per local shard) and the host bookkeeping
    def state_dict(self) -> dict:
        """Complete serving state: the local shards' tensors (buf, ids,
        scales, each a ``ShardedTensor`` of the mesh's row boxes) and the
        host bookkeeping (fills, host id mirror, next id); a tree that
        ``utils.checkpoint.save_sharded`` writes shard by shard, and its
        restore template. ``size`` alone does not say which slots are valid
        (per-shard fills diverge after removals): restore through
        :meth:`load_state`."""
        state = {"buf": self._sharded(self._buf), "ids": self._sharded(self._ids),
                 **self._book_state()}
        if self.quantize:
            state["scales"] = self._sharded(self._scales)
        return state

    def load_state(self, state: dict) -> None:
        """Adopt a :meth:`state_dict` (the inverse of it)."""
        self._buf = state["buf"].local()
        self._ids = state["ids"].local()
        self._load_book(state)
        if self.quantize:
            self._scales = state["scales"].local()

    def search(self, queries, k: int, row_mask=None, out: str = "np"):
        """Global exact top-k: (D [q, k] float32 descending, I [q, k] int64
        global ids), numpy for ``out='np'``, tensors on the first local
        shard's device for ``out='device'``. ``row_mask``: optional bool
        array keyed by GLOBAL id (length >= the highest id issued); rows
        whose id maps to False never rank, and masks stay valid across
        removals."""
        if out not in ("np", "device"):
            raise ValueError(f"out must be 'np' or 'device', got {out!r}")
        qdtype = torch.bfloat16 if self.quantize else self.dtype
        q = torch.as_tensor(queries if isinstance(queries, torch.Tensor)
                            else np.asarray(queries)).to(self._devices[0], qdtype)
        if q.dim() != 2 or q.shape[1] != self.dim:
            raise ValueError(f"expected [q, {self.dim}] queries, got {tuple(q.shape)}")
        if self.metric == "cos":
            q = l2_normalize(q).to(qdtype)
        q_scales = None
        if self.quantize == "int8x8":
            q, q_scales = mips_int8.quantize_rows_int8(q)
        vals, ids = sharded_topk(
            q.contiguous(), self._buf, k, self.mesh, axis=self.axis, shard_ids=self._ids,
            valid_per_shard=self._fill, chunk_size=self.chunk_size, mode=self.mode,
            corpus_scales=self._scales, query_scales=q_scales,
            score_dtype=self.score_dtype, row_mask=self._slot_masks(row_mask),
        )
        if out == "device":
            return vals, ids
        return vals.cpu().numpy(), ids.cpu().numpy()

    def range_search(self, queries, radius: float, k0: int = 128, row_mask=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All rows within ``radius`` across every shard
        (``faiss.Index.range_search``): the CSR triple ``(lims [q+1], D,
        I)`` with STABLE global ids, each slice best-first. Exact: a top-k
        whose depth doubles from ``k0`` until each query's deepest hit falls
        outside the radius. ``row_mask`` as in :meth:`search`; refused under
        ``mode='approx'``, as in JAX."""
        if self.mode == "approx":
            raise ValueError(
                "range_search needs an exact selection mode: approx "
                "top-k can silently drop in-radius rows"
            )
        if not isinstance(queries, torch.Tensor):
            queries = np.asarray(queries)
        return _range_from_search(
            lambda k: self.search(queries, k, row_mask=row_mask),
            queries.shape[0], radius, descending=True, total=self.size, k0=k0,
        )

    # --- persistence: the JAX index's npz, key for key
    def save(self, path: str) -> None:
        """npz of the whole corpus (every shard, bf16 rows as f32), ids,
        fills and the serving configuration. On a mesh that spans
        processes every rank takes part and rank 0 writes."""
        extra = {}
        if self.quantize:
            extra["scales"] = self._host(self._scales)
            extra["quantize"] = self.quantize
        buf, ids = self._host(self._buf), self._host(self._ids).astype(np.int32)
        if self.mesh.rank:
            return
        np.savez(
            path, buf=buf, dtype=_DTYPE_NAMES[self.dtype], ids=ids, size=self.size,
            fills=self._fill, next_id=self._next_id, dim=self.dim, capacity=self.capacity,
            metric=self.metric, ndev=self.ndev, mode=self.mode,
            score_dtype=_DTYPE_NAMES[self.score_dtype], chunk_size=self.chunk_size, **extra,
        )

    @classmethod
    def load(cls, path: str, mesh: Mesh, **kw) -> "ShardedDenseIndex":
        """Restore a snapshot of either package on ``mesh``, re-striping the
        rows if the shard count changed, with its serving configuration.
        Keyword overrides win; ``quantize`` must match the snapshot's."""
        with _load_npz(path) as z:
            quantize = str(z["quantize"]) if "quantize" in z else None
            if "quantize" in kw and kw.pop("quantize") != quantize:
                raise ValueError(
                    f"snapshot was saved with quantize={quantize!r}; stored rows "
                    "are already in that storage form and cannot be re-quantized")
            kw.setdefault("mode", str(z["mode"]) if "mode" in z else "exact")
            kw.setdefault("score_dtype", _named_dtype(str(z["score_dtype"]))
                          if "score_dtype" in z else torch.float32)
            kw.setdefault("chunk_size", int(z["chunk_size"]) if "chunk_size" in z else 262144)
            if "dtype" in z and not quantize:
                kw.setdefault("dtype", _named_dtype(str(z["dtype"])))
            idx = cls(dim=int(z["dim"]), capacity=int(z["capacity"]), mesh=mesh,
                      metric=str(z["metric"]), quantize=quantize, **kw)
            saved_ndev = int(z["ndev"]) if "ndev" in z else idx.ndev
            size = int(z["size"])
            fills = (np.asarray(z["fills"], np.int64) if "fills" in z
                     else np.full(saved_ndev, size // saved_ndev, np.int64))
            next_id = int(z["next_id"]) if "next_id" in z else size
            if saved_ndev != idx.ndev:
                # each old shard's valid rows sit at its head (unequal fills
                # after removals): re-stripe in insertion order, evenly
                if size % idx.ndev:
                    raise ValueError(
                        f"index saved on {saved_ndev} shards holds {size} rows, "
                        f"not divisible across {idx.ndev} shards")
                flat_ids = _restripe(z, "ids", saved_ndev, fills, slice(None))
                order = np.argsort(flat_ids)
                rows = _restripe(z, "buf", saved_ndev, fills, order, idx.dim)
                scales = _restripe(z, "scales", saved_ndev, fills, order) if quantize else None
                ids = flat_ids[order].astype(np.int64)
                per = size // idx.ndev
                for j, s in enumerate(idx._local):
                    part = slice(s * per, (s + 1) * per)
                    idx._write(j, 0, torch.from_numpy(rows[part]),
                               None if scales is None else torch.from_numpy(scales[part]))
                    idx._ids[j][:per] = torch.from_numpy(ids[part]).to(idx._devices[j])
                idx._set_even_fill(ids)
            else:
                rows = np.asarray(z["buf"]).reshape(idx.ndev, idx.shard_rows, idx.dim)
                all_ids = np.asarray(z["ids"], np.int64).reshape(idx.ndev, idx.shard_rows)
                sca = (np.asarray(z["scales"], np.float32).reshape(idx.ndev, idx.shard_rows)
                       if quantize else None)
                for j, s in enumerate(idx._local):
                    idx._write(j, 0, torch.from_numpy(rows[s]),
                               None if sca is None else torch.from_numpy(sca[s]))
                    idx._ids[j].copy_(torch.from_numpy(all_ids[s]))
                idx.size = size
                idx._fill = fills.copy()
                for s in range(idx.ndev):
                    idx._host_ids[s, : fills[s]] = all_ids[s, : fills[s]]
            idx._next_id = next_id
        return idx
