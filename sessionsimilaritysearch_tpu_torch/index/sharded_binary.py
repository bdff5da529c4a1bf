"""The sharded binary (Hamming) index (counterpart of
``sessionsimilaritysearch_tpu/index/sharded_binary.py:51``
``ShardedBinaryIndex``).

Code rows stripe across the mesh's ``data`` axis a batch at a time, as in
``ShardedDenseIndex``. Each shard ranks its own codes by Hamming distance:
``mode='sign'`` keeps +-1 bf16 rows and scans them through K1
(``ops.hamming.sign_topk``); ``mode='packed'`` keeps the shard's codes
transposed-packed at 1 bit per bit ([slots / 32, bits_pad] int32, the
``BinaryIndex`` layout per shard, slots rounded up to whole 16,384-slot
groups as in JAX) and scans the used pack blocks through K4. The per-shard
candidates merge on their integer distances
(``parallel.collectives.sharded_hamming_topk``). Ids are STABLE global
insertion-order ids: a removal compacts each shard swap-with-last (packed
shards move code bits and zero the freed slots) and ids move with their
codes. Snapshots are the JAX index's npz, key for key; as in JAX, a
snapshot loads onto a mesh of its own shard count only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.index.binary import _t_move_bits, _t_or_bits
from sessionsimilaritysearch_tpu_torch.index.dense import _range_from_search
from sessionsimilaritysearch_tpu_torch.index.sharded import _load_npz, _ShardedRows
from sessionsimilaritysearch_tpu_torch.ops import hamming
from sessionsimilaritysearch_tpu_torch.ops.topk import check_selection
from sessionsimilaritysearch_tpu_torch.parallel.collectives import sharded_hamming_topk
from sessionsimilaritysearch_tpu_torch.parallel.mesh import Mesh

# packed shards round their slots up to whole groups (JAX index/binary.py:56)
_GROUP = 128 * 128


class ShardedBinaryIndex(_ShardedRows):
    """Flat exact Hamming index over codes sharded across a mesh axis.

    ``search`` returns FAISS-style ``(D, I)``: Hamming distances ascending
    (int32; missing INT32_MAX) and STABLE global ids (int64; -1 missing).
    ``selection='approx'`` (sign mode only, as in JAX) runs the exact
    selection and keeps ``recall_target``."""

    def __init__(
        self,
        n_bits: int,
        capacity: int,
        mesh: Mesh,
        axis: str = "data",
        mode: str = "sign",
        selection: str = "exact",
        recall_target: float = 0.95,
    ):
        if mode not in ("sign", "packed"):
            raise ValueError(f"unknown mode {mode!r}")
        if selection not in ("exact", "approx"):
            raise ValueError(f"unknown selection {selection!r}")
        check_selection(selection, recall_target)
        if selection == "approx" and mode != "sign":
            raise ValueError("approx selection is wired for the sign-matmul path")
        self._init_rows(mesh, axis, capacity, slot_group=_GROUP if mode == "packed" else 1)
        self.n_bits = n_bits
        self.mode = mode
        self.selection = selection
        self.recall_target = recall_target
        if mode == "packed":
            self.block_rows = hamming.TBLOCK
            self.bits_pad = -(-n_bits // 128) * 128
            self._buf = [torch.zeros((self.slots_pad // 32, self.bits_pad), dtype=torch.int32,
                                     device=d) for d in self._devices]
        else:
            self._buf = [-torch.ones((self.shard_rows, n_bits), dtype=torch.bfloat16, device=d)
                         for d in self._devices]

    def add(self, signs) -> None:
        """Append [m, n_bits] sign codes (+-1 or {0, 1}); m must divide by
        the shard count. Row i of the batch lands on shard i // (m /
        shards), keeping global id order."""
        signs = signs if isinstance(signs, torch.Tensor) else torch.as_tensor(np.asarray(signs))
        if signs.dim() != 2 or signs.shape[1] != self.n_bits:
            raise ValueError(f"expected [m, {self.n_bits}] codes, got {tuple(signs.shape)}")
        m = signs.shape[0]
        per = self._stripe(m, "sharded binary index")
        for j, s in enumerate(self._local):
            bits = signs[s * per: (s + 1) * per].to(self._devices[j]) > 0
            f = int(self._fill[s])
            if self.mode == "packed":
                _t_or_bits(self._buf[j], bits, f, self.block_rows)
            else:
                self._buf[j][f: f + per] = torch.where(bits, 1.0, -1.0).to(torch.bfloat16)
            self._write_ids(j, s, per)
        self._commit_add(m, per)

    def search(self, q_signs, k: int, row_mask=None, out: str = "np"):
        """Global exact Hamming top-k; ``row_mask`` is keyed by GLOBAL id
        (length >= the highest id issued) and stays valid across removals.
        ``out='device'`` returns tensors on the first local shard's
        device."""
        if out not in ("np", "device"):
            raise ValueError(f"out must be 'np' or 'device', got {out!r}")
        q = torch.as_tensor(q_signs if isinstance(q_signs, torch.Tensor)
                            else np.asarray(q_signs)).to(self._devices[0])
        if q.dim() != 2 or q.shape[1] != self.n_bits:
            raise ValueError(f"expected [q, {self.n_bits}] codes, got {tuple(q.shape)}")
        q = torch.where(q > 0, 1.0, -1.0).to(torch.bfloat16)
        packed_bits = None
        if self.mode == "packed":
            packed_bits = self.n_bits
            q = torch.nn.functional.pad(q, (0, self.bits_pad - self.n_bits))  # zero pad columns
        dist, ids = sharded_hamming_topk(
            q.contiguous(), self._buf, k, self.mesh, n_bits=self.n_bits, axis=self.axis,
            shard_ids=self._ids, valid_per_shard=self._fill, selection=self.selection,
            recall_target=self.recall_target,
            row_mask=self._slot_masks(row_mask), packed_bits=packed_bits,
        )
        if out == "device":
            return dist, ids
        return dist.cpu().numpy(), ids.cpu().numpy()

    def range_search(self, q_signs, radius: float, k0: int = 128, row_mask=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All codes within Hamming distance ``radius`` across every shard
        (``faiss.IndexBinaryFlat.range_search``): the CSR triple ``(lims
        [q+1], D, I)`` with STABLE global ids, each slice nearest-first.
        Exact; refused under ``selection='approx'``."""
        if self.selection == "approx":
            raise ValueError(
                "range_search needs selection='exact': approx top-k can "
                "silently drop in-radius rows"
            )
        if not isinstance(q_signs, torch.Tensor):
            q_signs = np.asarray(q_signs)
        return _range_from_search(
            lambda k: self.search(q_signs, k, row_mask=row_mask),
            q_signs.shape[0], radius, descending=False, total=self.size, k0=k0,
        )

    def remove_ids(self, gids) -> int:
        """Remove codes by GLOBAL id: each owning shard compacts
        swap-with-last (sign rows move; packed shards move code bits and
        zero the freed slots) and ids move with their codes, so surviving
        ids are STABLE. Returns the count removed; raises if any id is
        absent."""
        def move(j, src, dst, new_fill, old_fill):
            if self.mode == "packed":
                if new_fill < old_fill:
                    _t_move_bits(self._buf[j], src.cpu().numpy(), dst.cpu().numpy(),
                                 new_fill, old_fill, self.block_rows)
            elif src.numel():
                self._buf[j][dst] = self._buf[j][src]

        return self._remove(gids, move)

    def reconstruct_batch(self, gids) -> np.ndarray:
        """Stored codes by GLOBAL id as [m, n_bits] float32 +-1 rows; absent
        ids raise KeyError."""
        def fetch(j, slots):
            if self.mode == "sign":
                return self._buf[j][slots]
            p, jj = hamming.t_slot_coords(slots, self.block_rows)
            words = self._buf[j][p, : self.n_bits]
            return 2.0 * ((words >> jj[:, None].to(torch.int32)) & 1) - 1.0

        return self._rows_by_id(gids, self.n_bits, fetch)

    def reconstruct(self, gid: int) -> np.ndarray:
        """Single-row form: [n_bits] float32 +-1 for one global id."""
        return self.reconstruct_batch([int(gid)])[0]

    # --- live state (ShardedDenseIndex.state_dict semantics)
    def state_dict(self) -> dict:
        return {"buf": self._sharded(self._buf), "ids": self._sharded(self._ids),
                **self._book_state()}

    def load_state(self, state: dict) -> None:
        self._buf = state["buf"].local()
        self._ids = state["ids"].local()
        self._load_book(state)

    # --- persistence: the JAX index's npz, key for key
    def save(self, path: str) -> None:
        """npz of every shard's codes (sign rows as int8, packed words as
        they are), ids per physical slot and the host bookkeeping. On a
        mesh that spans processes every rank takes part and rank 0
        writes."""
        buf = self._host(self._buf if self.mode == "packed"
                         else [b.to(torch.int8) for b in self._buf])
        ids = self._host(self._ids).astype(np.int32)
        if self.mesh.rank:
            return
        np.savez(path, buf=buf, n_bits=self.n_bits, capacity=self.capacity, mode=self.mode,
                 selection=self.selection, recall_target=self.recall_target, size=self.size,
                 fills=self._fill, next_id=self._next_id, host_ids=self._host_ids, ids=ids,
                 ndev=self.ndev)

    @classmethod
    def load(cls, path: str, mesh: Mesh, capacity: Optional[int] = None,
             **kw) -> "ShardedBinaryIndex":
        """Restore a snapshot of either package on ``mesh``. The shard count
        must match the snapshot's (packed layouts are per shard; re-striping
        a binary corpus is a reconstruct -> add rebuild, as in JAX)."""
        with _load_npz(path) as z:
            if int(z["ndev"]) != mesh.shape[kw.get("axis", "data")]:
                raise ValueError(
                    f"snapshot saved on {int(z['ndev'])} shards; load onto a "
                    "matching mesh or rebuild via reconstruct_batch/add")
            idx = cls(int(z["n_bits"]), capacity or int(z["capacity"]), mesh,
                      mode=str(z["mode"]), selection=str(z["selection"]),
                      recall_target=float(z["recall_target"]), **kw)
            buf = torch.from_numpy(np.asarray(z["buf"]))
            ids = torch.from_numpy(np.asarray(z["ids"], np.int64))
            idx._load_book({key: z[key] for key in ("size", "fills", "next_id", "host_ids")})
        buf = buf.view(idx.ndev, -1, buf.shape[1])
        ids = ids.view(idx.ndev, -1)
        for j, s in enumerate(idx._local):
            rows = buf[s] if idx.mode == "packed" else buf[s].to(torch.bfloat16)
            idx._buf[j][: rows.shape[0]] = rows.to(idx._devices[j])
            idx._ids[j][: ids.shape[1]] = ids[s].to(idx._devices[j])
        return idx
