"""Binary hash-code index (counterpart of
``sessionsimilaritysearch_tpu/index/binary.py:122`` ``BinaryIndex``).

Two storage modes, both exact:

- 'packed': 1 bit per code bit, transposed-packed (``ops/hamming.py``
  ``pack_bits_t`` layout: [slots / 32, bits_pad] int32, slots in whole
  2048-row pack blocks, width padded to a multiple of 128 with zero bits).
  Search runs the packed-scan kernel K4 (``ops/packed.py``) over the used
  pack blocks, with query pad columns held at zero. A removal moves code
  BITS between words (:func:`_t_move_bits`, JAX :75-119) and zeroes the
  freed slots, the invariant that packed adds rely on.
- 'sign': +-1 bf16 rows (2 bytes per code bit), ranked by the fused score
  scan K1 (``ops/mips.py``) over the filled rows. ``selection='approx'``
  (``lax.approx_max_k`` in JAX) runs the exact selection
  (``ops/topk.py``).

Any ``k`` runs through the kernels: the buckets are contiguous, so the
JAX routing around the Pallas grid's ``rows_per_bucket`` floor
(:285-297) has no counterpart, and the selection ranks every score when
``k`` exceeds the bucket count. A CUDA index launches its kernel or raises;
nothing falls back. Results follow ``faiss.IndexBinaryFlat``: distances
ascending (int32), ids (int64), missing slots (INT32_MAX, -1). The
maintenance verbs and the npz snapshot follow the JAX index, key for key,
so each package loads the other's file.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.index.dense import (
    _range_from_search,
    compaction_plan,
    positional_mask,
)
from sessionsimilaritysearch_tpu_torch.ops import hamming
from sessionsimilaritysearch_tpu_torch.ops.topk import check_selection


def _t_move_bits(buf: torch.Tensor, src: np.ndarray, dst: np.ndarray,
                 new_size: int, old_size: int, block_rows: int) -> None:
    """Transposed-layout compaction in place: move the code of slot src[i]
    to slot dst[i] and zero every slot of [new_size, old_size).

    A slot's code is bit j of packed row p across all columns
    (``hamming.t_slot_coords``), so a row move is a bit move: gather the
    source bits, clear each destination bit and each freed bit (one int32
    mask per touched packed row), then OR the gathered bits in. The bits
    of one mask, and the bits written into one row, are distinct, so an
    int32 ``index_add_`` is their OR, bit 31 included. Gathering comes
    first, so a source in the freed range is read before it is cleared."""
    dev = buf.device

    def coords(slots):
        p, j = hamming.t_slot_coords(slots.astype(np.int64), block_rows)
        return torch.from_numpy(p).to(dev), torch.from_numpy(j).to(dev)

    p_src, j_src = coords(src)
    p_dst, j_dst = coords(dst)
    bits = (buf[p_src] >> j_src[:, None].to(torch.int32)) & 1       # [M, bits]
    p_free, j_free = coords(np.arange(new_size, old_size))
    p_clear = torch.cat([p_dst, p_free])
    rows, inv = torch.unique(p_clear, return_inverse=True)
    one = torch.ones((), dtype=torch.int32, device=dev)
    masks = torch.zeros(rows.shape[0], dtype=torch.int32, device=dev).index_add_(
        0, inv, one << torch.cat([j_dst, j_free]).to(torch.int32))
    buf[rows] &= ~masks[:, None]
    buf.index_add_(0, p_dst, bits << j_dst[:, None].to(torch.int32))


def _t_or_bits(buf: torch.Tensor, bits: torch.Tensor, start: int, block_rows: int) -> None:
    """OR [m, <= bits_pad] bool code bits into the transposed words of the
    slots [start, start + m) (their bits are zero: freed slots are zeroed).
    The slots that share a bit j lie in distinct packed rows, so one indexed
    OR per j writes them all, and the words equal the JAX index's
    scatter-add, bit 31 included."""
    vals = torch.nn.functional.pad(bits.to(torch.int32), (0, buf.shape[1] - bits.shape[1]))
    p, j = hamming.t_slot_coords(np.arange(start, start + bits.shape[0]), block_rows)
    for jj in np.unique(j):
        sel = np.flatnonzero(j == jj)
        rows = torch.from_numpy(p[sel]).to(buf.device)
        buf[rows] |= vals[torch.from_numpy(sel).to(buf.device)] << int(jj)


class BinaryIndex:
    """Flat exact Hamming index over sign codes [*, n_bits].

    ``mode``: 'packed' (1 bit per bit, kernel K4) or 'sign' (+-1 bf16 rows,
    kernel K1). ``selection``: 'exact', or 'approx' (sign mode only, as in
    JAX), which runs the exact selection and keeps ``recall_target``."""

    def __init__(
        self,
        n_bits: int,
        capacity: int,
        mode: str = "sign",
        *,
        device,
        selection: str = "exact",
        recall_target: float = 0.95,
    ):
        if mode not in ("packed", "sign"):
            raise ValueError(f"unknown mode {mode!r}")
        if selection not in ("exact", "approx"):
            raise ValueError(f"unknown selection {selection!r}")
        check_selection(selection, recall_target)
        if selection == "approx" and mode != "sign":
            raise ValueError("approx selection is wired for the sign-matmul path")
        self.n_bits = n_bits
        self.capacity = capacity
        self.mode = mode
        self.selection = selection
        self.recall_target = recall_target
        self.device = resolve_device(device)
        self.size = 0
        if mode == "packed":
            self.block_rows = hamming.TBLOCK
            self.bits_pad = -(-n_bits // 128) * 128
            slots = -(-capacity // self.block_rows) * self.block_rows
            self._buf = torch.zeros((slots // 32, self.bits_pad), dtype=torch.int32,
                                    device=self.device)
        else:
            self._buf = -torch.ones((capacity, n_bits), dtype=torch.bfloat16,
                                    device=self.device)

    @property
    def ntotal(self) -> int:  # FAISS-compatible name
        return self.size

    def _signs(self, x) -> torch.Tensor:
        """Sign codes [m, n_bits] (+-1 or {0, 1}; numpy or tensor) -> bool
        bits on the index's device."""
        x = torch.as_tensor(x)
        if x.dim() != 2 or x.shape[1] != self.n_bits:
            raise ValueError(f"expected [m, {self.n_bits}] codes, got {tuple(x.shape)}")
        return (x.to(self.device) > 0)

    def add(self, signs) -> None:
        """Append [m, n_bits] sign codes. Packed mode ORs each code bit into
        its transposed word (:func:`_t_or_bits`)."""
        bits = self._signs(signs)
        m = bits.shape[0]
        if self.size + m > self.capacity:
            raise ValueError(f"index full: {self.size}+{m} > capacity {self.capacity}")
        if self.mode == "packed":
            _t_or_bits(self._buf, bits, self.size, self.block_rows)
        else:
            self._buf[self.size: self.size + m] = torch.where(bits, 1.0, -1.0).to(
                torch.bfloat16)
        self.size += m

    def _codes(self, ids: np.ndarray) -> torch.Tensor:
        """Stored codes by position as [m, n_bits] f32 +-1 rows on the
        index's device (packed mode extracts bit j of the transposed words
        at the slots' coordinates)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.size):
            raise IndexError(f"reconstruct ids must lie in [0, {self.size})")
        if self.mode == "packed":
            p, j = hamming.t_slot_coords(ids, self.block_rows)
            words = self._buf[torch.from_numpy(p).to(self.device), : self.n_bits]
            jt = torch.from_numpy(j.astype(np.int32)).to(self.device)
            return (2.0 * ((words >> jt[:, None]) & 1) - 1.0).float()
        return self._buf[torch.from_numpy(ids).to(self.device)].float()

    def reconstruct_batch(self, ids) -> np.ndarray:
        """Stored codes by position as [m, n_bits] float32 +-1 rows."""
        return self._codes(ids).cpu().numpy()

    def reconstruct(self, i: int) -> np.ndarray:
        """Single-row form: [n_bits] float32 +-1."""
        return self.reconstruct_batch([int(i)])[0]

    def search(self, q_signs, k: int, row_mask=None) -> Tuple[np.ndarray, np.ndarray]:
        """(Hamming distances [q, k] int32 ascending, ids [q, k] int64) as
        numpy arrays. ``row_mask``: optional bool array over the rows
        (length ``size`` or ``capacity``); False rows never rank."""
        d, i = self.search_device(q_signs, k, row_mask=row_mask)
        return d.cpu().numpy(), i.cpu().numpy()

    def search_device(self, q_signs, k: int, row_mask=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`search` returning tensors on the index's device, for a
        caller whose next step runs there (two-stage serving's re-rank)."""
        q = torch.where(self._signs(q_signs), 1.0, -1.0).to(torch.bfloat16)
        nq = q.shape[0]
        if self.size == 0:
            return (torch.full((nq, k), hamming.INT32_MAX, dtype=torch.int32,
                               device=self.device),
                    torch.full((nq, k), -1, dtype=torch.int64, device=self.device))
        mask = (None if row_mask is None
                else positional_mask(row_mask, self.size, self.capacity, self.device))
        if self.mode == "sign":
            return hamming.sign_topk(q, self._buf[: self.size], k, self.n_bits,
                                     mode=self.selection,
                                     recall_target=self.recall_target, row_mask=mask)
        # scan the used pack blocks only; their rows at or past size are
        # zero words (all -1 codes) and are masked by valid_count
        used = self._t_used_rows()
        if mask is not None:
            mask = torch.nn.functional.pad(mask, (0, used * 32 - self.size))
        q = torch.nn.functional.pad(q, (0, self.bits_pad - self.n_bits))
        return hamming.packed_t_topk(q, self._buf[:used], k, self.n_bits,
                                     valid_count=self.size, row_mask=mask)

    def remove_ids(self, ids) -> int:
        """Remove codes by row id (``faiss.IndexBinaryFlat.remove_ids``):
        surviving tail rows move into the freed slots as
        ``index.dense.compaction_plan`` says, so row ids renumber as in
        FAISS. Packed mode moves code bits and zeroes the freed slots
        (:func:`_t_move_bits`; also when no row moves), sign mode moves
        rows. Returns the number of rows removed."""
        src, dst, new_size = compaction_plan(self.size, ids)
        removed = self.size - new_size
        if self.mode == "packed":
            if removed:
                _t_move_bits(self._buf, src, dst, new_size, self.size, self.block_rows)
        elif src.size:
            s = torch.from_numpy(src.astype(np.int64)).to(self.device)
            d = torch.from_numpy(dst.astype(np.int64)).to(self.device)
            self._buf[d] = self._buf[s]  # src >= new_size > dst: no overlap
        self.size = new_size
        return removed

    def range_search(self, q_signs, radius: float, k0: int = 128, row_mask=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All codes within Hamming distance ``radius`` of each query
        (``faiss.IndexBinaryFlat.range_search``). Returns FAISS's CSR triple
        ``(lims [q+1] int64, D, I)`` with each query's slice nearest-first.
        Exact: a top-k whose depth doubles from ``k0`` until each query's
        deepest hit lies past the radius. Refused under
        ``selection='approx'``, as in JAX."""
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

    def merge_from(self, other: "BinaryIndex", batch: int = 65536) -> int:
        """Append ``other``'s stored codes (``faiss.IndexBinaryFlat.merge_from``):
        ids shift by ``self.ntotal``, ``other`` is left intact. Works across
        storage modes: codes stream through the device in ``batch``-row
        chunks into :meth:`add`. Returns the row count appended."""
        if not isinstance(other, BinaryIndex):
            raise TypeError(
                f"merge_from source must be a BinaryIndex, got {type(other).__name__}")
        if other.n_bits != self.n_bits:
            raise ValueError(f"code width mismatch: {self.n_bits} vs {other.n_bits}")
        if self.size + other.size > self.capacity:
            raise ValueError(f"index full: {self.size}+{other.size} > {self.capacity}")
        for start in range(0, other.size, batch):
            self.add(other._codes(np.arange(start, min(start + batch, other.size))))
        return other.size

    # --- persistence: the JAX index's npz, key for key
    def _t_used_rows(self) -> int:
        """Packed rows that can hold set bits at the current fill (whole pack
        blocks; later blocks are all zero by the invariant)."""
        return -(-self.size // self.block_rows) * (self.block_rows // 32)

    def save(self, path: str) -> None:
        """npz: sign rows as int8; packed words trimmed to the used pack
        blocks, with ``layout='t'`` and ``block_rows``."""
        extra = {}
        if self.mode == "sign":
            buf = self._buf[: self.size].to(torch.int8).cpu().numpy()
        else:
            buf = self._buf[: self._t_used_rows()].cpu().numpy()
            extra = {"layout": "t", "block_rows": self.block_rows}
        np.savez(path, buf=buf, n_bits=self.n_bits, capacity=self.capacity,
                 mode=self.mode, selection=self.selection,
                 recall_target=self.recall_target, size=self.size, **extra)

    @classmethod
    def load(cls, path: str, capacity: Optional[int] = None, *, device,
             **kw) -> "BinaryIndex":
        """Restore a snapshot of either package. A legacy row-major packed
        file (no ``layout``) is unpacked and re-ingested through :meth:`add`."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            idx = cls(int(z["n_bits"]), capacity or int(z["capacity"]), str(z["mode"]),
                      device=device, selection=str(z["selection"]),
                      recall_target=float(z["recall_target"]), **kw)
            size = int(z["size"])
            buf = z["buf"]
            layout = str(z["layout"]) if "layout" in z else None
            block_rows = int(z["block_rows"]) if "block_rows" in z else None
        if size > idx.capacity:
            raise ValueError(f"snapshot holds {size} rows > capacity {idx.capacity}")
        if not size:
            return idx
        if idx.mode == "sign":
            idx._buf[:size] = torch.from_numpy(buf).to(idx.device, torch.bfloat16)
            idx.size = size
        elif layout is not None:
            if block_rows != idx.block_rows:
                raise ValueError(
                    f"pack block mismatch: snapshot {block_rows} vs {idx.block_rows}")
            idx._buf[: buf.shape[0]] = torch.from_numpy(buf).to(idx.device)
            idx.size = size
        else:  # legacy row-major packed words
            idx.add(hamming.unpack_bits_np(buf, idx.n_bits))
        return idx
