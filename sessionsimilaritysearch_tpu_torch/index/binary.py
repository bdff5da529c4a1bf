"""Binary hash-code index (counterpart of
``sessionsimilaritysearch_tpu/index/binary.py:122`` ``BinaryIndex``).

Two storage modes, both exact:

- 'packed': 1 bit per code bit, transposed-packed (``ops/hamming.py``
  ``pack_bits_t`` layout: [slots / 32, bits_pad] int32, slots in whole
  2048-row pack blocks, width padded to a multiple of 128 with zero bits).
  Search runs the packed-scan kernel K4 (``ops/packed.py``) over the used
  pack blocks, with query pad columns held at zero.
- 'sign': +-1 bf16 rows (2 bytes per code bit), ranked by the fused score
  scan K1 (``ops/mips.py``) over the filled rows.

Any ``k`` runs through the kernels: the buckets are contiguous, so the
JAX routing around the Pallas grid's ``rows_per_bucket`` floor
(:285-297) has no counterpart, and the selection ranks every score when
``k`` exceeds the bucket count. A CUDA index launches its kernel or raises;
nothing falls back. Results follow ``faiss.IndexBinaryFlat``: distances
ascending (int32), ids (int64), missing slots (INT32_MAX, -1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.ops import hamming


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"BinaryIndex {what} is not ported yet (ROADMAP.md Queue 1 item 6)"
    )


class BinaryIndex:
    """Flat exact Hamming index over sign codes [*, n_bits].

    ``mode``: 'packed' (1 bit per bit, kernel K4) or 'sign' (+-1 bf16 rows,
    kernel K1). ``selection='approx'`` is not ported (ROADMAP.md Queue 1
    item 2)."""

    def __init__(
        self,
        n_bits: int,
        capacity: int,
        mode: str = "sign",
        *,
        device,
        selection: str = "exact",
    ):
        if mode not in ("packed", "sign"):
            raise ValueError(f"unknown mode {mode!r}")
        if selection == "approx":
            raise NotImplementedError(
                "BinaryIndex selection='approx' is not ported yet (ROADMAP.md "
                "Queue 1 item 2)"
            )
        if selection != "exact":
            raise ValueError(f"unknown selection {selection!r}")
        self.n_bits = n_bits
        self.capacity = capacity
        self.mode = mode
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
        its transposed word: the slots of one add that share a bit j lie in
        distinct packed rows, so one indexed OR per j writes them all, and
        the words equal the JAX index's scatter-add, bit 31 included."""
        bits = self._signs(signs)
        m = bits.shape[0]
        if self.size + m > self.capacity:
            raise ValueError(f"index full: {self.size}+{m} > capacity {self.capacity}")
        if self.mode == "packed":
            vals = torch.nn.functional.pad(bits.to(torch.int32),
                                           (0, self.bits_pad - self.n_bits))
            p, j = hamming.t_slot_coords(np.arange(self.size, self.size + m),
                                         self.block_rows)
            for jj in np.unique(j):
                sel = np.flatnonzero(j == jj)
                rows = torch.from_numpy(p[sel]).to(self.device)
                self._buf[rows] |= vals[torch.from_numpy(sel).to(self.device)] << int(jj)
        else:
            self._buf[self.size: self.size + m] = torch.where(bits, 1.0, -1.0).to(
                torch.bfloat16)
        self.size += m

    def reconstruct_batch(self, ids) -> np.ndarray:
        """Stored codes by position as [m, n_bits] float32 +-1 rows."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.size):
            raise IndexError(f"reconstruct ids must lie in [0, {self.size})")
        if self.mode == "packed":
            p, j = hamming.t_slot_coords(ids, self.block_rows)
            words = self._buf[torch.from_numpy(p).to(self.device), : self.n_bits]
            jt = torch.from_numpy(j.astype(np.int32)).to(self.device)
            bits01 = (words >> jt[:, None]) & 1
            return (2.0 * bits01 - 1.0).float().cpu().numpy()
        rows = self._buf[torch.from_numpy(ids).to(self.device)]
        return rows.float().cpu().numpy()

    def reconstruct(self, i: int) -> np.ndarray:
        """Single-row form: [n_bits] float32 +-1."""
        return self.reconstruct_batch([int(i)])[0]

    def _prep_mask(self, row_mask) -> torch.Tensor:
        """Validate a positional bool mask (length ``size`` or ``capacity``)
        and return it as a bool tensor over the rows [0, size)."""
        mask = torch.as_tensor(row_mask, device=self.device)
        if mask.dim() != 1 or mask.shape[0] not in (self.size, self.capacity):
            raise ValueError(
                f"row_mask length {tuple(mask.shape)} matches neither size "
                f"{self.size} nor capacity {self.capacity}"
            )
        return mask[: self.size].to(torch.bool)

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
        mask = None if row_mask is None else self._prep_mask(row_mask)
        if self.mode == "sign":
            return hamming.sign_topk(q, self._buf[: self.size], k, self.n_bits,
                                     row_mask=mask)
        # scan the used pack blocks only; their rows at or past size are
        # zero words (all -1 codes) and are masked by valid_count
        used = -(-self.size // self.block_rows) * (self.block_rows // 32)
        if mask is not None:
            mask = torch.nn.functional.pad(mask, (0, used * 32 - self.size))
        q = torch.nn.functional.pad(q, (0, self.bits_pad - self.n_bits))
        return hamming.packed_t_topk(q, self._buf[:used], k, self.n_bits,
                                     valid_count=self.size, row_mask=mask)

    def remove_ids(self, ids) -> int:
        raise _not_ported("remove_ids (the bit moves of binary.py:75-119)")

    def range_search(self, q_signs, radius: float, k0: int = 128, row_mask=None):
        raise _not_ported("range_search")

    def merge_from(self, other: "BinaryIndex", batch: int = 65536) -> int:
        raise _not_ported("merge_from")

    def save(self, path: str) -> None:
        raise _not_ported("snapshots")

    @classmethod
    def load(cls, path: str, capacity: Optional[int] = None, **kw) -> "BinaryIndex":
        raise _not_ported("snapshots")
