"""The dense session-embedding index (counterpart of
``sessionsimilaritysearch_tpu/index/dense.py:151-389`` ``DenseIndex``).

The index IS the corpus: a fixed-capacity [capacity, dim] device buffer that
streaming adds append into. ``search`` scans the filled rows in
``chunk_size`` slices with the fused score + bucket-max kernel
(``ops/mips.py``, ``csrc/scores_bmax.cu``) and merges the per-chunk top-k,
so the score buffer stays [q, chunk_size] whatever the corpus size.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.ops import mips
from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize, merge_topk

_DTYPES = (torch.float32, torch.bfloat16)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"DenseIndex {what} is not ported yet (ROADMAP.md Queue 1 item 3)"
    )


class DenseIndex:
    """Flat exact index over a dense embedding corpus.

    metric: 'cos' (rows L2-normalized on add, queries on search, both in
    the storage dtype) or 'ip' (raw inner product). ``dtype`` is the
    storage dtype (float32 or bfloat16); ``score_dtype`` the dtype the
    kernel stores scores in (float32 = exact ranking; bfloat16 = exact at
    bf16 precision). Search results follow ``faiss.Index.search``: scores
    descending, missing slots (-inf, -1).
    """

    def __init__(
        self,
        dim: int,
        capacity: int,
        *,
        device,
        metric: str = "cos",
        dtype: torch.dtype = torch.float32,
        chunk_size: int = 65536,
        score_dtype: torch.dtype = torch.float32,
        quantize: Optional[str] = None,
        center=None,
    ):
        if metric == "l2":
            raise _not_ported("metric='l2'")
        if metric not in ("cos", "ip"):
            raise ValueError(f"unknown metric {metric!r}")
        if quantize is not None:
            raise _not_ported(f"quantize={quantize!r}")
        if center is not None:
            raise _not_ported("center=")
        if dtype not in _DTYPES or score_dtype not in _DTYPES:
            raise TypeError(
                f"dtype and score_dtype must be float32 or bfloat16, got "
                f"{dtype} and {score_dtype}"
            )
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        self.dim = dim
        self.capacity = capacity
        self.metric = metric
        self.dtype = dtype
        self.score_dtype = score_dtype
        self.chunk_size = chunk_size
        self.device = resolve_device(device)
        self._buf = torch.zeros((capacity, dim), dtype=dtype, device=self.device)
        self.size = 0

    @property
    def ntotal(self) -> int:  # FAISS-compatible name
        return self.size

    def _as_rows(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        if x.dim() != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected [m, {self.dim}] rows, got {tuple(x.shape)}")
        return x

    def add(self, emb) -> None:
        """Append embeddings [m, d] (numpy or tensor); under 'cos' rows are
        normalized in the storage dtype first."""
        emb = self._as_rows(emb)
        m = emb.shape[0]
        if self.size + m > self.capacity:
            raise ValueError(
                f"index full: {self.size}+{m} > capacity {self.capacity}"
            )
        if self.metric == "cos":
            emb = l2_normalize(emb).to(self.dtype)
        self._buf[self.size: self.size + m] = emb
        self.size += m

    def reconstruct_batch(self, ids) -> np.ndarray:
        """Stored rows by position, [m, d] float32, exactly as the index
        scores them (unit-normalized under 'cos')."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.size):
            raise IndexError(f"reconstruct ids must lie in [0, {self.size})")
        rows = self._buf[torch.from_numpy(ids).to(self.device)]
        return rows.float().cpu().numpy()

    def _penalty(self, row_mask) -> torch.Tensor:
        """Bool mask over the current rows (length ``size`` or
        ``capacity``) -> the kernel's additive per-row penalty [size]:
        0 where allowed, -inf where filtered."""
        mask = torch.as_tensor(row_mask, device=self.device)
        if mask.dim() != 1 or mask.shape[0] not in (self.size, self.capacity):
            raise ValueError(
                f"row_mask length {tuple(mask.shape)} matches neither size "
                f"{self.size} nor capacity {self.capacity}"
            )
        mask = mask[: self.size].to(torch.bool)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return torch.where(mask, zero, float("-inf")).contiguous()

    def search(self, queries, k: int, row_mask=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k over the filled rows. Returns (D [q, k] float32,
        I [q, k] int64) numpy arrays. ``row_mask``: optional bool array over
        the rows (length ``size`` or ``capacity``); rows where it is False
        never rank. The scan covers rows [0, size) only: the rows past
        ``size`` would all score -inf, so leaving them out changes no
        result."""
        queries = self._as_rows(queries)
        if self.metric == "cos":
            queries = l2_normalize(queries).to(self.dtype)
        queries = queries.contiguous()
        nq = queries.shape[0]
        penalty = None if row_mask is None else self._penalty(row_mask)
        vals = torch.full((nq, k), float("-inf"), device=self.device)
        idx = torch.full((nq, k), -1, dtype=torch.int64, device=self.device)
        for base in range(0, self.size, self.chunk_size):
            rows = min(self.chunk_size, self.size - base)
            c_vals, c_idx = mips.exact_topk(
                queries,
                self._buf[base: base + rows],
                k,
                penalty=None if penalty is None else penalty[base: base + rows],
                score_dtype=self.score_dtype,
            )
            c_idx = torch.where(c_idx >= 0, c_idx + base, c_idx)
            vals, idx = merge_topk(vals, idx, c_vals, c_idx, k)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def remove_ids(self, ids) -> int:
        raise _not_ported("remove_ids")

    def range_search(self, queries, radius: float, k0: int = 128, row_mask=None):
        raise _not_ported("range_search")

    def merge_from(self, other: "DenseIndex") -> int:
        raise _not_ported("merge_from")

    def snapshot(self) -> dict:
        raise _not_ported("snapshots")

    def save(self, path: str) -> None:
        raise _not_ported("snapshots")

    @classmethod
    def load(cls, path: str, capacity: Optional[int] = None, **kw) -> "DenseIndex":
        raise _not_ported("snapshots")
