"""Two-stage serving index: an exact Hamming prefilter over packed sign
codes, then an exact full-width re-rank (counterpart of
``sessionsimilaritysearch_tpu/index/twostage.py:70`` ``TwoStageIndex``, for
``prefilter in ('binary', 'itq')`` with ``stage1='packed'``).

Stage 1 codes every row as sign bits (SimHash ``sign(x @ R)`` or learned
ITQ ``sign((x - mean) @ components.T)``) and keeps them in a packed
``BinaryIndex``; a search takes the exact Hamming top-``pool`` through the
packed-scan kernel K4. Stage 2 (``ops/topk.py`` ``rerank_topk``) gathers
those rows from the full-width store and ranks them by f32 products, so the
returned ranking is exact over the pool.

The SimHash projection R [d, n_bits] is state: by default it is drawn from
a ``torch.Generator`` seeded with ``seed``, a different stream from the
JAX index's ``jax.random.normal(PRNGKey(seed))``; pass ``projection=`` (for
the JAX one, ``weights.simhash_projection``) to reproduce another index's
codes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex
from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize, rerank_topk


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"TwoStageIndex {what} is not ported yet (ROADMAP.md Queue 1 item {item})"
    )


def _signs(y: torch.Tensor) -> torch.Tensor:
    """Sign codes of projections: +1 where y >= 0, else -1, as bf16."""
    return torch.where(y >= 0, 1.0, -1.0).to(torch.bfloat16)


class TwoStageIndex:
    """Packed Hamming prefilter + exact re-rank over one embedding corpus.

    Args:
      dim, capacity: row width and the most rows the index holds.
      device: where the buffers live ('cpu' or a CUDA device).
      metric: 'cos' (rows and queries L2-normalized in f32) or 'ip'.
      prefilter: 'binary' (SimHash) or 'itq' (pass a fitted ``projector``
        from ``ops.projection.fit_itq``; its rows fix ``n_bits``). 'int8x8'
        and 'pca' are not ported (ROADMAP.md Queue 1 item 2).
      n_bits: SimHash code width.
      pool: default stage-1 candidates per query.
      store_dtype: dtype of the full-width rows (bf16 default, as in JAX).
      projector: fitted ITQ projector (anything with ``mean``,
        ``components`` and ``explained``; the JAX ``PCAProjector`` works as
        it is).
      seed: seed of the default SimHash projection.
      stage1: only 'packed' is ported; 'matmul' selects approximately
        (ROADMAP.md Queue 1 item 2).
      projection: SimHash projection [dim, n_bits] to use instead of the
        seeded draw.
    """

    def __init__(
        self,
        dim: int,
        capacity: int,
        *,
        device,
        metric: str = "cos",
        prefilter: str = "binary",
        n_bits: int = 256,
        pool: int = 512,
        store_dtype: torch.dtype = torch.bfloat16,
        projector=None,
        seed: int = 0,
        stage1: str = "matmul",
        projection=None,
    ):
        if metric not in ("cos", "ip"):
            raise ValueError(f"unknown metric {metric!r}")
        if prefilter in ("int8x8", "pca"):
            raise _not_ported(f"prefilter={prefilter!r}", 2)
        if prefilter not in ("binary", "itq"):
            raise ValueError(f"unknown prefilter {prefilter!r}")
        if stage1 == "matmul":
            raise _not_ported("stage1='matmul'", 2)
        if stage1 != "packed":
            raise ValueError(f"unknown stage1 {stage1!r}")
        self.dim = dim
        self.capacity = capacity
        self.metric = metric
        self.prefilter = prefilter
        self.pool = pool
        self.store_dtype = store_dtype
        self.device = resolve_device(device)
        self.size = 0
        if prefilter == "itq":
            if projector is None:
                raise ValueError("prefilter='itq' needs a fitted projector (fit_itq)")
            self._proj_mean = torch.as_tensor(
                np.asarray(projector.mean, np.float32), device=self.device)
            self._proj_comp = torch.as_tensor(
                np.asarray(projector.components, np.float32), device=self.device)
            n_bits = self._proj_comp.shape[0]
        elif projection is None:
            g = torch.Generator().manual_seed(seed)
            self._projection = torch.randn(dim, n_bits, generator=g).to(self.device)
        else:
            self._projection = torch.as_tensor(projection, dtype=torch.float32,
                                               device=self.device)
            if self._projection.shape != (dim, n_bits):
                raise ValueError(
                    f"projection must be [{dim}, {n_bits}], got "
                    f"{tuple(self._projection.shape)}"
                )
        self.n_bits = n_bits
        self._buf = torch.zeros((capacity, dim), dtype=store_dtype, device=self.device)
        self._codes_index = BinaryIndex(n_bits, capacity, "packed", device=self.device)

    @property
    def ntotal(self) -> int:
        return self.size

    def _codes(self, x: torch.Tensor) -> torch.Tensor:
        """Stage-1 sign codes [m, n_bits] of f32 rows (f32 products)."""
        if self.prefilter == "binary":
            return _signs(x @ self._projection)
        return _signs((x - self._proj_mean) @ self._proj_comp.T)

    def _rows(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.float32)
        if x.dim() != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected [m, {self.dim}] rows, got {tuple(x.shape)}")
        return l2_normalize(x) if self.metric == "cos" else x

    def add(self, emb) -> None:
        """Append [m, d] embeddings: the re-rank rows and their codes."""
        emb = self._rows(emb)
        m = emb.shape[0]
        if self.size + m > self.capacity:
            raise ValueError(f"index full: {self.size}+{m} > capacity {self.capacity}")
        self._buf[self.size: self.size + m] = emb.to(self.store_dtype)
        self._codes_index.add(self._codes(emb))
        self.size += m

    def reconstruct_batch(self, ids) -> np.ndarray:
        """Stored full-width rows by position, [m, d] float32, as the re-rank
        scores them."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.size):
            raise IndexError(f"reconstruct ids must lie in [0, {self.size})")
        return self._buf[torch.from_numpy(ids).to(self.device)].float().cpu().numpy()

    def reconstruct(self, i: int) -> np.ndarray:
        return self.reconstruct_batch([int(i)])[0]

    def _stage1(self, qn: torch.Tensor, pool: int, row_mask=None) -> torch.Tensor:
        """Exact Hamming top-``pool`` ids [q, pool] (int64, -1 missing)."""
        _, idx = self._codes_index.search_device(self._codes(qn), pool,
                                                 row_mask=row_mask)
        return idx

    def search_device(self, queries, k: int, pool: Optional[int] = None,
                      row_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`search` returning tensors on the index's device."""
        pool = min(max(pool or self.pool, k), max(self.capacity, 1))
        qn = self._rows(queries)
        cand = self._stage1(qn, pool, row_mask=row_mask)
        return rerank_topk(qn, self._buf, cand, k)

    def search(self, queries, k: int, pool: Optional[int] = None, row_mask=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact-over-pool top-k: (D [q, k] float32 descending, I [q, k]
        int64) numpy arrays; missing slots (-inf, -1). ``row_mask``
        (length ``size`` or ``capacity``) applies inside stage 1, so the
        pool holds allowed rows only."""
        vals, idx = self.search_device(queries, k, pool, row_mask)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def remove_ids(self, ids) -> int:
        raise _not_ported("remove_ids", 6)

    def merge_from(self, other, batch: int = 65536) -> int:
        raise _not_ported("merge_from", 6)

    def snapshot(self) -> dict:
        raise _not_ported("snapshots", 6)

    def save(self, path: str) -> None:
        raise _not_ported("snapshots", 6)

    @classmethod
    def load(cls, path: str, capacity: Optional[int] = None, **kw) -> "TwoStageIndex":
        raise _not_ported("snapshots", 6)
