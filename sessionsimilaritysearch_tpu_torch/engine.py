"""SessionSearchEngine: the serving facade on one GPU (counterpart of
``sessionsimilaritysearch_tpu/engine.py:151``).

Encode sessions with the encoder, keep the embedding corpus on the device
(a flat ``DenseIndex``, or a ``TwoStageIndex`` with a packed binary
prefilter), stream-insert new sessions, answer top-k
queries (optionally deduplicated and filtered by a session predicate), and
report timing counters. The per-row metadata helpers (``_session_key``,
``_GrowArr``, ``_dedup_topk``, ``_where_mask``) are copied
from the JAX engine, where they are plain Python/numpy in a module that
imports JAX.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.config import Config
from sessionsimilaritysearch_tpu_torch.evalharness import metrics as metrics_mod
from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.evalharness.harness import EmbeddingPipeline
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
from sessionsimilaritysearch_tpu_torch.index.twostage import TwoStageIndex
from sessionsimilaritysearch_tpu_torch.utils.profiling import PhaseTimer


def _session_key(sess) -> tuple:
    """Hashable content digest of a session: (type, asin, text) per action —
    exactly the fields the graph transform reads, so two sessions with equal
    keys embed identically."""
    return tuple(
        (a[1], 0, a[2]) if a[1] == "s" else (a[1], int(a[-1]), a[-2])
        for a in sess
    )


class _GrowArr:
    """Append-only numpy array with amortized-doubling growth; ``view()``
    is an O(1) snapshot of the filled prefix, so a query reads the per-row
    metadata without converting a Python list."""

    __slots__ = ("_a", "_n")

    def __init__(self, dtype):
        self._a = np.empty(1024, dtype=dtype)
        self._n = 0

    def view(self) -> np.ndarray:
        return self._a[: self._n]

    def append(self, v) -> None:
        if self._n == len(self._a):
            new = np.empty(2 * len(self._a), dtype=self._a.dtype)
            new[: self._n] = self._a
            self._a = new
        self._a[self._n] = v
        self._n += 1


class SessionSearchEngine:
    """Encode-then-exact-search session similarity serving on one device.

    Args:
      cfg: config (graph dims, ignore_query, retrieval defaults).
      tokenizer: host tokenizer.
      encode_fn: ``SessionGraph`` of tensors -> [B, d] embeddings, e.g. the
        port's ``GraphLevelEncoder``; it is called under
        ``torch.inference_mode``.
      dim: embedding dimension.
      capacity: max corpus size.
      device: where the encoder runs and the corpus lives ('cpu' or a CUDA
        device); required, with no fallback.
      metric: 'cos' or 'ip'.
      batch_size: encoder batch (the last batch is wrap-padded).
      prefilter: None (a flat ``DenseIndex``) or 'binary' / 'itq' -- two-stage
        serving (``index.twostage.TwoStageIndex``): an exact Hamming top-
        ``pool`` over packed sign codes, then an exact re-rank of the pool
        at full width. Needs ``stage1='packed'``; 'matmul', 'int8x8' and
        'pca' are not ported (ROADMAP.md Queue 1 item 2).
      pool: stage-1 candidates per query (two-stage mode).
      projector: fitted ITQ projector for ``prefilter='itq'``
        (``ops.projection.fit_itq``, or the JAX package's as it is).
      stage1: two-stage code scan; only 'packed' is ported.
      dtype: corpus storage dtype; None keeps each index's default (float32
        dense, bfloat16 for the two-stage full-width rows).
      quantize: None, 'int8' or 'int8x8' -- int8-code corpus storage in the
        flat ``DenseIndex`` (a quarter of the f32 corpus memory); 'int8x8'
        also quantizes the queries and scans through the int8 kernel K2.
        Not combined with a prefilter, which stores its own codes.
    The JAX engine's mesh and center options are not ported yet, and
    neither are hybrid fusion, async ingest, removal, expiry, range search
    or save/restore (ROADMAP.md Queue 1 item 5).
    """

    def __init__(
        self,
        cfg: Config,
        tokenizer,
        encode_fn: Callable,
        dim: int,
        capacity: int,
        *,
        device,
        metric: str = "cos",
        batch_size: int = 256,
        prefilter: Optional[str] = None,
        pool: int = 512,
        projector=None,
        stage1: str = "matmul",
        dtype: Optional[torch.dtype] = None,
        quantize: Optional[str] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.timer = PhaseTimer(self.device)
        self.sessions: List = []  # retained for metric reports and where=
        self._pipe = EmbeddingPipeline(
            cfg, tokenizer, encode_fn, device=self.device, batch_size=batch_size
        )
        # canonical content id per inserted session, for query-time dedup
        self._key_to_id: dict = {}
        self._canon_ids = _GrowArr(np.int64)
        if prefilter is None:
            self.index = DenseIndex(
                dim=dim, capacity=capacity, device=self.device, metric=metric,
                quantize=quantize, **({} if dtype is None else {"dtype": dtype}),
            )
        elif quantize is not None:
            raise ValueError("two-stage mode stores its own code buffers; drop quantize")
        else:
            self.index = TwoStageIndex(
                dim=dim, capacity=capacity, device=self.device, metric=metric,
                prefilter=prefilter, pool=pool, projector=projector,
                stage1=stage1,
                **({} if dtype is None else {"store_dtype": dtype}),
            )

    # ------------------------------------------------------------------
    def embed(self, data: Sequence, out: str = "np"):
        """Embed raw sessions / (prefix, future) pairs. ``out='device'``
        keeps the embeddings on the device (the ingest and query paths)."""
        with self.timer("encode"):
            return self._pipe(data, out=out)

    def add_sessions(self, data: Sequence) -> None:
        """Encode + stream-insert sessions into the corpus."""
        if len(data) == 0:
            return
        emb = self.embed(data, out="device")
        with self.timer("insert"):
            self.index.add(emb)
        for d in data:
            sess = d[0] if isinstance(d, tuple) and len(d) == 2 else d
            self.sessions.append(sess)
            self._canon_ids.append(self._key_to_id.setdefault(
                _session_key(sess), len(self._key_to_id)
            ))

    # ------------------------------------------------------------------
    def search(self, data: Sequence, k: Optional[int] = None,
               dedup: bool = False, where: Optional[Callable] = None):
        """Full query path: sessions -> embed -> exact top-k. Returns (D, I)
        numpy arrays. ``dedup=True`` drops hits whose stored session
        duplicates a better-ranked hit's and backfills from deeper ranks.
        ``where``: optional predicate ``session -> bool``; only stored
        sessions it accepts can rank."""
        emb = self.embed(data, out="device")
        t0 = time.perf_counter()
        D, I = self.search_embeddings(emb, k, dedup=dedup, where=where)
        self.timer.totals["search"] += time.perf_counter() - t0
        self.timer.counts["search"] += 1
        return D, I

    def search_embeddings(self, emb, k: Optional[int] = None,
                          dedup: bool = False,
                          where: Optional[Callable] = None):
        k = k or self.cfg.retrieval_k
        mask = None if where is None else self._where_mask(where)
        if not dedup:
            return self.index.search(emb, k, row_mask=mask)
        # over-fetch so dropped duplicates can be backfilled
        k2 = min(max(2 * k, k + 8), max(self.index.ntotal, 1))
        D2, I2 = self.index.search(emb, k2, row_mask=mask)
        return self._dedup_topk(D2, I2, k)

    def _where_mask(self, where: Callable) -> np.ndarray:
        """Evaluate a session predicate into the index's positional row
        mask."""
        return np.fromiter(
            (bool(where(s)) for s in self.sessions),
            dtype=bool, count=len(self.sessions),
        )

    def _dedup_topk(self, D2, I2, k: int):
        """Drop candidates whose session duplicates a better-ranked hit
        (same canonical key), backfilling from deeper ranks."""
        D2 = np.asarray(D2)
        gid = np.asarray(I2, dtype=np.int64)
        q, m = gid.shape
        canon = self._canon_ids.view()
        n_meta = len(canon)
        valid = gid >= 0
        g = np.where(valid, gid, 0)
        key = np.where(
            g < n_meta,
            canon[np.minimum(g, max(n_meta - 1, 0))] if n_meta else g,
            g + (np.int64(1) << 40),
        )
        # group by (row, key), keep each group's best-ranked column, then
        # restore rank order and take the first k per row
        rowsf = np.repeat(np.arange(q), m)
        colsf = np.tile(np.arange(m), q)
        order = np.lexsort((colsf, key.ravel(), rowsf))
        rs, ks = rowsf[order], key.ravel()[order]
        first = np.ones(q * m, dtype=bool)
        first[1:] = (rs[1:] != rs[:-1]) | (ks[1:] != ks[:-1])
        keep = first & valid.ravel()[order]
        kr, kc = rs[keep], colsf[order][keep]
        o2 = np.lexsort((kc, kr))
        kr, kc = kr[o2], kc[o2]
        pos = np.arange(len(kr)) - np.searchsorted(kr, np.arange(q))[kr]
        sel = pos < k
        kr, kc, pos = kr[sel], kc[sel], pos[sel]
        D = np.full((q, k), -np.inf, dtype=D2.dtype)
        I = np.full((q, k), -1, dtype=np.asarray(I2).dtype)
        D[kr, pos] = D2[kr, kc]
        I[kr, pos] = gid[kr, kc]
        return D, I

    # ------------------------------------------------------------------
    def report(self, test_data: Sequence, I, D=None) -> dict:
        """Ground-truth quality report for retrieved results."""
        return metrics_mod.full_report(D, I, list(test_data), self.sessions)

    def reconstruct(self, ids) -> np.ndarray:
        """Stored embedding rows for result ids, [m, d] float32."""
        return self.index.reconstruct_batch(ids)

    def stats(self) -> dict:
        s = self.timer.summary()
        s["ntotal"] = self.index.ntotal
        return s
