"""The searches in plain PyTorch, over corpus rows given block by block:

- ``'exact'``: the k rows of largest cosine;
- ``'twostage'``: SimHash codes ``sign(x @ R)`` (``>= 0`` is +1) of the
  unit rows and queries, the ``pool`` rows of least Hamming distance (ties
  to the lower id), then the k of largest cosine among them.

Products run in float32 with TF32 off. ``arith='fp8'`` rounds the unit
rows and queries to float8 e4m3 (a scale per row) first: the control.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from portbench.reference.encoder import no_tf32, round_fp8_rows


def unit(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / x.norm(dim=1, keepdim=True).clamp(min=1e-30)


def _signs(x: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    return torch.where(x @ R >= 0, 1.0, -1.0)


class Scan:
    """One pass over the corpus for a set of queries [S, d]: the
    semantics' own answer, and, for ``probe`` ids [S, k] (another side's
    answer), their cosine and Hamming distance as this side computes
    them."""

    def __init__(self, queries: torch.Tensor, semantics: str, k: int, pool: int = 0,
                 projection: Optional[torch.Tensor] = None, arith: str = "f32",
                 probe: Optional[torch.Tensor] = None):
        if semantics not in ("exact", "twostage"):
            raise ValueError(f"unknown semantics {semantics!r}")
        if semantics == "twostage" and projection is None:
            raise ValueError("the two-stage search needs its SimHash projection")
        self.sem, self.k, self.pool, self.arith = semantics, k, pool, arith
        self.q = self._rows(queries)
        S, dev = self.q.shape[0], self.q.device
        self.R = None if projection is None else projection.to(dev, torch.float32)
        self.n = 0
        self.vals = torch.full((S, 0), float("-inf"), device=dev)
        self.ids = torch.full((S, 0), -1, dtype=torch.int64, device=dev)
        self.keys = torch.zeros((S, 0), dtype=torch.int64, device=dev)
        self.qc = None if self.R is None else _signs(self.q, self.R)
        self.probe = None if probe is None else probe.to(dev, torch.int64)
        self.probe_score = torch.full(self.probe.shape, float("nan"), device=dev) \
            if probe is not None else None
        self.probe_dist = torch.full(self.probe.shape, -1, dtype=torch.int64, device=dev) \
            if probe is not None else None

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        x = unit(x)
        return round_fp8_rows(x) if self.arith == "fp8" else x

    _ID_BITS = 40  # a (distance, id) key: distance << 40 | id

    def add(self, start: int, rows: torch.Tensor) -> None:
        with no_tf32():
            c = self._rows(rows.to(self.q.device))
            s = self.q @ c.T                                    # [S, m]
            dist = None
            if self.R is not None:
                bits = self.R.shape[1]
                dot = self.qc @ _signs(c, self.R).T
                dist = torch.round((bits - dot) * 0.5).to(torch.int64)
        m = c.shape[0]
        cols = torch.arange(start, start + m, device=s.device)
        if self.probe is not None:
            inside = (self.probe >= start) & (self.probe < start + m)
            local = (self.probe - start).clamp(0, m - 1)
            self.probe_score = torch.where(inside, s.gather(1, local), self.probe_score)
            if dist is not None:
                self.probe_dist = torch.where(inside, dist.gather(1, local), self.probe_dist)
        if self.sem == "exact":
            v, p = torch.topk(s, min(self.k, m), dim=1)
            self.vals, order = torch.topk(torch.cat([self.vals, v], 1),
                                          min(self.k, self.vals.shape[1] + v.shape[1]), dim=1)
            self.ids = torch.gather(torch.cat([self.ids, cols[p]], 1), 1, order)
        else:
            key = (dist << self._ID_BITS) | cols[None, :]
            kk = min(self.pool, m)
            bk, p = torch.topk(key, kk, dim=1, largest=False)
            allk = torch.cat([self.keys, bk], 1)
            allv = torch.cat([self.vals, s.gather(1, p)], 1)
            self.keys, order = torch.topk(allk, min(self.pool, allk.shape[1]), dim=1,
                                          largest=False)
            self.vals = torch.gather(allv, 1, order)
        self.n = max(self.n, start + m)

    def result(self) -> dict:
        """``ids`` and ``scores`` [S, k] of the semantics' answer (scores
        descending); for the two-stage, ``pool_dist`` [S], the pool's
        largest Hamming distance; for a probe, ``probe_score`` and
        ``probe_dist`` [S, k] (-1 where the id is not a row)."""
        out = {}
        if self.sem == "exact":
            out["ids"], out["scores"] = self.ids, self.vals
        else:
            mask = (1 << self._ID_BITS) - 1
            pool_ids = self.keys & mask
            out["pool_dist"] = (self.keys >> self._ID_BITS).amax(dim=1)
            # the k of largest cosine; equal cosines to the lower id
            order = torch.argsort(pool_ids, dim=1)
            ids = torch.gather(pool_ids, 1, order)
            vals = torch.gather(self.vals, 1, order)
            top = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, : self.k]
            out["ids"] = torch.gather(ids, 1, top)
            out["scores"] = torch.gather(vals, 1, top)
        if self.probe is not None:
            out["probe_score"] = self.probe_score
            out["probe_dist"] = self.probe_dist
        return out


def scan(queries: torch.Tensor, blocks: Iterable[Tuple[int, torch.Tensor]], **kw) -> dict:
    """A :class:`Scan` over every block."""
    sc = Scan(queries, **kw)
    for start, rows in blocks:
        sc.add(start, rows)
    return sc.result()
