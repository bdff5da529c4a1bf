"""How ``correct`` is decided: the answers that the timed path produced for
a seed-drawn sample of the window's sessions, against the plain reference
(``reference/``), number by number, each against the limit that the
configuration's file states (``judge.limits``):

- ``bad_ids``: answers that name no row (id < 0 or >= rows) or repeat a
  row within one session's answer (limit 0);
- ``score_err``: the largest gap between the score the program reported
  for an answer and the reference's cosine of the same query session and
  row;
- ``miss``: the mean share of the reference's answer (its k rows, by the
  configuration's semantics) that the program's answer lacks;
- ``pool_gap`` (two-stage): the mean over sessions of the largest Hamming
  distance, in bits, by which one of its answered rows lies beyond the
  reference's pool. A bit of a query's code that flips between the
  program's arithmetic and the reference's moves every distance by one, so
  the gap of one session is twice its flipped bits at most; the widest gap
  over a thousand sessions swings with the one that flips most, the mean
  does not.
"""

from __future__ import annotations

import numpy as np


def numbers(D: np.ndarray, I: np.ndarray, ref: dict, n_rows: int) -> dict:
    """The compared numbers of answers ``(D, I)`` [S, k] given the
    reference's ``scan(..., probe=I)`` result (numpy arrays)."""
    D = np.asarray(D, np.float64)
    I = np.asarray(I, np.int64)
    S, k = I.shape
    valid = (I >= 0) & (I < n_rows) & np.isfinite(D)
    srt = np.sort(np.where(valid, I, -1 - np.arange(k)[None, :]), axis=1)
    dup = int((srt[:, 1:] == srt[:, :-1]).sum())
    out = {"bad_ids": float(int((~valid).sum()) + dup)}
    err = np.abs(D - np.asarray(ref["probe_score"], np.float64))
    out["score_err"] = float(np.max(np.where(valid, err, 0.0))) if valid.any() else float("inf")
    ref_ids = np.asarray(ref["ids"], np.int64)
    hits = sum(len(np.intersect1d(I[i][valid[i]], ref_ids[i])) for i in range(S))
    out["miss"] = 1.0 - hits / float(ref_ids.size)
    if "pool_dist" in ref:
        gap = np.asarray(ref["probe_dist"], np.int64) - np.asarray(ref["pool_dist"])[:, None]
        out["pool_gap"] = float(np.mean(np.max(np.where(valid, np.maximum(gap, 0), 0), axis=1)))
    return out


def verdict(nums: dict, limits: dict) -> bool:
    """Every number within its limit (a number without a limit fails)."""
    return all(name in limits and v <= limits[name] for name, v in nums.items())


def report(nums: dict, limits: dict) -> dict:
    """``{name: {"value": v, "limit": l}}``, the key the result line ends with."""
    return {name: {"value": v, "limit": limits.get(name)} for name, v in nums.items()}
