"""Edit-distance similarity primitives.

The reference uses the C `python-Levenshtein` extension for ground-truth
label generation (reference: util_amazon_filtered.py:246 ``Levenshtein.ratio``,
fine_tune_ours.py:61-65 ``Levenshtein.seqratio``). Labels are computed on the
host, offline -- not on-TPU -- so the TPU-native design keeps them native-CPU:
a small C++ library (native/levenshtein.cpp, loaded via ctypes) with this
pure-Python fallback for portability.

Semantics match python-Levenshtein:
- ``ratio(a, b) = (|a|+|b| - D2(a, b)) / (|a|+|b|)`` where D2 is edit distance
  with substitution cost 2 (indel distance);
- ``seqratio`` applies the same formula at the string-list level with element
  substitution cost ``2 * (1 - ratio(x, y))``.
"""

from __future__ import annotations

from typing import List, Sequence

from sessionsimilaritysearch_tpu_torch import native as _native_mod


def _indel_distance(a: Sequence, b: Sequence) -> int:
    """Edit distance with substitution cost 2 (= deletions + insertions)."""
    # D2 = |a| + |b| - 2 * LCS(a, b)
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return la + lb
    prev = [0] * (lb + 1)
    for i in range(1, la + 1):
        cur = [0] * (lb + 1)
        ai = a[i - 1]
        for j in range(1, lb + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = cur[j - 1] if cur[j - 1] >= prev[j] else prev[j]
        prev = cur
    lcs = prev[lb]
    return la + lb - 2 * lcs


def ratio(a: str, b: str) -> float:
    lensum = len(a) + len(b)
    if lensum == 0:
        return 1.0
    r = _native_mod.ratio(a, b)
    if r is not None:
        return r
    return (lensum - _indel_distance(a, b)) / lensum


def seqratio(a: List[str], b: List[str]) -> float:
    """Similarity of two string sequences (python-Levenshtein ``seqratio``)."""
    lensum = len(a) + len(b)
    if lensum == 0:
        return 1.0
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return 0.0
    r = _native_mod.seqratio(list(a), list(b))
    if r is not None:
        return r
    # generalized edit distance: del/ins cost 1, sub cost 2*(1 - ratio)
    prev = [float(j) for j in range(lb + 1)]
    for i in range(1, la + 1):
        cur = [float(i)] + [0.0] * lb
        for j in range(1, lb + 1):
            sub = prev[j - 1] + 2.0 * (1.0 - ratio(a[i - 1], b[j - 1]))
            cur[j] = min(prev[j] + 1.0, cur[j - 1] + 1.0, sub)
        prev = cur
    return (lensum - prev[lb]) / lensum


def distance(a: str, b: str) -> int:
    """Plain Levenshtein distance (substitution cost 1)."""
    la, lb = len(a), len(b)
    if la == 0:
        return lb
    if lb == 0:
        return la
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        ai = a[i - 1]
        for j in range(1, lb + 1):
            cost = 0 if ai == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[lb]


def get_string_match(a: List[str], b: List[str]):
    """Fuzzy set match count with ratio > 0.9
    (reference: util_amazon_filtered.py:239-249)."""
    m = _native_mod.string_match(list(a), list(b))
    if m is not None:
        return m
    a_match = [0] * len(a)
    b_match = [0] * len(b)
    for i, a_s in enumerate(a):
        for j, b_s in enumerate(b):
            if ratio(a_s, b_s) > 0.9:
                a_match[i] = 1
                b_match[j] = 1
    return sum(a_match), sum(b_match)
