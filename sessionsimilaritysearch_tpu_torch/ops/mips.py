"""Fused score scan with bucket max, and the exact top-k built on it.

Port of the TPU kernel K1 (``sessionsimilaritysearch_tpu/ops/pallas_mips.py``
:144 ``_scores_bmax_kernel`` -> :177 ``scores_with_bucket_max`` -> :377
``pallas_exact_topk`` with the selection :408 ``_select_exact_from_scores``).
The kernel is ``csrc/scores_bmax.cu``; :func:`scores_with_bucket_max_ref` is
its plain PyTorch version. Buckets are 128 contiguous corpus rows, the layout
of the JAX ``DenseIndex`` (``ops/topk.py:130``); the TPU kernel's strided
layout was a Mosaic store constraint that a GPU does not have.

:func:`scores_with_bucket_max` takes the plain version for CPU tensors only.
For a CUDA tensor it launches the kernel or raises: no path falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sessionsimilaritysearch_tpu_torch.ops import _build

BUCKET = 128
_DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches made by scores_with_bucket_max, counted where the kernel
# is launched and nowhere else (CPU tensors never count). A run resets it to
# 0 and reads it back to show that the main path went through the kernel.
launch_count = 0


def _check(queries, corpus, valid_count, penalty, score_dtype) -> int:
    if queries.dim() != 2 or corpus.dim() != 2:
        raise ValueError(
            f"queries and corpus must be 2-D, got {tuple(queries.shape)} and "
            f"{tuple(corpus.shape)}"
        )
    if queries.shape[1] != corpus.shape[1]:
        raise ValueError(
            f"depth mismatch: queries d={queries.shape[1]}, corpus "
            f"d={corpus.shape[1]}"
        )
    if queries.dtype not in _DTYPES or corpus.dtype != queries.dtype:
        raise TypeError(
            "queries and corpus must share one dtype of float32/bfloat16, "
            f"got {queries.dtype} and {corpus.dtype}"
        )
    if score_dtype not in _DTYPES:
        raise TypeError(f"score_dtype must be float32 or bfloat16, got {score_dtype}")
    if queries.device != corpus.device:
        raise ValueError(f"queries on {queries.device}, corpus on {corpus.device}")
    if not (queries.is_contiguous() and corpus.is_contiguous()):
        raise ValueError("queries and corpus must be contiguous")
    n = corpus.shape[0]
    vc = n if valid_count is None else int(valid_count)
    if not 0 <= vc <= n:
        raise ValueError(f"valid_count {vc} outside [0, {n}]")
    if penalty is not None:
        if (penalty.dtype != torch.float32 or penalty.shape != (n,)
                or penalty.device != corpus.device
                or not penalty.is_contiguous()):
            raise ValueError(
                f"penalty must be a contiguous float32 [{n}] tensor on "
                f"{corpus.device}, got {penalty.dtype} {tuple(penalty.shape)} "
                f"on {penalty.device}"
            )
    return vc


def scores_with_bucket_max_ref(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid_count: Optional[int] = None,
    penalty: Optional[torch.Tensor] = None,
    score_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (scores [q, n] ``score_dtype``,
    bmax [q, ceil(n/128)] f32). Scores are an f32 matmul; rows at or past
    ``valid_count`` score -inf, then ``penalty`` [n] is added; bmax is the
    max of each 128 contiguous f32 scores, taken before rounding."""
    vc = _check(queries, corpus, valid_count, penalty, score_dtype)
    q, n = queries.shape[0], corpus.shape[0]
    s = queries.float() @ corpus.float().T
    s[:, vc:] = float("-inf")
    if penalty is not None:
        s += penalty
    nb = -(-n // BUCKET)
    padded = s
    if nb * BUCKET != n:
        padded = torch.nn.functional.pad(s, (0, nb * BUCKET - n), value=float("-inf"))
    bmax = padded.view(q, nb, BUCKET).amax(dim=-1)
    return s.to(score_dtype), bmax


def scores_with_bucket_max(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid_count: Optional[int] = None,
    penalty: Optional[torch.Tensor] = None,
    score_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel (``csrc/scores_bmax.cu``) for CUDA tensors; its
    plain version for CPU tensors. Same contract as
    :func:`scores_with_bucket_max_ref`."""
    global launch_count
    vc = _check(queries, corpus, valid_count, penalty, score_dtype)
    dev = queries.device
    if dev.type == "cpu":
        return scores_with_bucket_max_ref(
            queries, corpus, vc, penalty, score_dtype
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    q, d = queries.shape
    n = corpus.shape[0]
    if max(q, n, d) >= 2**31:
        raise ValueError(f"shape too large for int32 indexing: q={q} n={n} d={d}")
    lib = _build.load_library()
    nb = -(-n // BUCKET)
    scores = torch.empty((q, n), dtype=score_dtype, device=dev)
    bmax = torch.empty((q, nb), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sss_scores_bmax(
            queries.data_ptr(), corpus.data_ptr(),
            None if penalty is None else penalty.data_ptr(),
            scores.data_ptr(), bmax.data_ptr(),
            q, n, d, vc,
            int(queries.dtype == torch.bfloat16),
            int(score_dtype == torch.bfloat16),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"scores_bmax kernel launch failed: CUDA error {err} "
            f"(q={q} n={n} d={d} {queries.dtype} -> {score_dtype})"
        )
    launch_count += 1
    return scores, bmax


def select_topk(
    scores: torch.Tensor, bmax: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k from the kernel's outputs (the selection was XLA on the
    TPU, :408). Top-k buckets by bmax, gather their [q, k, 128] scores,
    exact top-k, map to column ids. Missing slots are (-inf, -1). When
    ``k`` exceeds the bucket count the selection ranks all scores."""
    q, n = scores.shape
    nb = bmax.shape[1]
    if k <= nb:
        _, b_idx = torch.topk(bmax, k, dim=1)                       # [q, k]
        cols = (b_idx[..., None] * BUCKET
                + torch.arange(BUCKET, device=scores.device)).view(q, k * BUCKET)
        cand = torch.gather(scores, 1, cols.clamp(max=n - 1)).float()
        cand = cand.masked_fill(cols >= n, float("-inf"))            # ragged tail
        vals, pos = torch.topk(cand, k, dim=1)
        idx = torch.gather(cols, 1, pos)
    else:
        kk = min(k, n)
        vals, idx = torch.topk(scores.float(), kk, dim=1)
        if kk < k:
            vals = torch.nn.functional.pad(vals, (0, k - kk), value=float("-inf"))
            idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    idx = torch.where(torch.isfinite(vals), idx, torch.full_like(idx, -1))
    return vals, idx


def exact_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    valid_count: Optional[int] = None,
    penalty: Optional[torch.Tensor] = None,
    score_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact inner-product top-k: one fused kernel pass, then
    :func:`select_topk`. Returns (values [q, k] f32 descending, ids [q, k]
    int64); missing slots are (-inf, -1). Ties may resolve to a different
    equal-score row than the JAX reference."""
    scores, bmax = scores_with_bucket_max(
        queries, corpus, valid_count, penalty, score_dtype
    )
    return select_topk(scores, bmax, k)
