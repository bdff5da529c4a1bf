"""The float dense scans: fused score scan with bucket max and the exact
top-k built on it (K1), the bucket-max-only scan and its re-ranking top-k
(K3), and the plain score matmul (K6).

Ports of the TPU kernels of ``sessionsimilaritysearch_tpu/ops/pallas_mips.py``:

- K1: :144 ``_scores_bmax_kernel`` -> :177 ``scores_with_bucket_max`` -> :377
  ``pallas_exact_topk`` with the selection :408 ``_select_exact_from_scores``;
  kernels chosen by :func:`k1_variant`: for rows TMA can describe (16-byte
  row stride, 16-byte-aligned bases) the TMA-fed, persistent ``wgmma``
  kernels, ``csrc/scores_bmax_sm90.cu`` for bf16 (d % 8 == 0) and
  ``csrc/scores_bmax_f32_sm90.cu`` for f32 (d % 4 == 0: the 3xTF32 split,
  f32-accurate on the tensor cores); for other bf16 rows of even d at
  4-byte-aligned bases (the 250-bit sign and ITQ codes) the same bf16
  kernel fed by ``cp.async`` (``csrc/sm90_cp_async.cuh``); for the rest
  ``csrc/scores_bmax.cu`` (the ``score_tile.cuh`` loop: WMMA for bf16, an
  exact FMA loop for f32); plain version :func:`scores_with_bucket_max_ref`.
- K3: :56 ``_bucket_max_kernel`` -> :88 ``scores_bucket_max`` -> :322
  ``pallas_bucketed_topk``; kernel ``csrc/bucket_max.cu``, plain version
  :func:`scores_bucket_max_ref`, top-k :func:`bucketed_topk`.
- K6: :247 ``_scores_kernel`` -> :259 ``scores_matmul``; kernels chosen by
  :func:`k6_variant`: K1's Hopper kernels with a store-only epilogue
  (``sss_scores_matmul_sm90`` and ``sss_scores_matmul_cp_sm90`` for bf16,
  ``sss_scores_matmul_f32_sm90`` for f32) on the rows K1's would take, and
  ``csrc/scores_matmul.cu`` (the tile loop) on the others; plain version
  :func:`scores_matmul_ref`.

Buckets are 128 contiguous corpus rows, the layout of the JAX
``DenseIndex`` (``ops/topk.py:130``); the TPU kernels' strided layout was a
Mosaic store constraint that a GPU does not have.

Each wrapper takes its plain version for CPU tensors only. For a CUDA
tensor it launches its kernel or raises: no path falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sessionsimilaritysearch_tpu_torch.ops import _build

BUCKET = 128
_DTYPES = (torch.float32, torch.bfloat16)
# elements in TMA's 16-byte unit of row stride, per operand dtype
_TMA_ELEMS = {torch.bfloat16: 8, torch.float32: 4}

# Kernel launches made by each wrapper (K1 scores_with_bucket_max, K3
# scores_bucket_max, K6 scores_matmul), counted where the kernel is launched
# and nowhere else (CPU tensors never count). A run resets them to 0 and
# reads them back to show that its path went through the kernels.
# launch_count counts every K1 launch, wgmma_launch_count those of its
# TMA-fed Hopper variants (csrc/scores_bmax_sm90.cu for bf16,
# csrc/scores_bmax_f32_sm90.cu for f32) alone, cp_async_launch_count those
# of the cp.async-fed bf16 variant; likewise scores_matmul_launch_count,
# scores_matmul_wgmma_launch_count and scores_matmul_cp_async_launch_count
# for K6.
launch_count = 0
wgmma_launch_count = 0
cp_async_launch_count = 0
bucket_max_launch_count = 0
scores_matmul_launch_count = 0
scores_matmul_wgmma_launch_count = 0
scores_matmul_cp_async_launch_count = 0

# gathered corpus rows (and their f32 copy) per query tile of bucketed_topk
GATHER_BYTES = 1 << 30


def _check(queries, corpus, valid_count, penalty, score_dtype,
           dtypes=_DTYPES) -> int:
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
    if queries.dtype not in dtypes or corpus.dtype != queries.dtype:
        raise TypeError(
            f"queries and corpus must share one dtype of {dtypes}, "
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


def _cuda_call(fn, name: str, dev: torch.device, *args) -> None:
    """Launch ``fn(*args, stream)`` on ``dev``'s current stream; raise on a
    refused launch (a negative code is the CUresult of a failed TMA
    tensor-map encode)."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err < 0:
        raise RuntimeError(
            f"{name}: cuTensorMapEncodeTiled failed with CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _kernel_device(queries, corpus) -> Optional[torch.device]:
    """None for CPU tensors (the caller takes the plain version), the CUDA
    device otherwise; raises for any other device or an int32 overflow."""
    dev = queries.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    q, d = queries.shape
    n = corpus.shape[0]
    if max(q, n, d) >= 2**31:
        raise ValueError(f"shape too large for int32 indexing: q={q} n={n} d={d}")
    return dev


def k1_variant(device_type: str, dtype: torch.dtype, d: int,
               data_ptrs: Tuple[int, ...]) -> str:
    """Which K1 kernel a call runs: 'plain' for CPU tensors; on CUDA
    'wgmma' for operands that TMA can describe -- row stride a multiple of
    16 bytes (bf16: d % 8 == 0, ``csrc/scores_bmax_sm90.cu``; f32:
    d % 4 == 0, ``csrc/scores_bmax_f32_sm90.cu``, the 3xTF32 split) and
    every base pointer 16-byte aligned; 'cp_async' for other bf16 rows of
    even d whose base pointers are 4-byte aligned (the 250-bit sign and ITQ
    codes: a 500-byte stride) -- the bf16 kernel of
    ``csrc/scores_bmax_sm90.cu`` with the ``cp.async`` producer of
    ``csrc/sm90_cp_async.cuh``; else 'tile' (``csrc/scores_bmax.cu``: odd-d
    or 2-byte-aligned bf16 rows, and f32 rows TMA cannot take, for which it
    is an exact FMA loop without TF32). A dispatch, not a fallback: the
    chosen kernel launches or raises."""
    if device_type == "cpu":
        return "plain"
    per_16_bytes = _TMA_ELEMS.get(dtype)
    if (per_16_bytes and d > 0 and d % per_16_bytes == 0
            and all(p % 16 == 0 for p in data_ptrs)):
        return "wgmma"
    if (dtype == torch.bfloat16 and d > 0 and d % 2 == 0
            and all(p % 4 == 0 for p in data_ptrs)):
        return "cp_async"
    return "tile"


# K6 runs K1's Hopper kernels (store-only epilogue; TMA- or cp.async-fed)
# on the operands K1's would take, and the tile loop of
# csrc/scores_matmul.cu on the others
k6_variant = k1_variant


def bucket_max(scores: torch.Tensor) -> torch.Tensor:
    """[q, n] f32 scores -> [q, ceil(n/128)] max of each 128 contiguous
    columns (a ragged last bucket is padded with -inf)."""
    q, n = scores.shape
    nb = -(-n // BUCKET)
    if nb * BUCKET != n:
        scores = torch.nn.functional.pad(scores, (0, nb * BUCKET - n),
                                         value=float("-inf"))
    return scores.view(q, nb, BUCKET).amax(dim=-1)


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
    s = queries.float() @ corpus.float().T
    s[:, vc:] = float("-inf")
    if penalty is not None:
        s += penalty
    return s.to(score_dtype), bucket_max(s)


def scores_with_bucket_max(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid_count: Optional[int] = None,
    penalty: Optional[torch.Tensor] = None,
    score_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 for CUDA tensors -- the kernel :func:`k1_variant` names; its plain
    version for CPU tensors. Same contract as
    :func:`scores_with_bucket_max_ref`."""
    global launch_count, wgmma_launch_count, cp_async_launch_count
    vc = _check(queries, corpus, valid_count, penalty, score_dtype)
    dev = _kernel_device(queries, corpus)
    if dev is None:
        return scores_with_bucket_max_ref(
            queries, corpus, vc, penalty, score_dtype
        )
    q, d = queries.shape
    n = corpus.shape[0]
    scores = torch.empty((q, n), dtype=score_dtype, device=dev)
    bmax = torch.empty((q, -(-n // BUCKET)), dtype=torch.float32, device=dev)
    pen = None if penalty is None else penalty.data_ptr()
    out_bf16 = int(score_dtype == torch.bfloat16)
    lib = _build.load_library()
    variant = k1_variant(dev.type, queries.dtype, d,
                         (queries.data_ptr(), corpus.data_ptr()))
    if variant in ("wgmma", "cp_async"):
        name = ("scores_bmax_cp_sm90" if variant == "cp_async"
                else "scores_bmax_sm90" if queries.dtype == torch.bfloat16
                else "scores_bmax_f32_sm90")
        _cuda_call(getattr(lib, "sss_" + name), name, dev,
                   queries.data_ptr(), corpus.data_ptr(), pen, scores.data_ptr(),
                   bmax.data_ptr(), q, n, d, vc, out_bf16)
        if variant == "wgmma":
            wgmma_launch_count += 1
        else:
            cp_async_launch_count += 1
    else:
        _cuda_call(lib.sss_scores_bmax, "scores_bmax", dev,
                   queries.data_ptr(), corpus.data_ptr(), pen, scores.data_ptr(),
                   bmax.data_ptr(), q, n, d, vc,
                   int(queries.dtype == torch.bfloat16), out_bf16)
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
        vals, idx = torch.topk(scores.float(), min(k, n), dim=1)
    return _missing_slots(vals, idx, k)


def _missing_slots(vals, idx, k: int):
    """Pad a [q, <= k] top-k to k columns and mark every slot whose value
    is -inf as (-inf, -1)."""
    if vals.shape[1] < k:
        vals = torch.nn.functional.pad(vals, (0, k - vals.shape[1]),
                                       value=float("-inf"))
        idx = torch.nn.functional.pad(idx, (0, k - idx.shape[1]), value=-1)
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


def scores_bucket_max_ref(
    queries: torch.Tensor, corpus: torch.Tensor, valid_count: Optional[int] = None
) -> torch.Tensor:
    """Plain PyTorch version of K3: bucket maxes [q, ceil(n/128)] f32 of an
    f32 matmul where rows at or past ``valid_count`` score -inf."""
    vc = _check(queries, corpus, valid_count, None, torch.float32)
    s = queries.float() @ corpus.float().T
    s[:, vc:] = float("-inf")
    return bucket_max(s)


def scores_bucket_max(
    queries: torch.Tensor, corpus: torch.Tensor, valid_count: Optional[int] = None
) -> torch.Tensor:
    """K3 (``csrc/bucket_max.cu``) for CUDA tensors; its plain version for
    CPU tensors. Returns the bucket maxes only: the score matrix never
    reaches device memory."""
    global bucket_max_launch_count
    vc = _check(queries, corpus, valid_count, None, torch.float32)
    dev = _kernel_device(queries, corpus)
    if dev is None:
        return scores_bucket_max_ref(queries, corpus, vc)
    q, d = queries.shape
    n = corpus.shape[0]
    bmax = torch.empty((q, -(-n // BUCKET)), dtype=torch.float32, device=dev)
    _cuda_call(
        _build.load_library().sss_bucket_max, "bucket_max", dev,
        queries.data_ptr(), corpus.data_ptr(), bmax.data_ptr(), q, n, d, vc,
        int(queries.dtype == torch.bfloat16),
    )
    bucket_max_launch_count += 1
    return bmax


def bucketed_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    valid_count: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact inner-product top-k with no score matrix in device memory
    (counterpart of ``pallas_bucketed_topk`` :322): K3's bucket maxes pick
    the top-k buckets, then the dots of their k * 128 corpus rows are
    recomputed and ranked: products of the stored values summed in f32,
    over query tiles whose gathered rows (and their f32 copy) stay within
    ``GATHER_BYTES``. Returns (values [q, k] f32
    descending, ids [q, k] int64); rows at or past ``valid_count`` and
    missing slots are (-inf, -1). Floating corpora only."""
    vc = _check(queries, corpus, valid_count, None, torch.float32)
    bmax = scores_bucket_max(queries, corpus, vc)
    q, d = queries.shape
    n = corpus.shape[0]
    kb = min(k, bmax.shape[1])
    _, b_idx = torch.topk(bmax, kb, dim=1)                          # [q, kb]
    cols = (b_idx[..., None] * BUCKET
            + torch.arange(BUCKET, device=corpus.device)).view(q, kb * BUCKET)
    qf = queries.float()
    per_query = kb * BUCKET * d * (corpus.element_size() + 4)
    tile = max(1, GATHER_BYTES // max(per_query, 1))
    cand = torch.empty((q, kb * BUCKET), dtype=torch.float32, device=corpus.device)
    for t0 in range(0, q, tile):
        rows = corpus[cols[t0: t0 + tile].clamp(max=n - 1)].float()  # [t, kb*128, d]
        cand[t0: t0 + tile] = torch.bmm(rows, qf[t0: t0 + tile, :, None])[..., 0]
    cand = cand.masked_fill(cols >= vc, float("-inf"))
    vals, pos = torch.topk(cand, min(k, kb * BUCKET), dim=1)
    return _missing_slots(vals, torch.gather(cols, 1, pos), k)


def scores_matmul_ref(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6: [q, n] f32 = queries @ corpus.T."""
    _check(queries, corpus, None, None, torch.float32)
    return queries.float() @ corpus.float().T


def scores_matmul(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """K6 for CUDA tensors -- the kernel :func:`k6_variant` names; its plain
    version for CPU tensors. [q, n] f32 scores from f32 or bf16 operands,
    summed in f32."""
    global scores_matmul_launch_count, scores_matmul_wgmma_launch_count
    global scores_matmul_cp_async_launch_count
    _check(queries, corpus, None, None, torch.float32)
    dev = _kernel_device(queries, corpus)
    if dev is None:
        return scores_matmul_ref(queries, corpus)
    q, d = queries.shape
    n = corpus.shape[0]
    scores = torch.empty((q, n), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    variant = k6_variant(dev.type, queries.dtype, d,
                         (queries.data_ptr(), corpus.data_ptr()))
    if variant in ("wgmma", "cp_async"):
        name = ("scores_matmul_cp_sm90" if variant == "cp_async"
                else "scores_matmul_sm90" if queries.dtype == torch.bfloat16
                else "scores_matmul_f32_sm90")
        _cuda_call(getattr(lib, "sss_" + name), name, dev,
                   queries.data_ptr(), corpus.data_ptr(), scores.data_ptr(), q, n, d)
        if variant == "wgmma":
            scores_matmul_wgmma_launch_count += 1
        else:
            scores_matmul_cp_async_launch_count += 1
    else:
        _cuda_call(lib.sss_scores_matmul, "scores_matmul", dev,
                   queries.data_ptr(), corpus.data_ptr(), scores.data_ptr(), q, n, d,
                   int(queries.dtype == torch.bfloat16))
    scores_matmul_launch_count += 1
    return scores
