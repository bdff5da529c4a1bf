"""The int8 dense scans: per-row int8 quantization, and the fused int8 x
int8 score scan with bucket max (K2) and the exact top-k on it. (The
bf16 x int8 scan of ``DenseIndex(quantize='int8')`` is torch ops in
``ops/topk.py``.)

K2 ports the TPU kernel ``sessionsimilaritysearch_tpu/ops/pallas_mips.py``
:428 ``_scores_bmax_int8_kernel`` -> :465 ``scores_with_bucket_max_int8`` ->
:552 ``pallas_exact_topk_int8``. Two kernels, chosen by :func:`k2_variant`:
``csrc/scores_bmax_int8_sm90.cu`` (TMA-fed s8 ``wgmma`` on K1's Hopper
pipeline, for rows TMA can describe) and ``csrc/scores_bmax_int8.cu`` (the
tile loop with ``mma.sync``, for the others).
:func:`scores_with_bucket_max_int8_ref` is their plain PyTorch version, and
all three agree bit for bit: the plain version sums the products exactly
in float64 (|dot| <= d * 127^2 < 2^53) and rounds to f32 as the kernels'
int32 -> f32 conversion does. Buckets are 128 contiguous rows and
rows at or past ``valid_count`` or filtered by ``penalty`` score -inf, as in
K1 (``ops/mips.py``), so :func:`mips.select_topk` applies unchanged.

:func:`scores_with_bucket_max_int8` takes the plain version for CPU tensors
only. For a CUDA tensor it launches the chosen kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sessionsimilaritysearch_tpu_torch.ops import _build, mips

# corpus rows per float64 product in the plain version: bounds its operands
_REF_ROWS = 65536

# Kernel launches made by scores_with_bucket_max_int8, counted where the
# kernel is launched and nowhere else (CPU tensors never count):
# launch_count every K2 launch, wgmma_launch_count those of its Hopper
# variant (csrc/scores_bmax_int8_sm90.cu) alone.
launch_count = 0
wgmma_launch_count = 0


def quantize_rows_int8(emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 (JAX ``index/dense.py:140``
    ``_quantize_rows_int8``): scale ``s = max|row| / 127`` (at least 1e-30),
    codes ``clip(round(row / s), -127, 127)``; rounds half to even, as
    ``jnp.round``. The division by 127 is a product with f32(1/127), as XLA
    compiles a division by a constant, so codes and scales equal the JAX
    package's bit for bit. Returns (codes [m, d] int8, scales [m] f32); a
    row dequantizes as ``codes * s``."""
    emb = emb.float()
    s = torch.clamp(emb.abs().amax(dim=1) * (1.0 / 127.0), min=1e-30)
    codes = torch.clamp(torch.round(emb / s[:, None]), -127, 127).to(torch.int8)
    return codes, s


def k2_variant(device_type: str, d: int, data_ptrs: Tuple[int, ...]) -> str:
    """Which K2 kernel a call runs: 'plain' for CPU tensors; on CUDA
    'wgmma' (``csrc/scores_bmax_int8_sm90.cu``) for codes that TMA can
    describe -- row stride a multiple of 16 bytes (d % 16 == 0) and every
    base pointer (query codes, corpus codes, scales) 16-byte aligned -- else
    'tile' (``csrc/scores_bmax_int8.cu``). A dispatch, not a fallback: the
    chosen kernel launches or raises."""
    if device_type == "cpu":
        return "plain"
    if d > 0 and d % 16 == 0 and all(p % 16 == 0 for p in data_ptrs):
        return "wgmma"
    return "tile"


def _check(queries, corpus, corpus_scales, valid_count, penalty, score_dtype) -> int:
    vc = mips._check(queries, corpus, valid_count, penalty, score_dtype,
                     dtypes=(torch.int8,))
    n = corpus.shape[0]
    if (corpus_scales.dtype != torch.float32 or corpus_scales.shape != (n,)
            or corpus_scales.device != corpus.device
            or not corpus_scales.is_contiguous()):
        raise ValueError(
            f"corpus_scales must be a contiguous float32 [{n}] tensor on "
            f"{corpus.device}, got {corpus_scales.dtype} "
            f"{tuple(corpus_scales.shape)} on {corpus_scales.device}"
        )
    return vc


def scores_with_bucket_max_int8_ref(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_scales: torch.Tensor,
    valid_count: Optional[int] = None,
    penalty: Optional[torch.Tensor] = None,
    score_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: (scores [q, n] ``score_dtype``, bmax
    [q, ceil(n/128)] f32). Scores are the exact code dots rounded to f32,
    times ``corpus_scales`` in f32; rows at or past ``valid_count`` score
    -inf, then ``penalty`` [n] is added; bmax is taken before rounding."""
    vc = _check(queries, corpus, corpus_scales, valid_count, penalty, score_dtype)
    q, n = queries.shape[0], corpus.shape[0]
    qd = queries.double()
    s = torch.empty((q, n), dtype=torch.float32, device=queries.device)
    for c0 in range(0, n, _REF_ROWS):
        s[:, c0: c0 + _REF_ROWS] = (qd @ corpus[c0: c0 + _REF_ROWS].double().T).float()
    s *= corpus_scales
    s[:, vc:] = float("-inf")
    if penalty is not None:
        s += penalty
    return s.to(score_dtype), mips.bucket_max(s)


def scores_with_bucket_max_int8(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    corpus_scales: torch.Tensor,
    valid_count: Optional[int] = None,
    penalty: Optional[torch.Tensor] = None,
    score_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 for CUDA tensors -- the kernel :func:`k2_variant` names; its
    plain version for CPU tensors. Same contract as
    :func:`scores_with_bucket_max_int8_ref`."""
    global launch_count, wgmma_launch_count
    vc = _check(queries, corpus, corpus_scales, valid_count, penalty, score_dtype)
    dev = mips._kernel_device(queries, corpus)
    if dev is None:
        return scores_with_bucket_max_int8_ref(
            queries, corpus, corpus_scales, vc, penalty, score_dtype
        )
    q, d = queries.shape
    n = corpus.shape[0]
    scores = torch.empty((q, n), dtype=score_dtype, device=dev)
    bmax = torch.empty((q, -(-n // mips.BUCKET)), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    ptrs = (queries.data_ptr(), corpus.data_ptr(), corpus_scales.data_ptr())
    wgmma = k2_variant(dev.type, d, ptrs) == "wgmma"
    fn, name = ((lib.sss_scores_bmax_int8_sm90, "scores_bmax_int8_sm90") if wgmma
                else (lib.sss_scores_bmax_int8, "scores_bmax_int8"))
    mips._cuda_call(fn, name, dev, *ptrs,
                    None if penalty is None else penalty.data_ptr(),
                    scores.data_ptr(), bmax.data_ptr(), q, n, d, vc,
                    int(score_dtype == torch.bfloat16))
    wgmma_launch_count += wgmma
    launch_count += 1
    return scores, bmax


def int8_exact_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    query_scales: torch.Tensor,
    corpus_scales: torch.Tensor,
    valid_count: Optional[int] = None,
    penalty: Optional[torch.Tensor] = None,
    score_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over int8 codes on both sides (counterpart of
    ``pallas_exact_topk_int8`` :552): one K2 pass, :func:`mips.select_topk`,
    then the per-query scale (positive) multiplies the [q, k] values only.
    Returns (values [q, k] f32 descending, ids [q, k] int64); missing slots
    are (-inf, -1)."""
    if query_scales.shape != (queries.shape[0],):
        raise ValueError(
            f"query_scales must be [{queries.shape[0]}], got {tuple(query_scales.shape)}"
        )
    scores, bmax = scores_with_bucket_max_int8(
        queries, corpus, corpus_scales, valid_count, penalty, score_dtype
    )
    vals, idx = mips.select_topk(scores, bmax, k)
    return vals * query_scales.float()[:, None], idx
