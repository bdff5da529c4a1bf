"""Packed sign-code scan with bucket max, and the exact Hamming top-k built
on it.

Port of the TPU kernel K4 (``sessionsimilaritysearch_tpu/ops/pallas_mips.py``
:863 ``_packed_scores_bmax_kernel`` -> :902 ``packed_scores_with_bucket_max``
-> :995 ``pallas_packed_topk``). The kernel is
``csrc/packed_scores_bmax.cu``; :func:`packed_scores_with_bucket_max_ref` is
its plain PyTorch version (:func:`unpack_bits_t`, then the f32 product, the
mask and the bucket max of ``mips.scores_with_bucket_max_ref``). The corpus
is transposed-packed (``ops/hamming.py`` ``pack_bits_t``): [n / 32, bits]
int32 in 2048-row pack blocks. Buckets are 128 contiguous corpus rows, as in
``ops/mips.py``.

:func:`packed_scores_with_bucket_max` takes the plain version for CPU
tensors only. For a CUDA tensor it launches the kernel or raises: no path
falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sessionsimilaritysearch_tpu_torch.ops import _build, mips

TBLOCK = 2048    # rows per pack block: a layout property of the packed corpus
MAX_BITS = 1536  # widest code the kernel's shared memory holds a query tile of
INT32_MAX = 2**31 - 1
_DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches made by packed_scores_with_bucket_max, counted where the
# kernel is launched and nowhere else (CPU tensors never count).
launch_count = 0


def unpack_bits_t(packed_t: torch.Tensor, block_rows: int = TBLOCK) -> torch.Tensor:
    """Inverse of ``pack_bits_t``: [n / 32, bits] int32 -> [n, bits] +-1
    bf16 rows in original order (bit 1 -> +1, bit 0 -> -1). The shift is
    arithmetic, and ``& 1`` keeps bit 31 right."""
    ns, bits = packed_t.shape
    s_rows = block_rows // 32
    if ns % s_rows:
        raise ValueError(f"{ns} packed rows are not whole {block_rows}-row blocks")
    g = packed_t.reshape(ns // s_rows, 1, s_rows, bits)
    shifts = torch.arange(32, dtype=torch.int32, device=packed_t.device)
    bits01 = (g >> shifts.reshape(1, 32, 1, 1)) & 1  # [G, j, s, bits]
    return (2 * bits01 - 1).reshape(ns * 32, bits).to(torch.bfloat16)


def _check(queries, words, valid_count, penalty, score_dtype) -> int:
    if queries.dim() != 2 or words.dim() != 2:
        raise ValueError(
            f"queries and words must be 2-D, got {tuple(queries.shape)} and "
            f"{tuple(words.shape)}"
        )
    bits = queries.shape[1]
    if words.shape[1] != bits:
        raise ValueError(
            f"width mismatch: queries {bits} columns, words {words.shape[1]}"
        )
    if bits % 128 or not 0 < bits <= MAX_BITS:
        raise ValueError(
            f"padded code width must be a multiple of 128 up to {MAX_BITS}, got {bits}"
        )
    if words.shape[0] % (TBLOCK // 32):
        raise ValueError(
            f"{words.shape[0]} packed rows are not whole {TBLOCK}-row pack blocks"
        )
    if queries.dtype != torch.bfloat16 or words.dtype != torch.int32:
        raise TypeError(
            f"queries must be bfloat16 and words int32, got {queries.dtype} and "
            f"{words.dtype}"
        )
    if score_dtype not in _DTYPES:
        raise TypeError(f"score_dtype must be float32 or bfloat16, got {score_dtype}")
    if queries.device != words.device:
        raise ValueError(f"queries on {queries.device}, words on {words.device}")
    if not (queries.is_contiguous() and words.is_contiguous()):
        raise ValueError("queries and words must be contiguous")
    n = words.shape[0] * 32
    vc = n if valid_count is None else int(valid_count)
    if not 0 <= vc <= n:
        raise ValueError(f"valid_count {vc} outside [0, {n}]")
    if penalty is not None:
        if (penalty.dtype != torch.float32 or penalty.shape != (n,)
                or penalty.device != words.device
                or not penalty.is_contiguous()):
            raise ValueError(
                f"penalty must be a contiguous float32 [{n}] tensor on "
                f"{words.device}, got {penalty.dtype} {tuple(penalty.shape)} "
                f"on {penalty.device}"
            )
    return vc


def packed_scores_with_bucket_max_ref(
    queries: torch.Tensor,
    words: torch.Tensor,
    valid_count: Optional[int] = None,
    penalty: Optional[torch.Tensor] = None,
    score_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (scores [q, n] ``score_dtype``,
    bmax [q, n / 128] f32) for +-1 bf16 queries [q, bits] (pad columns zero)
    against transposed-packed words [n / 32, bits]. Scores are the +-1
    products, exact in f32; rows at or past ``valid_count`` score -inf,
    then ``penalty`` [n] is added; bmax is the max of each 128 contiguous f32
    scores."""
    vc = _check(queries, words, valid_count, penalty, score_dtype)
    return mips.scores_with_bucket_max_ref(
        queries, unpack_bits_t(words), vc, penalty, score_dtype
    )


def packed_scores_with_bucket_max(
    queries: torch.Tensor,
    words: torch.Tensor,
    valid_count: Optional[int] = None,
    penalty: Optional[torch.Tensor] = None,
    score_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel (``csrc/packed_scores_bmax.cu``) for CUDA tensors; its
    plain version for CPU tensors. Same contract as
    :func:`packed_scores_with_bucket_max_ref`."""
    global launch_count
    vc = _check(queries, words, valid_count, penalty, score_dtype)
    dev = queries.device
    if dev.type == "cpu":
        return packed_scores_with_bucket_max_ref(
            queries, words, vc, penalty, score_dtype
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    q, bits = queries.shape
    n = words.shape[0] * 32
    if max(q, n) >= 2**31:
        raise ValueError(f"shape too large for int32 indexing: q={q} n={n}")
    if queries.data_ptr() % 16 or words.data_ptr() % 16:
        raise ValueError("queries and words must start on a 16-byte boundary")
    lib = _build.load_library()
    scores = torch.empty((q, n), dtype=score_dtype, device=dev)
    bmax = torch.empty((q, n // mips.BUCKET), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sss_packed_scores_bmax(
            queries.data_ptr(), words.data_ptr(),
            None if penalty is None else penalty.data_ptr(),
            scores.data_ptr(), bmax.data_ptr(),
            q, n, bits, vc, int(score_dtype == torch.bfloat16),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"packed_scores_bmax kernel launch failed: CUDA error {err} "
            f"(q={q} n={n} bits={bits} -> {score_dtype})"
        )
    launch_count += 1
    return scores, bmax


def packed_topk(
    queries: torch.Tensor,
    words: torch.Tensor,
    k: int,
    n_bits: int,
    valid_count: Optional[int] = None,
    penalty: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact Hamming top-k over a transposed-packed corpus: one kernel pass,
    then ``mips.select_topk`` and distance = (n_bits - dot) / 2. Scores are
    bf16 for codes of up to 256 bits (every integer dot is exact there) and
    f32 above (``pallas_mips.py:1034``). Returns (distances [q, k] int32
    ascending, ids [q, k] int64); missing slots are (INT32_MAX, -1)."""
    score_dtype = torch.bfloat16 if n_bits <= 256 else torch.float32
    scores, bmax = packed_scores_with_bucket_max(
        queries, words, valid_count, penalty, score_dtype
    )
    return dots_to_hamming(*mips.select_topk(scores, bmax, k), n_bits)


def dots_to_hamming(vals: torch.Tensor, idx: torch.Tensor, n_bits: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k +-1 dot products -> Hamming distances (n_bits - dot) / 2 as
    int32; missing slots (-inf, -1) become (INT32_MAX, -1)."""
    missing = idx < 0
    dist = ((n_bits - vals.masked_fill(missing, 0.0)) * 0.5).to(torch.int32)
    return dist.masked_fill(missing, INT32_MAX), idx
