"""XOR + popcount bucket minimum, and the exact Hamming top-k built on it.

Port of the TPU kernel K5 (``sessionsimilaritysearch_tpu/ops/pallas_mips.py``
:619 ``_hamming_bucket_min_kernel`` and :651
``_hamming_bucket_min_pen_kernel`` -> :683 ``hamming_bucket_min`` -> :761
``pallas_hamming_topk``). The kernel is ``csrc/hamming_bucket_min.cu``;
:func:`hamming_bucket_min_ref` is its plain PyTorch version. Codes are
row-major packed int32 (``ops/hamming.py`` ``pack_bits``), buckets 128
contiguous corpus rows. :func:`bucket_min_topk` re-ranks the rows of the
best buckets by exact popcount (``pallas_mips.py:811-844``, XLA on the TPU,
torch ops here). torch has no popcount op: :func:`popcount32` counts bits
with the SWAR sums on int64.

:func:`hamming_bucket_min` takes the plain version for CPU tensors only. For
a CUDA tensor it launches the kernel or raises: no path falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sessionsimilaritysearch_tpu_torch.ops import _build

BUCKET = 128
PENALTY = 1 << 20  # added to a dead row's distance: above any code's distance
MAX_WORDS = 53     # widest code (in int32 words) the kernel's shared memory holds
INT32_MAX = 2**31 - 1
_REF_ELEMS = 1 << 25  # plain version: (query, row, word) triples per chunk

# Kernel launches made by hamming_bucket_min, counted where the kernel is
# launched and nowhere else (CPU tensors never count).
launch_count = 0


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (its 32-bit pattern), as int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distances(q_codes: torch.Tensor, c_codes: torch.Tensor) -> torch.Tensor:
    """[..., w] x [..., w] packed codes (broadcasting) -> Hamming distances
    [...] int32."""
    return popcount32(torch.bitwise_xor(q_codes, c_codes)).sum(-1).to(torch.int32)


def _check(q_codes, c_codes, penalty) -> None:
    if q_codes.dim() != 2 or c_codes.dim() != 2:
        raise ValueError(
            f"codes must be 2-D, got {tuple(q_codes.shape)} and {tuple(c_codes.shape)}"
        )
    w = q_codes.shape[1]
    if c_codes.shape[1] != w or not 0 < w <= MAX_WORDS:
        raise ValueError(
            f"codes must share a width of 1 to {MAX_WORDS} words, got "
            f"{w} and {c_codes.shape[1]}"
        )
    if q_codes.dtype != torch.int32 or c_codes.dtype != torch.int32:
        raise TypeError(f"codes must be int32, got {q_codes.dtype} and {c_codes.dtype}")
    if q_codes.device != c_codes.device:
        raise ValueError(f"queries on {q_codes.device}, corpus on {c_codes.device}")
    if not (q_codes.is_contiguous() and c_codes.is_contiguous()):
        raise ValueError("codes must be contiguous")
    n = c_codes.shape[0]
    if penalty is not None:
        if (penalty.dtype != torch.int32 or penalty.shape != (n,)
                or penalty.device != c_codes.device
                or not penalty.is_contiguous()):
            raise ValueError(
                f"penalty must be a contiguous int32 [{n}] tensor on "
                f"{c_codes.device}, got {penalty.dtype} {tuple(penalty.shape)} "
                f"on {penalty.device}"
            )


def hamming_bucket_min_ref(
    q_codes: torch.Tensor,
    c_codes: torch.Tensor,
    penalty: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: bmin [q, ceil(n / 128)] int32,
    the min over each 128 contiguous rows of (Hamming distance + penalty).
    Rows are taken in chunks, so memory stays bounded at any shape."""
    _check(q_codes, c_codes, penalty)
    q, w = q_codes.shape
    n = c_codes.shape[0]
    nb = -(-n // BUCKET)
    bmin = torch.empty((q, nb), dtype=torch.int32, device=q_codes.device)
    step = max(1, _REF_ELEMS // max(q * w * BUCKET, 1)) * BUCKET
    for r0 in range(0, n, step):
        rows = c_codes[r0: r0 + step]
        d = hamming_distances(q_codes[:, None, :], rows[None, :, :])
        if penalty is not None:
            d = d + penalty[r0: r0 + step]
        m = rows.shape[0]
        mb = -(-m // BUCKET)
        d = torch.nn.functional.pad(d, (0, mb * BUCKET - m), value=INT32_MAX)
        bmin[:, r0 // BUCKET: r0 // BUCKET + mb] = d.view(q, mb, BUCKET).amin(-1)
    return bmin


def hamming_bucket_min(
    q_codes: torch.Tensor,
    c_codes: torch.Tensor,
    penalty: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel (``csrc/hamming_bucket_min.cu``) for CUDA tensors; its
    plain version for CPU tensors. Same contract as
    :func:`hamming_bucket_min_ref`."""
    global launch_count
    _check(q_codes, c_codes, penalty)
    dev = q_codes.device
    if dev.type == "cpu":
        return hamming_bucket_min_ref(q_codes, c_codes, penalty)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    q, w = q_codes.shape
    n = c_codes.shape[0]
    if max(q, n) >= 2**31:
        raise ValueError(f"shape too large for int32 indexing: q={q} n={n}")
    lib = _build.load_library()
    bmin = torch.empty((q, -(-n // BUCKET)), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sss_hamming_bucket_min(
            q_codes.data_ptr(), c_codes.data_ptr(),
            None if penalty is None else penalty.data_ptr(),
            bmin.data_ptr(), q, n, w, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"hamming_bucket_min kernel launch failed: CUDA error {err} "
            f"(q={q} n={n} words={w})"
        )
    launch_count += 1
    return bmin


def bucket_min_topk(
    q_codes: torch.Tensor,
    c_codes: torch.Tensor,
    k: int,
    live: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact Hamming top-k: the bucket minima (kernel), the ``k`` best
    buckets, then an exact popcount re-rank of their rows. ``live``:
    optional bool [n]; dead rows carry the penalty inside the kernel and
    never rank. Returns (distances [q, k] int32 ascending, ids [q, k]
    int64); missing slots are (INT32_MAX, -1). When ``k`` exceeds the
    bucket count every row is re-ranked."""
    n = c_codes.shape[0]
    penalty = None
    if live is not None:
        penalty = torch.where(live, 0, PENALTY).to(torch.int32)
    bmin = hamming_bucket_min(q_codes, c_codes, penalty)
    q, nb = bmin.shape
    _, b_idx = torch.topk(bmin, min(k, nb), dim=1, largest=False)
    cols = (b_idx[..., None] * BUCKET
            + torch.arange(BUCKET, device=bmin.device)).view(q, -1)
    safe = cols.clamp(max=n - 1)
    dist = hamming_distances(q_codes[:, None, :], c_codes[safe])
    ok = cols < n
    if live is not None:
        ok &= live[safe]
    dist = dist.masked_fill(~ok, INT32_MAX)
    kk = min(k, dist.shape[1])
    vals, pos = torch.topk(dist, kk, dim=1, largest=False)
    idx = torch.gather(cols, 1, pos).masked_fill(vals == INT32_MAX, -1)
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=INT32_MAX)
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    return vals, idx
