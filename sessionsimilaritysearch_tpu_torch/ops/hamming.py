"""Binary-code (Hamming) search (counterpart of
``sessionsimilaritysearch_tpu/ops/hamming.py``).

Three scans of sign codes, each exact:

- :func:`hamming_topk`: row-major packed int32 codes, XOR + popcount bucket
  minimum (kernel K5, ``ops/popcount.py``) and a popcount re-rank;
- :func:`packed_t_topk`: transposed-packed codes, unpacked to +-1 bf16
  inside the kernel and ranked by sign products (K4, ``ops/packed.py``);
- :func:`sign_topk`: +-1 bf16 rows through the fused score scan (K1,
  ``ops/mips.py``, chunked by ``ops/topk.py`` ``chunked_topk``). For +-1
  vectors ``dot = n_bits - 2 * hamming``, so the inner-product ranking is
  the Hamming ranking.

``unpack_bits_t`` (JAX :116, the device inverse of ``pack_bits_t``) lives
in ``ops/packed.py`` beside K4 and is re-exported here. The numpy helpers
(``pack_bits_np``, ``unpack_bits_np``, ``pack_bits_t_np``,
``unpack_bits_t_np``, ``t_slot_coords``, ``oracle_hamming_np``) are copied
as they are: the JAX module imports ``jax`` at its top. Distances are int32,
ids int64, missing slots (INT32_MAX, -1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.ops import packed, popcount, topk
from sessionsimilaritysearch_tpu_torch.ops.packed import (  # noqa: F401
    INT32_MAX,
    TBLOCK,
    unpack_bits_t,
)


def pack_bits_np(signs: np.ndarray) -> np.ndarray:
    """Pack a [n, bits] array of {+1,-1} (or {1,0}) into [n, ceil(bits/32)]
    int32 words (bit j of word w = bit 32*w + j)."""
    signs = np.asarray(signs)
    bits = (signs > 0).astype(np.uint32)
    n, d = bits.shape
    w = -(-d // 32)
    padded = np.zeros((n, w * 32), dtype=np.uint32)
    padded[:, :d] = bits
    padded = padded.reshape(n, w, 32)
    shifts = np.arange(32, dtype=np.uint32)
    words = (padded << shifts[None, None, :]).sum(axis=2, dtype=np.uint32)
    return words.view(np.int32)


def unpack_bits_np(words: np.ndarray, n_bits: int) -> np.ndarray:
    """Inverse of :func:`pack_bits_np`: [n, w] int32 -> [n, n_bits] +-1
    float32 (bit 1 -> +1, bit 0 -> -1)."""
    words = np.asarray(words).view(np.uint32)
    n, w = words.shape
    shifts = np.arange(32, dtype=np.uint32)
    bits = (words[:, :, None] >> shifts[None, None, :]) & np.uint32(1)
    bits = bits.reshape(n, w * 32)[:, :n_bits]
    return np.where(bits > 0, 1.0, -1.0).astype(np.float32)


def pack_bits_t_np(signs: np.ndarray, block_rows: int = TBLOCK) -> np.ndarray:
    """Transposed packing of [n, bits] {+1,-1} (or {0,1}) sign codes into
    [n//32, bits] int32: within a block of ``block_rows`` rows, row
    ii = j * (block_rows // 32) + s is stored as bit j of packed row s.
    ``n % block_rows == 0`` (pad the row count first; zero rows unpack to
    all -1 codes)."""
    signs = np.asarray(signs)
    n, bits = signs.shape
    assert n % block_rows == 0 and block_rows % 32 == 0, (n, block_rows)
    s_rows = block_rows // 32
    b01 = (signs > 0).astype(np.uint32)
    g = b01.reshape(n // block_rows, 32, s_rows, bits)  # [G, j, s, b]
    out = np.zeros((n // block_rows, s_rows, bits), dtype=np.uint32)
    for j in range(32):
        out |= g[:, j, :, :] << np.uint32(j)
    return out.reshape(n // 32, bits).view(np.int32)


def unpack_bits_t_np(packed_t: np.ndarray, block_rows: int = TBLOCK) -> np.ndarray:
    """Host-side inverse of :func:`pack_bits_t_np`: [n/32, bits] int32 ->
    [n, bits] +-1 float32 rows in original order."""
    packed_t = np.asarray(packed_t).view(np.uint32)
    ns, bits = packed_t.shape
    s_rows = block_rows // 32
    assert ns % s_rows == 0, (ns, block_rows)
    g = packed_t.reshape(ns // s_rows, 1, s_rows, bits)
    shifts = np.arange(32, dtype=np.uint32).reshape(1, 32, 1, 1)
    b01 = (g >> shifts) & np.uint32(1)
    flat = b01.reshape(ns * 32, bits)
    return np.where(flat > 0, 1.0, -1.0).astype(np.float32)


def t_slot_coords(slots, block_rows: int = TBLOCK):
    """Map original-row slot ids to their transposed-layout coordinates:
    (packed row p, bit j). Works for numpy or torch inputs."""
    s_rows = block_rows // 32
    gi, ii = slots // block_rows, slots % block_rows
    return gi * s_rows + ii % s_rows, ii // s_rows


def oracle_hamming_np(q_signs, c_signs, k):
    """Numpy Hamming oracle over +-1 sign arrays."""
    qb = (np.asarray(q_signs) > 0).astype(np.int32)
    cb = (np.asarray(c_signs) > 0).astype(np.int32)
    dist = (qb[:, None, :] != cb[None, :, :]).sum(-1)
    idx = np.argsort(dist, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(dist, idx, axis=1)
    return vals, idx.astype(np.int32)


def pack_bits(signs: torch.Tensor) -> torch.Tensor:
    """Device-side :func:`pack_bits_np`: [n, bits] sign codes -> [n,
    ceil(bits/32)] int32 row-major words."""
    n, d = signs.shape
    w = -(-d // 32)
    bits01 = torch.nn.functional.pad((signs > 0).to(torch.int32), (0, w * 32 - d))
    bits01 = bits01.view(n, w, 32)
    out = torch.zeros((n, w), dtype=torch.int32, device=signs.device)
    for j in range(32):  # 1 << 31 is int32's sign bit: OR, never add
        out |= bits01[:, :, j] << j
    return out


def pack_bits_t(signs: torch.Tensor, block_rows: int = TBLOCK) -> torch.Tensor:
    """Device-side :func:`pack_bits_t_np`: [n, bits] sign codes -> [n / 32,
    bits] int32 in the transposed layout, bit for bit the same words."""
    n, bits = signs.shape
    if n % block_rows or block_rows % 32:
        raise ValueError(f"{n} rows are not whole {block_rows}-row pack blocks")
    s_rows = block_rows // 32
    g = (signs > 0).to(torch.int32).view(n // block_rows, 32, s_rows, bits)
    out = torch.zeros((n // block_rows, s_rows, bits), dtype=torch.int32,
                      device=signs.device)
    for j in range(32):
        out |= g[:, j] << j
    return out.view(n // 32, bits)


def simhash_codes(emb, n_bits: int, seed: int = 0):
    """Training-free cosine LSH (SimHash): ``sign(emb @ R)`` with one shared
    Gaussian projection R [d, n_bits] drawn by numpy from ``seed`` (the JAX
    function's R, bit for bit). Returns [n, n_bits] float32 in {+1, -1}
    (zero dots break ties as +1): a numpy array for numpy input, a tensor on
    the same device (f32 product, TF32 off) for a tensor."""
    R = np.random.default_rng(seed).standard_normal(
        (emb.shape[1], n_bits)
    ).astype(np.float32)
    if isinstance(emb, torch.Tensor):
        y = emb.float() @ torch.from_numpy(R).to(emb.device)
        return torch.where(y >= 0, 1.0, -1.0)
    emb = np.asarray(emb, np.float32)
    return np.where(emb @ R >= 0, 1.0, -1.0).astype(np.float32)


def _live(n: int, device, valid_count, row_mask) -> Optional[torch.Tensor]:
    """Bool [n] of the rows that may rank, or None when all may."""
    if valid_count is None and row_mask is None:
        return None
    live = torch.ones(n, dtype=torch.bool, device=device)
    if valid_count is not None:
        live[int(valid_count):] = False
    if row_mask is not None:
        live &= torch.as_tensor(row_mask, device=device).to(torch.bool)
    return live


def _penalty(live: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The f32 kernels' additive row penalty: 0 live, -inf dead."""
    if live is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=live.device)
    return torch.where(live, zero, float("-inf"))


def hamming_topk(
    q_codes: torch.Tensor,
    c_codes: torch.Tensor,
    k: int,
    valid_count: Optional[int] = None,
    row_mask=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact Hamming top-k over row-major packed int32 codes, through the
    bucket-minimum kernel K5. Returns (distances [q, k] int32 ascending, ids
    [q, k] int64), FAISS ``IndexBinaryFlat`` conventions. ``valid_count``:
    rows at or past it never rank; ``row_mask``: optional bool [n], False
    rows never rank."""
    n = c_codes.shape[0]
    if n == 0:
        q = q_codes.shape[0]
        return (torch.full((q, k), INT32_MAX, dtype=torch.int32, device=q_codes.device),
                torch.full((q, k), -1, dtype=torch.int64, device=q_codes.device))
    live = _live(n, c_codes.device, valid_count, row_mask)
    return popcount.bucket_min_topk(q_codes, c_codes, k, live)


def packed_t_topk(
    q_signs: torch.Tensor,
    c_packed_t: torch.Tensor,
    k: int,
    n_bits: int,
    valid_count: Optional[int] = None,
    row_mask=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact Hamming top-k over a transposed-packed corpus through the
    packed-scan kernel K4. ``q_signs``: [q, bits_pad] +-1 (columns past
    ``n_bits`` must be ZERO so padded corpus bits contribute nothing).
    Same conventions as :func:`hamming_topk`."""
    live = _live(c_packed_t.shape[0] * 32, c_packed_t.device, None, row_mask)
    return packed.packed_topk(
        q_signs.to(torch.bfloat16).contiguous(), c_packed_t, k, n_bits,
        valid_count=valid_count, penalty=_penalty(live),
    )


def sign_topk(
    q_signs: torch.Tensor,
    c_signs: torch.Tensor,
    k: int,
    n_bits: int,
    chunk_size: int = 1 << 20,
    mode: str = "exact",
    recall_target: float = 0.95,
    valid_count: Optional[int] = None,
    row_mask=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hamming top-k via the +-1 product scan (K1, through
    ``ops.topk.chunked_topk`` in chunks of ``chunk_size`` rows). ``q_signs``
    / ``c_signs`` are +-1, [*, n_bits]. Scores are bf16 for codes up to 256
    bits (exact: every integer of magnitude <= 256 is a bf16) and f32
    above. Same conventions as :func:`hamming_topk`. ``mode`` and
    ``recall_target`` as in ``chunked_topk``: 'approx' (``lax.approx_max_k``
    in JAX) runs the exact selection."""
    vals, idx = topk.chunked_topk(
        q_signs.to(torch.bfloat16), c_signs.to(torch.bfloat16), k,
        chunk_size=chunk_size, mode=mode, recall_target=recall_target,
        score_dtype=torch.bfloat16 if n_bits <= 256 else torch.float32,
        valid_count=valid_count, row_mask=row_mask,
    )
    return packed.dots_to_hamming(vals, idx, n_bits)
