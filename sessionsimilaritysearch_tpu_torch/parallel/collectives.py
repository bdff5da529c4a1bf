"""Cross-shard retrieval collectives (counterpart of
``sessionsimilaritysearch_tpu/parallel/collectives.py``: ``sharded_topk``
:39, ``sharded_twostage_topk`` :144, ``sharded_hamming_topk`` :347,
``shard_corpus`` :505).

The corpus shards row-wise over the mesh's ``data`` axis. Each shard scans
its own rows with the port's kernels (K1, K2 or K4 through
``ops.topk.chunked_topk``, ``ops.hamming`` and ``ops.topk.rerank_topk``),
maps its [q, k] candidates to global ids, and :func:`merge_candidates`
selects the global top-k: the local shards' candidates concatenated in
shard order, then, on a mesh that spans processes, every rank's through
``dist.all_gather``. The selection is a stable sort, so that equal values
resolve to the lower position of the shard-major concatenation, as
``lax.top_k`` resolves them in JAX (:107); ``torch.topk`` leaves the order
of ties undefined.

A sharded tensor is a list of this process's shards, in
``mesh.local_shards(axis)`` order, each on its shard's device. Per-shard
host values (``valid_per_shard``) cover every shard of the mesh. JAX's
compile cache and power-of-two query padding have no counterpart: nothing
here is traced.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.ops import hamming
from sessionsimilaritysearch_tpu_torch.ops.topk import chunked_topk, rerank_topk
from sessionsimilaritysearch_tpu_torch.parallel.mesh import Mesh

Shards = List[torch.Tensor]
INT32_MAX = hamming.INT32_MAX


def shard_corpus(corpus, mesh: Mesh, axis: str = "data") -> Shards:
    """Split [n, ...] rows (numpy or tensor) into ``mesh.shape[axis]``
    contiguous shards and place this process's on their devices."""
    ndev = mesh.shape[axis]
    corpus = torch.as_tensor(corpus)
    if corpus.shape[0] % ndev:
        raise ValueError(f"corpus rows {corpus.shape[0]} not divisible by mesh axis {ndev}")
    per = corpus.shape[0] // ndev
    devs = mesh.shard_devices(axis)
    return [corpus[s * per: (s + 1) * per].to(devs[s]).contiguous()
            for s in mesh.local_shards(axis)]


def gather_shards(mesh: Mesh, shards: Shards, axis: str = "data") -> Shards:
    """Every shard of the mesh, in shard order: the local ones as they are,
    the other ranks' through ``dist.all_gather`` (each rank holds as many
    shards, all of one shape). bf16 travels as int16."""
    if not mesh.distributed:
        return list(shards)
    import torch.distributed as dist

    local = torch.stack(shards)
    bf16 = local.dtype == torch.bfloat16
    send = local.view(torch.int16) if bf16 else local
    out = [torch.empty_like(send) for _ in range(mesh.world)]
    dist.all_gather(out, send)
    full = torch.cat(out)
    return list((full.view(torch.bfloat16) if bf16 else full).unbind(0))


def merge_candidates(mesh: Mesh, vals: Shards, ids: Shards, k: int,
                     descending: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k of the local shards' [q, k_s] candidates (values, global
    ids): concatenated in shard order on the first shard's device, gathered
    from every rank on a mesh that spans processes, then a stable sort.
    Returns [q, k] on that device, with missing slots as the shards gave
    them."""
    dev = vals[0].device
    v = torch.cat([x.to(dev) for x in vals], dim=1)
    i = torch.cat([x.to(dev) for x in ids], dim=1)
    if mesh.distributed:
        import torch.distributed as dist

        gv = [torch.empty_like(v) for _ in range(mesh.world)]
        gi = [torch.empty_like(i) for _ in range(mesh.world)]
        dist.all_gather(gv, v.contiguous())
        dist.all_gather(gi, i.contiguous())
        v, i = torch.cat(gv, dim=1), torch.cat(gi, dim=1)
    order = torch.sort(v, dim=1, descending=descending, stable=True).indices[:, :k]
    return torch.gather(v, 1, order), torch.gather(i, 1, order)


def _global_ids(idx: torch.Tensor, ids_local: Optional[torch.Tensor], base: int) -> torch.Tensor:
    """Shard-local row ids -> global ids (-1 stays -1): the shard's id
    tensor, or the global row position ``base + row``."""
    safe = idx.clamp(min=0)
    gids = ids_local.to(torch.int64)[safe] if ids_local is not None else safe + base
    return torch.where(idx >= 0, gids, torch.full_like(gids, -1))


def _valid(valid_per_shard, ndev: int, shard_rows: int) -> List[int]:
    if valid_per_shard is None:
        return [shard_rows] * ndev
    valid = [int(v) for v in np.asarray(valid_per_shard).reshape(-1)]
    if len(valid) != ndev:
        raise ValueError(f"valid_per_shard has {len(valid)} entries for {ndev} shards")
    return valid


def _missing(nq: int, k: int, dev, dist_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, ids) of k missing slots: (-inf, -1), or (INT32_MAX, -1) for
    Hamming distances."""
    if dist_dtype is None:
        vals = torch.full((nq, k), float("-inf"), device=dev)
    else:
        vals = torch.full((nq, k), INT32_MAX, dtype=dist_dtype, device=dev)
    return vals, torch.full((nq, k), -1, dtype=torch.int64, device=dev)


def sharded_topk(
    queries: torch.Tensor,
    corpus: Shards,
    k: int,
    mesh: Mesh,
    axis: str = "data",
    shard_ids: Optional[Shards] = None,
    valid_per_shard: Optional[Sequence[int]] = None,
    chunk_size: int = 262144,
    mode: str = "exact",
    corpus_scales: Optional[Shards] = None,
    query_scales: Optional[torch.Tensor] = None,
    score_dtype: torch.dtype = torch.float32,
    row_mask: Optional[Shards] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a row-sharded corpus: per shard
    ``ops.topk.chunked_topk`` (K1, or K2 with ``query_scales``) over its
    first ``valid_per_shard[s]`` rows, with its int8 ``corpus_scales`` and
    its ``row_mask`` (False rows never rank), then :func:`merge_candidates`.

    queries: [q, d] (normalized by the caller for 'cos'); corpus: the
    local shards ([shard_rows, d] each, e.g. from :func:`shard_corpus`);
    shard_ids: global id per row of each local shard (default: the global
    row position). Returns (values [q, k] f32 descending, global ids
    [q, k] int64); missing slots are (-inf, -1)."""
    ndev = mesh.shape[axis]
    shard_rows = corpus[0].shape[0]
    valid = _valid(valid_per_shard, ndev, shard_rows)
    chunk_size = max(1, min(chunk_size, shard_rows))
    vals, ids = [], []
    for j, s in enumerate(mesh.local_shards(axis)):
        dev = corpus[j].device
        v, idx = chunked_topk(
            queries.to(dev), corpus[j], k, chunk_size=chunk_size, valid_count=valid[s],
            mode=mode, score_dtype=score_dtype,
            corpus_scales=None if corpus_scales is None else corpus_scales[j],
            query_scales=None if query_scales is None else query_scales.to(dev),
            row_mask=None if row_mask is None else row_mask[j],
        )
        vals.append(v)
        ids.append(_global_ids(idx, None if shard_ids is None else shard_ids[j],
                               s * shard_rows))
    return merge_candidates(mesh, vals, ids, k)


def _used_packed_rows(valid: int) -> int:
    """Packed rows of the pack blocks that hold the first ``valid`` slots
    (later blocks hold no set bit)."""
    return -(-valid // hamming.TBLOCK) * (hamming.TBLOCK // 32)


def sharded_twostage_topk(
    queries: torch.Tensor,
    q_signs: torch.Tensor,
    corpus: Shards,
    codes: Shards,
    k: int,
    mesh: Mesh,
    axis: str = "data",
    shard_ids: Optional[Shards] = None,
    valid_per_shard: Optional[Sequence[int]] = None,
    pool: int = 512,
    recall_target: float = 0.95,
    score_dtype: torch.dtype = torch.float32,
    code_scales: Optional[Shards] = None,
    q_code_scales: Optional[torch.Tensor] = None,
    row_mask: Optional[Shards] = None,
    packed_bits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage top-k over a row-sharded corpus: per shard, a stage-1 scan
    of its codes nominates ``min(pool, shard rows)`` candidates, stage 2
    ranks them exactly at full width (``ops.topk.rerank_topk``), and
    :func:`merge_candidates` selects the global top-k.

    Stage 1: ``packed_bits`` set -- ``codes`` are transposed-packed int32
    words per shard ([shard_rows / 32, bits_pad], ``q_signs`` with zero pad
    columns), scanned by K4 over the used pack blocks; else
    ``chunked_topk`` with bf16 scores over the codes (+-1 sign codes or
    projections through K1, int8 rows with ``code_scales`` and
    ``q_code_scales`` through K2). JAX selects this stage with
    ``approx_max_k`` (:295); the port selects exactly. ``row_mask`` applies
    inside stage 1. Returns (values [q, k] f32 descending, global ids [q,
    k] int64); missing slots are (-inf, -1)."""
    ndev = mesh.shape[axis]
    shard_rows = corpus[0].shape[0]
    if packed_bits is not None and shard_rows % hamming.TBLOCK:
        raise ValueError(
            f"shard rows {shard_rows} must be whole {hamming.TBLOCK}-slot pack blocks")
    valid = _valid(valid_per_shard, ndev, shard_rows)
    local_pool = min(pool, shard_rows)
    vals, ids = [], []
    for j, s in enumerate(mesh.local_shards(axis)):
        dev = corpus[j].device
        q = queries.to(dev)
        if valid[s] == 0:
            v, idx = _missing(q.shape[0], k, dev)
        else:
            cand = shard_pool(
                q_signs.to(dev), codes[j], local_pool, valid[s], recall_target=recall_target,
                code_scales=None if code_scales is None else code_scales[j],
                q_code_scales=None if q_code_scales is None else q_code_scales.to(dev),
                row_mask=None if row_mask is None else row_mask[j], packed_bits=packed_bits)
            v, idx = rerank_topk(q, corpus[j], cand, k, metric="ip", score_dtype=score_dtype)
        vals.append(v)
        ids.append(_global_ids(idx, None if shard_ids is None else shard_ids[j],
                               s * shard_rows))
    return merge_candidates(mesh, vals, ids, k)


def shard_pool(
    q_signs: torch.Tensor,
    codes: torch.Tensor,
    pool: int,
    valid: int,
    recall_target: float = 0.95,
    code_scales: Optional[torch.Tensor] = None,
    q_code_scales: Optional[torch.Tensor] = None,
    row_mask: Optional[torch.Tensor] = None,
    packed_bits: Optional[int] = None,
) -> torch.Tensor:
    """One shard's stage 1 (:func:`sharded_twostage_topk`): the top-``pool``
    row ids [q, pool] (int64, -1 missing) of its first ``valid`` rows by
    their codes, on the shard's device."""
    if packed_bits is not None:
        used = _used_packed_rows(valid)
        return hamming.packed_t_topk(
            q_signs, codes[:used], pool, packed_bits, valid_count=valid,
            row_mask=None if row_mask is None else row_mask[: used * 32])[1]
    return chunked_topk(
        q_signs, codes, pool, chunk_size=codes.shape[0], metric="ip", mode="approx",
        recall_target=recall_target, score_dtype=torch.bfloat16, valid_count=valid,
        corpus_scales=code_scales, query_scales=q_code_scales, row_mask=row_mask)[1]


def sharded_hamming_topk(
    q_signs: torch.Tensor,
    codes: Shards,
    k: int,
    mesh: Mesh,
    n_bits: int,
    axis: str = "data",
    shard_ids: Optional[Shards] = None,
    valid_per_shard: Optional[Sequence[int]] = None,
    selection: str = "exact",
    recall_target: float = 0.95,
    row_mask: Optional[Shards] = None,
    packed_bits: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hamming top-k over row-sharded codes: per shard, the +-1 product
    scan (``ops.hamming.sign_topk``, K1) over [shard_rows, n_bits] sign
    rows, or, with ``packed_bits``, the packed scan (K4) over its
    transposed-packed words (``q_signs`` with zero pad columns; the used
    pack blocks only); then :func:`merge_candidates` on the integer
    distances, ascending. ``row_mask``: per shard, over its slots.
    Returns (distances [q, k] int32 ascending, global ids [q, k] int64);
    missing slots are (INT32_MAX, -1)."""
    ndev = mesh.shape[axis]
    shard_rows = codes[0].shape[0] * (1 if packed_bits is None else 32)
    valid = _valid(valid_per_shard, ndev, shard_rows)
    dists, ids = [], []
    for j, s in enumerate(mesh.local_shards(axis)):
        dev = codes[j].device
        qs = q_signs.to(dev)
        rm = None if row_mask is None else row_mask[j]
        if valid[s] == 0:
            dist, idx = _missing(qs.shape[0], k, dev, torch.int32)
        elif packed_bits is None:
            dist, idx = hamming.sign_topk(
                qs, codes[j], k, n_bits, chunk_size=shard_rows, mode=selection,
                recall_target=recall_target, valid_count=valid[s], row_mask=rm)
        else:
            used = _used_packed_rows(valid[s])
            dist, idx = hamming.packed_t_topk(
                qs, codes[j][:used], k, packed_bits, valid_count=valid[s],
                row_mask=None if rm is None else rm[: used * 32])
        dists.append(dist)
        ids.append(_global_ids(idx, None if shard_ids is None else shard_ids[j],
                               s * shard_rows))
    return merge_candidates(mesh, dists, ids, k, descending=False)
