"""Two-stage serving index: a cheap stage-1 scan over the whole corpus
nominates a pool of candidates per query, and stage 2 re-ranks the pool
exactly at full width (counterpart of
``sessionsimilaritysearch_tpu/index/twostage.py:70`` ``TwoStageIndex`` and
``build_twostage_index`` :1174).

Stage 1, by prefilter and ``stage1``:

- 'binary' (SimHash ``sign(x @ R)``) or 'itq' (learned
  ``sign((x - mean) @ components.T)``) sign codes:
  - ``stage1='matmul'`` (the default): +-1 bf16 codes in a [capacity,
    n_bits] buffer, ranked by ``ops.hamming.sign_topk`` through K1
    (``ops/mips.py``; the TMA-fed ``wgmma`` variant at 256 bits, the
    ``cp.async``-fed one at widths that are no TMA stride, such as 250);
  - ``stage1='packed'``: transposed-packed codes in a packed
    ``BinaryIndex``, ranked through K4 (``ops/packed.py``);
- 'int8x8': per-row int8 codes and scales (``ops.mips_int8``), ranked by
  K2 with bf16 scores and per-query scales;
- 'pca': a fitted projection, L2-normalized and stored in bf16, ranked by
  K1.

JAX selects the matmul stage 1 with ``lax.approx_max_k``; the port runs the
exact selection (``ops/topk.py``), so its pool is the exact top-``pool`` of
the stage-1 scores. Stage 1 runs in chunks of ``STAGE1_CHUNK`` rows merged
exactly (JAX scans the capacity as one chunk), which gives the same pool.
Stage 2 (``ops.topk.rerank_topk``) gathers the pool's rows from the
full-width store and ranks them by f32 products.

The SimHash projection R [d, n_bits] is state. By default it is drawn from
a ``torch.Generator`` seeded with ``seed``, a different stream from the JAX
index's ``jax.random.normal(PRNGKey(seed))``; pass ``projection=`` (for the
JAX one, ``weights.simhash_projection``) to reproduce another index's codes.

Snapshots are the JAX index's npz, key for key, so each package loads the
other's, with one exception. A JAX ``'binary'`` file stores only ``seed``,
so loading one needs ``projection=``. The port's ``'binary'`` snapshot adds
one key, ``projection``, so that its own files reload with the same codes;
JAX ignores that key and redraws R from the seed, so a port ``'binary'``
file does not serve correctly in the JAX package. Every other prefilter
loads in both directions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex, _t_move_bits, _t_or_bits
from sessionsimilaritysearch_tpu_torch.index.dense import (
    _DTYPE_NAMES,
    DenseIndex,
    _named_dtype,
    compaction_plan,
    positional_mask,
    to_host_chunked,
)
from sessionsimilaritysearch_tpu_torch.index.sharded import _load_npz, _restripe, _ShardedRows
from sessionsimilaritysearch_tpu_torch.ops import hamming, mips_int8
from sessionsimilaritysearch_tpu_torch.ops.projection import PCAProjector, fit_itq, fit_pca
from sessionsimilaritysearch_tpu_torch.ops.topk import (
    check_selection,
    chunked_topk,
    l2_normalize,
    rerank_topk,
)
from sessionsimilaritysearch_tpu_torch.parallel.collectives import sharded_twostage_topk
from sessionsimilaritysearch_tpu_torch.parallel.mesh import Mesh
from sessionsimilaritysearch_tpu_torch.utils.profiling import count, trace

PREFILTERS = ("binary", "itq", "int8x8", "pca")
# corpus rows per stage-1 chunk: a [q, chunk] bf16 score buffer (2 GiB at
# 1024 queries), merged exactly across chunks
STAGE1_CHUNK = 1 << 20


def _f32(x, device) -> torch.Tensor:
    """An own f32 copy of an array or tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, torch.float32).clone()
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _signs(y: torch.Tensor) -> torch.Tensor:
    """Sign codes of projections: +1 where y >= 0, else -1, as bf16."""
    return torch.where(y >= 0, 1.0, -1.0).to(torch.bfloat16)


def _check_args(metric, prefilter, stage1, projector) -> None:
    if metric not in ("cos", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    if prefilter not in PREFILTERS:
        raise ValueError(f"unknown prefilter {prefilter!r}")
    if stage1 not in ("matmul", "packed"):
        raise ValueError(f"unknown stage1 {stage1!r}")
    if stage1 == "packed" and prefilter not in ("binary", "itq"):
        raise ValueError(
            "stage1='packed' scans sign codes; use the 'binary' or 'itq' prefilter")
    if prefilter in ("pca", "itq") and projector is None:
        raise ValueError(
            f"prefilter={prefilter!r} needs a fitted projector (fit_pca / fit_itq)")


class _StageOne:
    """The stage-1 code transform of a prefilter and its parameters (on
    ``self.device``): the SimHash projection ('binary'), or a fitted
    projector's mean and components ('itq', 'pca')."""

    def _init_stage1(self, n_bits: int, projector, projection) -> int:
        """Set the parameters up; returns the code width ('itq': the
        projector's rows)."""
        dim, seed = self.dim, self.seed
        if self.prefilter in ("pca", "itq"):
            self._proj_mean = _f32(projector.mean, self.device)
            self._proj_comp = _f32(projector.components, self.device)
            self._proj_explained = float(projector.explained)
            if self.prefilter == "itq":
                n_bits = self._proj_comp.shape[0]
        elif self.prefilter == "binary":
            if projection is None:
                g = torch.Generator().manual_seed(seed)
                self._projection = torch.randn(dim, n_bits, generator=g).to(self.device)
            else:
                self._projection = _f32(projection, self.device)
                if self._projection.shape != (dim, n_bits):
                    raise ValueError(
                        f"projection must be [{dim}, {n_bits}], got "
                        f"{tuple(self._projection.shape)}"
                    )
        return n_bits

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        """'pca' codes: the projection, L2-normalized, in bf16."""
        y = (x - self._proj_mean.to(x.device)) @ self._proj_comp.to(x.device).T
        return l2_normalize(y, eps=1e-24).to(torch.bfloat16)

    def _encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Stage-1 codes of f32 rows (f32 products, on ``x``'s device), with
        their int8 scales under 'int8x8'."""
        if self.prefilter == "binary":
            return _signs(x @ self._projection.to(x.device)), None
        if self.prefilter == "itq":
            return _signs((x - self._proj_mean.to(x.device))
                          @ self._proj_comp.to(x.device).T), None
        if self.prefilter == "int8x8":
            return mips_int8.quantize_rows_int8(x)
        return self._project(x), None

    def _stage1_snapshot(self) -> dict:
        """The stage-1 parameters as snapshot keys (numpy)."""
        if self.prefilter in ("pca", "itq"):
            return {"proj_mean": self._proj_mean.cpu().numpy(),
                    "proj_comp": self._proj_comp.cpu().numpy(),
                    "proj_explained": self._proj_explained}
        if self.prefilter == "binary":
            return {"projection": self._projection.cpu().numpy()}
        return {}


def _stage1_load_args(z, path: str, projection) -> dict:
    """The projector or projection a snapshot's stage 1 needs: 'itq' /
    'pca' carry theirs; a 'binary' file needs its SimHash projection (the
    port writes it) or ``projection=`` (a JAX file stores only the
    seed)."""
    prefilter = str(z["prefilter"]) if "prefilter" in z else "binary"
    if prefilter in ("pca", "itq"):
        return {"projector": PCAProjector(np.asarray(z["proj_mean"], np.float32),
                                          np.asarray(z["proj_comp"], np.float32),
                                          float(z["proj_explained"]))}
    if prefilter == "binary":
        if projection is None:
            if "projection" not in z:
                raise ValueError(
                    f"{path}: a 'binary' snapshot without its SimHash projection "
                    "(the JAX package stores only the seed); pass projection= "
                    "(weights.simhash_projection of the JAX index's)")
            projection = z["projection"]
        return {"projection": projection}
    return {}


class TwoStageIndex(_StageOne):
    """Stage-1 prefilter + exact re-rank over one embedding corpus.

    Args:
      dim, capacity: row width and the most rows the index holds.
      device: where the buffers live ('cpu' or a CUDA device).
      metric: 'cos' (rows and queries L2-normalized in f32) or 'ip'.
      prefilter: 'binary', 'itq', 'int8x8' or 'pca' (module docstring).
        'itq' and 'pca' need a fitted ``projector`` (``ops.projection``
        ``fit_itq`` / ``fit_pca``, or the JAX package's as it is); its rows
        fix 'itq''s ``n_bits``.
      n_bits: SimHash code width ('binary').
      pool: default stage-1 candidates per query.
      store_dtype: dtype of the full-width rows (bf16 default, as in JAX).
      recall_target: JAX's stage-1 approx recall target; kept and stored,
        and met by the exact selection.
      projector: fitted projector ('itq' and 'pca'; anything with ``mean``,
        ``components`` and ``explained``).
      seed: seed of the default SimHash projection.
      stage1: 'matmul' (the default) or 'packed' ('binary' and 'itq' only).
      projection: SimHash projection [dim, n_bits] to use instead of the
        seeded draw.
    """

    def __init__(
        self,
        dim: int,
        capacity: int,
        *,
        device,
        metric: str = "cos",
        prefilter: str = "binary",
        n_bits: int = 256,
        pool: int = 512,
        store_dtype: torch.dtype = torch.bfloat16,
        recall_target: float = 0.95,
        projector=None,
        seed: int = 0,
        stage1: str = "matmul",
        projection=None,
    ):
        _check_args(metric, prefilter, stage1, projector)
        check_selection("approx", recall_target)
        self.dim = dim
        self.capacity = capacity
        self.metric = metric
        self.prefilter = prefilter
        self.pool = pool
        self.store_dtype = store_dtype
        self.recall_target = recall_target
        self.seed = seed
        self.stage1 = stage1
        self.device = resolve_device(device)
        self.size = 0
        n_bits = self._init_stage1(n_bits, projector, projection)
        self.n_bits = n_bits
        self._buf = torch.zeros((capacity, dim), dtype=store_dtype, device=self.device)
        self._codes_index = None
        self._scales = None
        if stage1 == "packed":
            self._codes_index = BinaryIndex(n_bits, capacity, "packed", device=self.device)
        elif prefilter in ("binary", "itq"):
            self._codes = -torch.ones((capacity, n_bits), dtype=torch.bfloat16,
                                      device=self.device)
        elif prefilter == "int8x8":
            self._codes = torch.zeros((capacity, dim), dtype=torch.int8, device=self.device)
            self._scales = torch.zeros(capacity, dtype=torch.float32, device=self.device)
        else:
            self._codes = torch.zeros((capacity, self._proj_comp.shape[0]),
                                      dtype=torch.bfloat16, device=self.device)

    @property
    def ntotal(self) -> int:
        return self.size

    def _rows(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.float32)
        if x.dim() != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected [m, {self.dim}] rows, got {tuple(x.shape)}")
        return l2_normalize(x) if self.metric == "cos" else x

    def add(self, emb) -> None:
        """Append [m, d] embeddings: the re-rank rows and their stage-1
        codes."""
        emb = self._rows(emb)
        start, m = self.size, emb.shape[0]
        if start + m > self.capacity:
            raise ValueError(f"index full: {start}+{m} > capacity {self.capacity}")
        self._buf[start: start + m] = emb.to(self.store_dtype)
        codes, scales = self._encode(emb)
        if self._codes_index is not None:
            self._codes_index.add(codes)
        else:
            self._codes[start: start + m] = codes
            if scales is not None:
                self._scales[start: start + m] = scales
        self.size = start + m

    def remove_ids(self, ids) -> int:
        """Remove rows by position (FAISS ``remove_ids``): surviving rows
        renumber as ``index.dense.compaction_plan`` says. The re-rank rows,
        the codes and the int8 scales move together; a packed stage 1 runs
        ``BinaryIndex.remove_ids`` with the same ids, hence the same plan.
        Returns the number of rows removed."""
        src, dst, new_size = compaction_plan(self.size, ids)
        if src.size:
            s = torch.from_numpy(src.astype(np.int64)).to(self.device)
            d = torch.from_numpy(dst.astype(np.int64)).to(self.device)
            bufs = [self._buf, self._scales]
            if self._codes_index is None:
                bufs.append(self._codes)
            for buf in bufs:
                if buf is not None:
                    buf[d] = buf[s]  # src >= new_size > dst: no overlap
        if self._codes_index is not None:
            self._codes_index.remove_ids(ids)
        removed = self.size - new_size
        self.size = new_size
        return removed

    def _stored_rows(self, ids) -> torch.Tensor:
        """Stored full-width rows by position as f32 [m, d] on the device."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.size):
            raise IndexError(f"reconstruct ids must lie in [0, {self.size})")
        return self._buf[torch.from_numpy(ids).to(self.device)].float()

    def reconstruct_batch(self, ids) -> np.ndarray:
        """Stored full-width rows by position, [m, d] float32, as the re-rank
        scores them."""
        return self._stored_rows(ids).cpu().numpy()

    def reconstruct(self, i: int) -> np.ndarray:
        return self.reconstruct_batch([int(i)])[0]

    def merge_from(self, other, batch: int = 65536) -> int:
        """Append ``other``'s stored rows (``faiss.Index.merge_from``):
        ``other`` is a ``TwoStageIndex`` or a non-centered ``DenseIndex`` of
        the same dim and metric. The rows stream through :meth:`add` in
        ``batch`` chunks on the device, so the codes are made under this
        index's prefilter; ids shift by ``self.ntotal`` and ``other`` is
        left intact. Returns the row count appended."""
        if not isinstance(other, (TwoStageIndex, DenseIndex)):
            raise TypeError(
                "merge_from source must be a TwoStageIndex or DenseIndex "
                f"(positional reconstruct ids), got {type(other).__name__}")
        if (other.dim, other.metric) != (self.dim, self.metric):
            raise ValueError(
                "merge_from requires identical dim/metric: "
                f"({self.dim},{self.metric}) vs ({other.dim},{other.metric})")
        if isinstance(other, DenseIndex) and other._center is not None:
            raise ValueError(
                "cannot merge centered-cosine rows: the stored rows are "
                "post-center-transform and this index scores raw cosine")
        if self.size + other.size > self.capacity:
            raise ValueError(f"index full: {self.size}+{other.size} > {self.capacity}")
        for start in range(0, other.size, batch):
            self.add(other._stored_rows(np.arange(start, min(start + batch, other.size))))
        return other.size

    def _stage1(self, qn: torch.Tensor, pool: int, row_mask=None) -> torch.Tensor:
        """Top-``pool`` ids [q, pool] of stage 1 (int64, -1 missing);
        ``row_mask`` is a bool tensor over the rows [0, size) or None."""
        size = self.size
        if self._codes_index is not None:
            codes, _ = self._encode(qn)
            return self._codes_index.search_device(codes, pool, row_mask=row_mask)[1]
        kw = dict(chunk_size=STAGE1_CHUNK, mode="approx",
                  recall_target=self.recall_target, row_mask=row_mask)
        if self.prefilter in ("binary", "itq"):
            codes, _ = self._encode(qn)
            return hamming.sign_topk(codes, self._codes[:size], pool, self.n_bits, **kw)[1]
        if self.prefilter == "int8x8":
            q8, q_scales = mips_int8.quantize_rows_int8(qn)
            return chunked_topk(q8, self._codes[:size], pool, score_dtype=torch.bfloat16,
                                corpus_scales=self._scales[:size], query_scales=q_scales,
                                **kw)[1]
        return chunked_topk(self._project(qn), self._codes[:size], pool,
                            score_dtype=torch.bfloat16, **kw)[1]

    def search_device(self, queries, k: int, pool: Optional[int] = None,
                      row_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`search` returning tensors on the index's device."""
        pool = min(max(pool or self.pool, k), max(self.capacity, 1))
        qn = self._rows(queries)
        mask = (None if row_mask is None
                else positional_mask(row_mask, self.size, self.capacity, self.device))
        with trace("sss.index.stage1"):
            cand = self._stage1(qn, pool, row_mask=mask)
        count("index.rerank_candidates", cand.shape[0] * cand.shape[1])
        with trace("sss.index.rerank"):
            return rerank_topk(qn, self._buf, cand, k)

    def search(self, queries, k: int, pool: Optional[int] = None, row_mask=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact-over-pool top-k: (D [q, k] float32 descending, I [q, k]
        int64) numpy arrays; missing slots (-inf, -1). ``row_mask``
        (length ``size`` or ``capacity``) applies inside stage 1, so the
        pool holds allowed rows only."""
        vals, idx = self.search_device(queries, k, pool, row_mask)
        with trace("sss.index.to_host"):
            return vals.cpu().numpy(), idx.cpu().numpy()

    # --- persistence: the JAX index's npz, key for key (+ 'projection')
    def snapshot(self) -> dict:
        """Phase 1 of a two-phase save: point-in-time copies, on the device,
        of the serving buffers (``add`` and ``remove_ids`` write them in
        place), and the host configuration. Pair with
        :meth:`write_snapshot` on another thread."""
        size = self.size
        snap = {
            "buf": self._buf[:size].clone(),
            "dim": self.dim,
            "capacity": self.capacity,
            "metric": self.metric,
            "prefilter": self.prefilter,
            "n_bits": self.n_bits,
            "pool": self.pool,
            "store_dtype": _DTYPE_NAMES[self.store_dtype],
            "recall_target": self.recall_target,
            "seed": self.seed,
            "stage1": self.stage1,
        }
        if self.prefilter == "int8x8":
            snap["scales"] = self._scales[:size].clone()
        snap.update(self._stage1_snapshot())
        if self._codes_index is not None:
            ci = self._codes_index
            snap["codes_packed_t"] = ci._buf[: ci._t_used_rows()].clone()
            snap["codes_block_rows"] = ci.block_rows
        elif self._codes.dtype == torch.bfloat16:
            # sign and unit-norm codes round-trip through f16 unchanged in rank
            snap["codes_f16"] = self._codes[:size].to(torch.float16)
        else:
            snap["codes"] = self._codes[:size].clone()
        return snap

    @staticmethod
    def write_snapshot(snap: dict, path: str) -> None:
        """Phase 2: download the captured tensors in ~4 MB row blocks and
        write the npz. bf16 rows are stored as their raw uint16 bits
        (``buf_u16``), f32 rows as ``buf``."""
        snap = dict(snap)
        buf = snap.pop("buf")
        if buf.dtype == torch.bfloat16:
            snap["buf_u16"] = to_host_chunked(buf.view(torch.int16)).view(np.uint16)
        else:
            snap["buf"] = to_host_chunked(buf.float())
        for key in ("scales", "codes_packed_t", "codes_f16", "codes"):
            if key in snap:
                snap[key] = to_host_chunked(snap[key])
        np.savez(path, **snap)

    def save(self, path: str) -> None:
        self.write_snapshot(self.snapshot(), path)

    @classmethod
    def load(cls, path: str, capacity: Optional[int] = None, *, device,
             projection=None, **kw) -> "TwoStageIndex":
        """Restore a snapshot of either package, with its serving
        configuration; ``pool`` may be overridden. A 'binary' file must
        carry its SimHash projection (the port writes it) or be given one
        (``projection=``, e.g. ``weights.simhash_projection`` of the JAX
        index's); an explicit ``projection`` wins."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            prefilter = str(z["prefilter"])
            stage1_args = _stage1_load_args(z, path, projection)
            idx = cls(
                int(z["dim"]), capacity or int(z["capacity"]), device=device,
                metric=str(z["metric"]), prefilter=prefilter, n_bits=int(z["n_bits"]),
                pool=int(kw.pop("pool", int(z["pool"]))),
                store_dtype=_named_dtype(str(z["store_dtype"])),
                recall_target=float(z["recall_target"]), seed=int(z["seed"]),
                stage1=str(z["stage1"]) if "stage1" in z else "matmul", **stage1_args, **kw,
            )
            if "buf_u16" in z:  # bf16 rows as raw bit patterns
                buf = torch.from_numpy(z["buf_u16"].view(np.int16)).view(torch.bfloat16)
            else:
                buf = torch.from_numpy(z["buf"])
            n = buf.shape[0]
            if n > idx.capacity:
                raise ValueError(f"snapshot holds {n} rows > capacity {idx.capacity}")
            if not n:
                return idx
            idx._buf[:n] = buf.to(idx.device, idx.store_dtype)
            ci = idx._codes_index
            if ci is None:
                codes = (torch.from_numpy(z["codes_f16"]).to(torch.bfloat16)
                         if "codes_f16" in z else torch.from_numpy(z["codes"]))
                idx._codes[:n] = codes.to(idx.device)
            elif "codes_packed_t" in z:
                block_rows = (int(z["codes_block_rows"]) if "codes_block_rows" in z
                              else ci.block_rows)
                if block_rows != ci.block_rows:
                    raise ValueError(
                        f"pack block mismatch: snapshot {block_rows} vs {ci.block_rows}")
                words = torch.from_numpy(z["codes_packed_t"])
                ci._buf[: words.shape[0]] = words.to(idx.device)
                ci.size = n
            else:  # legacy row-major packed codes
                ci.add(hamming.unpack_bits_np(z["codes_packed"], ci.n_bits))
            if prefilter == "int8x8":
                idx._scales[:n] = torch.from_numpy(
                    np.asarray(z["scales"], np.float32)).to(idx.device)
        idx.size = n
        return idx


class ShardedTwoStageIndex(_ShardedRows, _StageOne):
    """Two-stage serving over a corpus row-sharded across a mesh axis
    (JAX ``index/twostage.py:535``).

    The full-width rows and their stage-1 codes stripe across the mesh's
    ``axis`` as in ``ShardedDenseIndex``; each shard prefilters and
    re-ranks its own rows, and the per-shard [q, k] candidates merge
    (``parallel.collectives.sharded_twostage_topk``). Every prefilter of
    :class:`TwoStageIndex` ('binary' / 'itq' x stage1 'matmul' / 'packed',
    'int8x8', 'pca'); ``pool`` counts candidates PER SHARD. With
    ``stage1='packed'`` each shard keeps its codes transposed-packed
    ([shard_rows / 32, bits_pad] int32, ``BinaryIndex`` layout per shard),
    so the shard rows must be whole 2048-slot pack blocks. ``score_dtype``
    rounds the re-rank scores (f32: exact). Ids are STABLE global
    insertion-order ids. ``projection`` as in :class:`TwoStageIndex`; the
    parameters live on the first local shard's device.
    """

    def __init__(
        self,
        dim: int,
        capacity: int,
        mesh: Mesh,
        axis: str = "data",
        metric: str = "cos",
        prefilter: str = "binary",
        n_bits: int = 256,
        pool: int = 512,
        store_dtype: torch.dtype = torch.bfloat16,
        recall_target: float = 0.95,
        score_dtype: torch.dtype = torch.float32,
        projector=None,
        seed: int = 0,
        stage1: str = "matmul",
        projection=None,
    ):
        _check_args(metric, prefilter, stage1, projector)
        check_selection("approx", recall_target)
        self._init_rows(mesh, axis, capacity)
        self.dim = dim
        self.metric = metric
        self.prefilter = prefilter
        self.pool = pool
        self.store_dtype = store_dtype
        self.recall_target = recall_target
        self.score_dtype = score_dtype
        self.seed = seed
        self.stage1 = stage1
        self.device = self._devices[0]
        n_bits = self._init_stage1(n_bits, projector, projection)
        # the stage-1 code width, as the JAX sharded index records it
        if prefilter == "pca":
            n_bits = self._proj_comp.shape[0]
        elif prefilter == "int8x8":
            n_bits = dim
        self.n_bits = n_bits
        self._buf = [torch.zeros((self.shard_rows, dim), dtype=store_dtype, device=d)
                     for d in self._devices]
        self._scales = None
        if stage1 == "packed":
            self.block_rows = hamming.TBLOCK
            self.bits_pad = -(-n_bits // 128) * 128
            if self.shard_rows % self.block_rows:
                raise ValueError(
                    f"stage1='packed' needs whole {self.block_rows}-slot pack blocks per "
                    f"shard; got shard_rows={self.shard_rows} (capacity {capacity} over "
                    f"{self.ndev} shards)")
            shape, dtype, fill = (self.shard_rows // 32, self.bits_pad), torch.int32, 0
        elif prefilter in ("binary", "itq"):
            shape, dtype, fill = (self.shard_rows, n_bits), torch.bfloat16, -1
        elif prefilter == "int8x8":
            shape, dtype, fill = (self.shard_rows, n_bits), torch.int8, 0
            self._scales = [torch.zeros(self.shard_rows, dtype=torch.float32, device=d)
                            for d in self._devices]
        else:
            shape, dtype, fill = (self.shard_rows, n_bits), torch.bfloat16, 0
        self._codes = [torch.full(shape, fill, dtype=dtype, device=d) for d in self._devices]

    def _write(self, j: int, start: int, rows: torch.Tensor, codes: torch.Tensor,
               scales: Optional[torch.Tensor]) -> None:
        """Rows, their stage-1 codes (and int8 scales) into local shard j at
        ``start``; packed codes OR into the shard's words."""
        dev, m = self._devices[j], rows.shape[0]
        self._buf[j][start: start + m] = rows.to(dev, self.store_dtype)
        if self.stage1 == "packed":
            _t_or_bits(self._codes[j], codes.to(dev) > 0, start, self.block_rows)
        else:
            self._codes[j][start: start + m] = codes.to(dev, self._codes[j].dtype)
        if scales is not None:
            self._scales[j][start: start + m] = scales.to(dev)

    def add(self, emb) -> None:
        """Append [m, d]; m must divide by the shard count. Each shard
        normalizes ('cos') and encodes its own part. Rows keep global
        insertion-order ids."""
        emb = emb if isinstance(emb, torch.Tensor) else torch.as_tensor(np.asarray(emb))
        if emb.dim() != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"expected [m, {self.dim}] rows, got {tuple(emb.shape)}")
        m = emb.shape[0]
        per = self._stripe(m, "sharded two-stage index")
        for j, s in enumerate(self._local):
            x = emb[s * per: (s + 1) * per].to(self._devices[j], torch.float32)
            if self.metric == "cos":
                x = l2_normalize(x)
            codes, scales = self._encode(x)
            self._write(j, int(self._fill[s]), x, codes, scales)
            self._write_ids(j, s, per)
        self._commit_add(m, per)

    def remove_ids(self, gids) -> int:
        """Remove rows by GLOBAL id: each owning shard compacts swap-with-last
        across rows, codes (packed: code bits, and the freed slots zeroed)
        and scales together; surviving ids never change. Returns the rows
        removed."""
        def move(j, src, dst, new_fill, old_fill):
            if self.stage1 == "packed" and new_fill < old_fill:
                _t_move_bits(self._codes[j], src.cpu().numpy(), dst.cpu().numpy(),
                             new_fill, old_fill, self.block_rows)
            if src.numel():
                bufs = [self._buf, self._scales]
                if self.stage1 != "packed":
                    bufs.append(self._codes)
                for buf in bufs:
                    if buf is not None:
                        buf[j][dst] = buf[j][src]

        return self._remove(gids, move)

    def reconstruct_batch(self, gids) -> np.ndarray:
        """Full-width stored rows by GLOBAL id, [m, d] float32 in the order
        given; absent ids raise KeyError."""
        return self._rows_by_id(gids, self.dim, lambda j, slots: self._buf[j][slots])

    def reconstruct(self, gid: int) -> np.ndarray:
        return self.reconstruct_batch([int(gid)])[0]

    def search(self, queries, k: int, pool: Optional[int] = None, row_mask=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Global exact-over-pool top-k: (D [q, k] float32 descending, I [q,
        k] int64 global ids); missing slots (-inf, -1). ``pool``: stage-1
        candidates per shard (at least ``k``, at most the shard's rows).
        ``row_mask``: optional bool array keyed by GLOBAL id, applied inside
        each shard's stage 1."""
        pool = min(max(pool or self.pool, k), self.shard_rows)
        q = torch.as_tensor(queries if isinstance(queries, torch.Tensor)
                            else np.asarray(queries)).to(self.device, torch.float32)
        if q.dim() != 2 or q.shape[1] != self.dim:
            raise ValueError(f"expected [q, {self.dim}] queries, got {tuple(q.shape)}")
        qn = l2_normalize(q) if self.metric == "cos" else q
        q_codes, q_scales = self._encode(qn)
        packed_bits = None
        if self.stage1 == "packed":
            packed_bits = self.n_bits
            q_codes = torch.nn.functional.pad(q_codes, (0, self.bits_pad - self.n_bits))
        vals, ids = sharded_twostage_topk(
            qn.to(self.store_dtype), q_codes.contiguous(), self._buf, self._codes, k,
            self.mesh, axis=self.axis, shard_ids=self._ids, valid_per_shard=self._fill,
            pool=pool, recall_target=self.recall_target, score_dtype=self.score_dtype,
            code_scales=self._scales, q_code_scales=q_scales,
            row_mask=self._slot_masks(row_mask), packed_bits=packed_bits,
        )
        return vals.cpu().numpy(), ids.cpu().numpy()

    # --- persistence: the JAX index's npz, key for key (+ 'projection')
    def save(self, path: str) -> None:
        """npz of every shard's rows (as f32) and codes (packed words;
        int8 codes and scales; else f16), ids, fills and the serving
        configuration. On a mesh that spans processes every rank takes
        part and rank 0 writes."""
        if self.stage1 == "packed":
            extra = {"codes_packed_t": self._host(self._codes), "block_rows": self.block_rows}
        elif self.prefilter == "int8x8":
            extra = {"codes": self._host(self._codes), "scales": self._host(self._scales)}
        else:
            # sign codes and unit-norm projections round-trip through f16
            extra = {"codes_f16": self._host(self._codes).astype(np.float16)}
        buf, ids = self._host(self._buf).astype(np.float32), self._host(self._ids)
        if self.mesh.rank:
            return
        np.savez(
            path, buf=buf, ids=ids.astype(np.int32), size=self.size, fills=self._fill,
            next_id=self._next_id, dim=self.dim, capacity=self.capacity, ndev=self.ndev,
            metric=self.metric, prefilter=self.prefilter, n_bits=self.n_bits, pool=self.pool,
            store_dtype=_DTYPE_NAMES[self.store_dtype], recall_target=self.recall_target,
            score_dtype=_DTYPE_NAMES[self.score_dtype], seed=self.seed, stage1=self.stage1,
            **self._stage1_snapshot(), **extra,
        )

    @classmethod
    def load(cls, path: str, mesh: Mesh, projection=None, **kw) -> "ShardedTwoStageIndex":
        """Restore a snapshot of either package on ``mesh``; the rows are
        re-striped in insertion order, evenly over its shards (packed codes
        unpack per saved shard and pack again). ``capacity`` and ``pool``
        may be overridden; ``projection`` as in :meth:`TwoStageIndex.load`."""
        with _load_npz(path) as z:
            prefilter = str(z["prefilter"]) if "prefilter" in z else "binary"
            idx = cls(
                dim=int(z["dim"]), capacity=int(kw.pop("capacity", int(z["capacity"]))),
                mesh=mesh, metric=str(z["metric"]), prefilter=prefilter,
                n_bits=int(z["n_bits"]), pool=int(kw.pop("pool", int(z["pool"]))),
                store_dtype=_named_dtype(str(z["store_dtype"])),
                recall_target=float(z["recall_target"]),
                score_dtype=_named_dtype(str(z["score_dtype"])), seed=int(z["seed"]),
                stage1=str(z["stage1"]) if "stage1" in z else "matmul",
                **_stage1_load_args(z, path, projection), **kw,
            )
            size = int(z["size"])
            # ids stay issued when every row was removed
            idx._next_id = int(z["next_id"]) if "next_id" in z else size
            if not size:
                return idx
            if size % idx.ndev:
                raise ValueError(
                    f"snapshot holds {size} rows, not divisible across {idx.ndev} shards")
            saved_ndev = int(z["ndev"])
            fills = (np.asarray(z["fills"], np.int64) if "fills" in z
                     else np.full(saved_ndev, size // saved_ndev, np.int64))
            flat_ids = _restripe(z, "ids", saved_ndev, fills, slice(None))
            order = np.argsort(flat_ids)  # insertion order
            if "codes_packed_t" in z:
                br = int(z["block_rows"])
                s_rows = br // 32
                words = np.asarray(z["codes_packed_t"])
                words = words.reshape(saved_ndev, -1, words.shape[1])
                codes = np.concatenate([
                    hamming.unpack_bits_t_np(words[s, : -(-int(fills[s]) // br) * s_rows], br)
                    [: fills[s]] for s in range(saved_ndev)])[order]
            else:
                codes = _restripe(z, "codes" if "codes" in z else "codes_f16", saved_ndev,
                                  fills, order, idx._codes[0].shape[1])
            rows = _restripe(z, "buf", saved_ndev, fills, order, idx.dim)
            scales = (_restripe(z, "scales", saved_ndev, fills, order)
                      if prefilter == "int8x8" else None)
        ids = flat_ids[order].astype(np.int64)
        per = size // idx.ndev
        for j, s in enumerate(idx._local):
            part = slice(s * per, (s + 1) * per)
            idx._write(j, 0, torch.from_numpy(rows[part]), torch.from_numpy(codes[part]),
                       None if scales is None else torch.from_numpy(scales[part]))
            idx._ids[j][:per] = torch.from_numpy(ids[part]).to(idx._devices[j])
        idx._set_even_fill(ids)
        return idx


def build_twostage_index(
    emb,
    prefilter: str = "binary",
    pca_dim: int = 64,
    metric: str = "cos",
    *,
    device,
    **kw,
) -> TwoStageIndex:
    """One-shot construction from a full corpus [n, d] (numpy or tensor).
    For 'pca' / 'itq' the projector is fitted on the corpus itself
    (``fit_pca`` / ``fit_itq`` on the L2-normalized rows under 'cos', as
    indexed); 'itq' fits ``n_bits`` directions (kw ``n_bits``, default
    256)."""
    dev = resolve_device(device)
    emb = torch.as_tensor(np.asarray(emb, np.float32) if not isinstance(emb, torch.Tensor)
                          else emb).to(dev, torch.float32)
    projector = None
    if prefilter in ("pca", "itq"):
        rows = l2_normalize(emb) if metric == "cos" else emb
        d = emb.shape[1]
        projector = (fit_pca(rows, min(pca_dim, d)) if prefilter == "pca"
                     else fit_itq(rows, min(int(kw.get("n_bits", 256)), d)))
    idx = TwoStageIndex(emb.shape[1], emb.shape[0], device=dev, metric=metric,
                        prefilter=prefilter, projector=projector, **kw)
    idx.add(emb)
    return idx
