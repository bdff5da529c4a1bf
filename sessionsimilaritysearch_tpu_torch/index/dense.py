"""The dense session-embedding index (counterpart of
``sessionsimilaritysearch_tpu/index/dense.py``: ``DenseIndex`` :151,
``compaction_plan`` :58, ``_range_from_search`` :104, ``to_host_chunked``
:41, ``build_index`` :586).

The index IS the corpus: a fixed-capacity [capacity, dim] device buffer that
streaming adds append into. ``search`` scans the filled rows in
``chunk_size`` slices and merges the per-chunk top-k
(``ops/topk.py`` ``chunked_topk``, with the index's selection ``mode``), so
the score buffer stays [q, chunk_size] whatever the corpus size. The scan
of each chunk:

- float rows (f32 or bf16): the fused score + bucket-max kernel K1
  (``ops/mips.py``: ``csrc/scores_bmax_f32_sm90.cu`` for f32,
  ``csrc/scores_bmax_sm90.cu`` for bf16, fed by TMA or, for rows TMA
  cannot describe, by ``cp.async``; ``csrc/scores_bmax.cu`` for the rest). ``metric='l2'`` runs K1 too, through its per-row
  penalty: the kernel scores (2q)·c − |c|², with |c|² kept per row beside
  the buffer, and the squared distance is |q|² minus that score (|q|² is
  one number per query, so it changes no ranking);
- ``quantize='int8x8'`` (int8 codes on both sides): the int8 kernel K2
  (``ops/mips_int8.py``: ``csrc/scores_bmax_int8_sm90.cu`` or
  ``csrc/scores_bmax_int8.cu``);
- ``quantize='int8'`` (bf16 queries, int8 rows): torch ops, as the JAX
  package leaves it to XLA.

The maintenance verbs (``remove_ids``, ``merge_from``) and the snapshots
(``snapshot`` / ``write_snapshot`` / ``save`` / ``load``) follow the JAX
index. The npz snapshot is the JAX package's, key for key, so each package
loads the other's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.ops import mips_int8
from sessionsimilaritysearch_tpu_torch.ops.topk import chunked_topk, check_selection, l2_normalize
from sessionsimilaritysearch_tpu_torch.utils.profiling import trace

_DTYPES = (torch.float32, torch.bfloat16)
# dtype names as the snapshots store them (the JAX package's ``dtype.name``)
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8"}
_NAMED_DTYPES = {name: dtype for dtype, name in _DTYPE_NAMES.items()}


def _named_dtype(name: str) -> torch.dtype:
    if name not in _NAMED_DTYPES:
        raise ValueError(f"snapshot dtype {name!r} is none of {sorted(_NAMED_DTYPES)}")
    return _NAMED_DTYPES[name]


def to_host_chunked(a: torch.Tensor, max_bytes: int = 4 << 20) -> np.ndarray:
    """Device -> host copy in row blocks of ~``max_bytes``. Each block is its
    own transfer on the stream, so a search enqueued while a background
    snapshot writer downloads a multi-GB buffer waits for one block, not
    for the whole copy. ``a`` must have a numpy dtype (view bf16 as int16)."""
    if a.dim() == 0 or a.numel() * a.element_size() <= max_bytes:
        return a.cpu().numpy()
    rows = max(1, max_bytes // max(a[0].numel() * a.element_size(), 1))
    out = torch.empty(a.shape, dtype=a.dtype)
    for s in range(0, a.shape[0], rows):
        out[s: s + rows] = a[s: s + rows]
    return out.numpy()


def compaction_plan(size: int, ids) -> Tuple[np.ndarray, np.ndarray, int]:
    """Swap-with-last removal plan over a [0, size) row range.

    Removing ``ids`` compacts the survivors into [0, new_size) by moving
    each surviving tail row (>= new_size) into a removed slot below
    new_size — O(#removed) moves, no full-buffer rewrite, and row order
    outside the moved set is untouched. Returns (src, dst, new_size):
    equal-length int32 arrays such that after ``buf[dst] = buf[src]`` the
    first new_size rows are exactly the survivors. This is the counterpart
    of FAISS ``remove_ids`` renumbering semantics (the reference's flat
    indexes, fine_tune_ours.py:844-849): surviving rows move ids.
    """
    ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
    if ids.size == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), size
    if ids[0] < 0 or ids[-1] >= size:
        raise ValueError(
            f"remove ids must lie in [0, {size}); got range "
            f"[{ids[0]}, {ids[-1]}]"
        )
    new_size = size - ids.size
    holes = ids[ids < new_size]
    tail_survivors = np.setdiff1d(
        np.arange(new_size, size, dtype=np.int64), ids, assume_unique=True
    )
    return (
        tail_survivors.astype(np.int32),
        holes.astype(np.int32),
        int(new_size),
    )


def positional_mask(row_mask, size: int, capacity: int, device) -> torch.Tensor:
    """A positional bool row mask (length ``size`` or ``capacity``, numpy or
    tensor) as a bool tensor over the rows [0, size) on ``device``."""
    mask = torch.as_tensor(row_mask, device=device)
    if mask.dim() != 1 or mask.shape[0] not in (size, capacity):
        raise ValueError(
            f"row_mask length {tuple(mask.shape)} matches neither size "
            f"{size} nor capacity {capacity}"
        )
    return mask[:size].to(torch.bool)


def _range_from_search(
    search_fn, nq: int, radius: float, *, descending: bool,
    total: int, k0: int = 128,
):
    """Exact range search built on adaptive-depth top-k: run the fixed-shape
    top-k scan and DOUBLE the depth until every query's k-th result falls
    outside the radius (or depth reaches the corpus). Returns FAISS's CSR
    convention ``(lims [nq+1], D, I)`` with each query's slice
    ``D[lims[i]:lims[i+1]]`` sorted best-first (FAISS leaves slices
    unordered; sorted is strictly stronger).
    """
    if total == 0 or nq == 0:
        return (
            np.zeros(nq + 1, np.int64),
            np.zeros(0, np.float32),
            np.zeros(0, np.int64),
        )
    k = min(max(8, k0), total)
    while True:
        d, i = search_fn(k)
        ok = (i >= 0) & (d >= radius if descending else d <= radius)
        # a fully-within-radius result row means the radius set may extend
        # past this depth -- double and rescan (exactness over latency)
        if k >= total or not ok.all(axis=1).any():
            break
        k = min(k * 2, total)
    lims = np.zeros(nq + 1, np.int64)
    np.cumsum(ok.sum(axis=1), out=lims[1:])
    return lims, d[ok], i[ok].astype(np.int64)


class DenseIndex:
    """Flat exact index over a dense embedding corpus.

    metric: 'cos' (rows L2-normalized on add, queries on search, both in
    the storage dtype), 'ip' (raw inner product) or 'l2' (squared L2
    distance, ascending). ``dtype`` is the storage dtype (float32 or
    bfloat16); ``score_dtype`` the dtype the kernel stores scores in
    (float32 = exact ranking; bfloat16 = exact at bf16 precision). Search
    results follow ``faiss.Index.search``: scores descending ('l2':
    distances ascending), missing slots (-inf, -1) ('l2': (+inf, -1)).

    quantize: None, 'int8' or 'int8x8' (JAX ``index/dense.py:188-192``).
    Rows are stored as per-row int8 codes and an f32 scale (normalized in
    f32 first under 'cos'), and ``dtype`` is not used. 'int8' scores bf16
    queries against the codes; 'int8x8' quantizes the queries per row too
    and runs the int8 kernel K2. Ranking is exact over the dequantized
    rows (and, for 'int8x8', the dequantized query codes). Not with 'l2'.

    center ('cos' only): rank by centered cosine -- subtract a mean
    direction from every normalized row and query and normalize again. Pass
    an explicit [d] mean, or 'auto' to fit it from the first added batch
    (frozen thereafter: rows are stored in centered form).

    mode: the per-chunk selection of ``ops.topk.chunked_topk`` -- 'exact'
    (bucketed), 'sort', or 'approx' / 'exact_cert', which run the exact
    selection on the GPU. Kept in snapshots. ``range_search`` refuses
    'approx', as the JAX index does.
    """

    def __init__(
        self,
        dim: int,
        capacity: int,
        *,
        device,
        metric: str = "cos",
        dtype: torch.dtype = torch.float32,
        chunk_size: int = 65536,
        mode: str = "exact",
        score_dtype: torch.dtype = torch.float32,
        quantize: Optional[str] = None,
        center=None,
    ):
        check_selection(mode, 0.95)
        if metric not in ("cos", "ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        if quantize not in (None, "int8", "int8x8"):
            raise ValueError(f"unknown quantize {quantize!r}")
        if quantize is not None and metric == "l2":
            raise ValueError("an int8 corpus supports 'ip'/'cos' only")
        if center is not None and metric != "cos":
            raise ValueError("center= is defined for the 'cos' metric only")
        if isinstance(center, str) and center != "auto":
            raise ValueError(f"unknown center mode {center!r}")
        if dtype not in _DTYPES or score_dtype not in _DTYPES:
            raise TypeError(
                f"dtype and score_dtype must be float32 or bfloat16, got "
                f"{dtype} and {score_dtype}"
            )
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        self.dim = dim
        self.capacity = capacity
        self.metric = metric
        self.quantize = quantize
        self.dtype = torch.int8 if quantize else dtype
        self.score_dtype = score_dtype
        self.chunk_size = chunk_size
        self.mode = mode
        self.device = resolve_device(device)
        self._buf = torch.zeros((capacity, dim), dtype=self.dtype, device=self.device)
        # per-row dequantization scales (int8 modes): row ~= code * scale
        self._scales = (torch.zeros(capacity, dtype=torch.float32, device=self.device)
                        if quantize else None)
        # per-row |c|^2 in f32 ('l2'): K1's penalty is its negative. Kept
        # beside the rows so that a search makes no extra pass over them
        self._sqnorm = (torch.zeros(capacity, dtype=torch.float32, device=self.device)
                        if metric == "l2" else None)
        self.center_mode = (None if center is None
                            else "auto" if isinstance(center, str) else "fixed")
        self._center = (
            torch.as_tensor(center, dtype=torch.float32, device=self.device).reshape(dim)
            if self.center_mode == "fixed" else None  # 'auto': fitted by the first add
        )
        self.size = 0

    @property
    def ntotal(self) -> int:  # FAISS-compatible name
        return self.size

    def _as_rows(self, x, dtype: torch.dtype) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=dtype)
        if x.dim() != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected [m, {self.dim}] rows, got {tuple(x.shape)}")
        return x

    def _centered(self, x: torch.Tensor) -> torch.Tensor:
        """Centered-cosine transform of unit rows: normalize(x - mean)."""
        return l2_normalize(x - self._center)

    def add(self, emb) -> None:
        """Append embeddings [m, d] (numpy or tensor); under 'cos' rows are
        normalized first, in the storage dtype (f32 when quantized), and
        centered when ``center`` is set."""
        emb = self._as_rows(emb, torch.float32 if self.quantize else self.dtype)
        m = emb.shape[0]
        if self.size + m > self.capacity:
            raise ValueError(
                f"index full: {self.size}+{m} > capacity {self.capacity}"
            )
        if m == 0:
            return
        if self.metric == "cos":
            emb = l2_normalize(emb)
            if self.center_mode == "auto" and self._center is None:
                self._center = emb.mean(dim=0)
            if self._center is not None:
                emb = self._centered(emb)
        scales = None
        if self.quantize:
            emb, scales = mips_int8.quantize_rows_int8(emb)
        self._append(emb, scales)

    def _append(self, rows: torch.Tensor, scales: Optional[torch.Tensor]) -> None:
        """Write rows already in stored form (and their int8 scales) at
        ``size``; under 'l2' their |c|^2 too. ``size`` grows last, after the
        writes are enqueued: a search that reads it on another thread scans
        only rows the stream has written before its own kernels."""
        start, end = self.size, self.size + rows.shape[0]
        rows = rows.to(device=self.device, dtype=self.dtype)
        self._buf[start:end] = rows
        if scales is not None:
            self._scales[start:end] = scales.to(self.device)
        if self._sqnorm is not None:
            r = rows.float()
            self._sqnorm[start:end] = (r * r).sum(dim=1)
        self.size = end

    def remove_ids(self, ids) -> int:
        """Remove rows by position (``faiss.Index.remove_ids``): surviving tail
        rows move into the freed slots as :func:`compaction_plan` says, so
        the remaining row ids change exactly as in FAISS; callers holding
        row-aligned metadata must apply the same plan
        (``SessionSearchEngine.remove_sessions`` does). The rows, their int8
        scales and their |c|^2 move together in one indexed copy each
        (src >= new_size > dst, so a move never reads a slot another one
        writes). Returns the number of rows removed."""
        src, dst, new_size = compaction_plan(self.size, ids)
        if src.size:
            s = torch.from_numpy(src.astype(np.int64)).to(self.device)
            d = torch.from_numpy(dst.astype(np.int64)).to(self.device)
            for buf in (self._buf, self._scales, self._sqnorm):
                if buf is not None:
                    buf[d] = buf[s]
        removed = self.size - new_size
        self.size = new_size
        return removed

    def _stored_rows(self, ids) -> torch.Tensor:
        """Stored rows by position as f32 [m, d] on the index's device."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.size):
            raise IndexError(f"reconstruct ids must lie in [0, {self.size})")
        pos = torch.from_numpy(ids).to(self.device)
        rows = self._buf[pos].float()
        if self.quantize:
            rows *= self._scales[pos][:, None]
        return rows

    def reconstruct_batch(self, ids) -> np.ndarray:
        """Stored rows by position, [m, d] float32, exactly as the index
        scores them (unit-normalized under 'cos', centered when ``center``
        is set; code x scale when quantized)."""
        return self._stored_rows(ids).cpu().numpy()

    def reconstruct(self, i: int) -> np.ndarray:
        """Single-row form (``faiss.Index.reconstruct``): [d] float32;
        ``i`` outside [0, size) raises ``IndexError``."""
        return self.reconstruct_batch([int(i)])[0]

    def _penalty(self, row_mask, size: int) -> Optional[torch.Tensor]:
        """The kernel's additive per-row penalty over rows [0, size), or None:
        -|c|^2 under 'l2' and -inf where ``row_mask`` (a bool mask of length
        ``size`` or ``capacity``) is False."""
        pen = None if self._sqnorm is None else -self._sqnorm[:size]
        if row_mask is None:
            return pen
        mask = positional_mask(row_mask, size, self.capacity, self.device)
        if pen is None:
            pen = torch.zeros(size, dtype=torch.float32, device=self.device)
        return torch.where(mask, pen, float("-inf")).contiguous()

    def search(self, queries, k: int, row_mask=None, out: str = "np"):
        """Exact top-k over the filled rows. Returns (D [q, k] float32, I
        [q, k] int64): numpy arrays for ``out='np'``, tensors on the index's
        device for ``out='device'``. ``row_mask``: optional bool array over
        the rows (length ``size`` or ``capacity``); rows where it is False
        never rank. The scan covers rows [0, size) only, with ``size`` read
        once: rows past it would all score -inf, and rows a concurrent add
        writes meanwhile are not part of this search."""
        if out not in ("np", "device"):
            raise ValueError(f"out must be 'np' or 'device', got {out!r}")
        size = self.size
        qdtype = torch.bfloat16 if self.quantize else self.dtype
        queries = self._as_rows(queries, qdtype)
        if self.metric == "cos":
            if self._center is not None:
                queries = self._centered(l2_normalize(queries.float())).to(qdtype)
            else:
                queries = l2_normalize(queries).to(qdtype)
        sq_queries = None
        if self.metric == "l2":
            q32 = queries.float()
            sq_queries = (q32 * q32).sum(dim=1, keepdim=True)
            queries = queries * 2  # exact: K1 scores (2q).c - |c|^2
        queries = queries.contiguous()
        q_scales = None
        if self.quantize == "int8x8":
            queries, q_scales = mips_int8.quantize_rows_int8(queries)
        vals, idx = chunked_topk(
            queries, self._buf[:size], k, chunk_size=self.chunk_size, mode=self.mode,
            score_dtype=self.score_dtype,
            corpus_scales=self._scales[:size] if self.quantize else None,
            query_scales=q_scales, penalty=self._penalty(row_mask, size),
        )
        if sq_queries is not None:
            vals = sq_queries - vals  # ascending squared distances; missing +inf
        if out == "device":
            return vals, idx
        with trace("sss.index.to_host"):
            return vals.cpu().numpy(), idx.cpu().numpy()

    def range_search(self, queries, radius: float, k0: int = 128, row_mask=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All rows within ``radius`` of each query
        (``faiss.Index.range_search``). Returns FAISS's CSR triple ``(lims
        [q+1] int64, D, I)``: query ``i``'s neighbours are
        ``I[lims[i]:lims[i+1]]``, sorted best-first. 'cos'/'ip' keep rows
        with score >= radius, 'l2' squared distance <= radius. Exact: a
        top-k whose depth doubles from ``k0`` until each query's deepest
        hit falls outside the radius. ``row_mask`` as in :meth:`search`.
        Refused under ``mode='approx'``, as in the JAX index: an approximate
        top-k may drop rows inside the radius."""
        if self.mode == "approx":
            raise ValueError(
                "range_search needs an exact selection mode: approx top-k can "
                "silently drop in-radius rows"
            )
        if not isinstance(queries, torch.Tensor):
            queries = np.asarray(queries)
        return _range_from_search(
            lambda k: self.search(queries, k, row_mask=row_mask),
            queries.shape[0], radius,
            descending=self.metric != "l2", total=self.size, k0=k0,
        )

    def merge_from(self, other: "DenseIndex") -> int:
        """Append ``other``'s stored rows (``faiss.Index.merge_from``):
        ``other``'s row ids shift by ``self.ntotal``, and ``other`` is left
        intact. Requires the same dim, metric and quantize, and the same
        center transform (rows are stored transformed); an unfitted
        ``center='auto'`` index adopts ``other``'s fitted mean. Returns the
        row count appended."""
        if not isinstance(other, DenseIndex):
            raise TypeError(f"merge_from takes a DenseIndex, got {type(other).__name__}")
        if (self.dim, self.metric, self.quantize) != (other.dim, other.metric, other.quantize):
            raise ValueError(
                "merge_from requires identical dim/metric/quantize: "
                f"({self.dim},{self.metric},{self.quantize}) vs "
                f"({other.dim},{other.metric},{other.quantize})"
            )
        if self.size + other.size > self.capacity:
            raise ValueError(f"index full: {self.size}+{other.size} > {self.capacity}")
        if self._center is None and other._center is not None:
            if self.center_mode == "auto" and self.size == 0:
                self._center = other._center.to(self.device)
            else:
                raise ValueError("center transform mismatch")
        elif (self._center is None) != (other._center is None) or (
            self._center is not None
            and not torch.allclose(self._center.float().cpu(), other._center.float().cpu())
        ):
            raise ValueError("center transform mismatch")
        n = other.size
        if n:
            self._append(other._buf[:n], other._scales[:n] if self.quantize else None)
        return n

    # --- persistence (reference: faiss.write_index/read_index)
    def snapshot(self) -> dict:
        """Phase 1 of a two-phase save: a point-in-time copy of the serving
        state. The rows (and scales) are CLONED on the device: ``add`` and
        ``remove_ids`` write the live buffer in place, so a view would be
        overwritten by the next compaction. |c|^2 is not part of it: load
        rebuilds it from the rows. Pair with :meth:`write_snapshot` on
        another thread so that a save never blocks serving."""
        size = self.size
        snap = {
            "buf": self._buf[:size].clone(),
            "dtype": _DTYPE_NAMES[self.dtype],
            "metric": self.metric,
            "dim": self.dim,
            "capacity": self.capacity,
            "mode": self.mode,
            "score_dtype": _DTYPE_NAMES[self.score_dtype],
            "chunk_size": self.chunk_size,
        }
        if self.quantize:
            snap["scales"] = self._scales[:size].clone()
            snap["quantize"] = self.quantize
        if self._center is not None:
            snap["center"] = self._center.float().cpu().numpy()
        if self.center_mode is not None:
            snap["center_mode"] = self.center_mode
        return snap

    @staticmethod
    def write_snapshot(snap: dict, path: str) -> None:
        """Phase 2: download the captured tensors in ~4 MB row blocks and
        write the npz (``.npz`` is appended to ``path`` unless it has it).
        bf16 rows are stored as their raw uint16 bits (``buf_u16``), as the
        JAX package stores them."""
        snap = dict(snap)
        buf = snap.pop("buf")
        if buf.dtype == torch.bfloat16:
            snap["buf_u16"] = to_host_chunked(buf.view(torch.int16)).view(np.uint16)
        else:
            snap["buf"] = to_host_chunked(buf)
        if "scales" in snap:
            snap["scales"] = snap["scales"].cpu().numpy()
        np.savez(path, **snap)

    def save(self, path: str) -> None:
        self.write_snapshot(self.snapshot(), path)

    @classmethod
    def load(cls, path: str, capacity: Optional[int] = None, *, device, **kw
             ) -> "DenseIndex":
        """Restore a snapshot of either package, with its serving
        configuration (score_dtype, chunk_size, quantize, center). Keyword
        overrides win over the stored values; ``quantize`` cannot be
        overridden (the stored rows are codes already). The selection
        ``mode`` travels with the snapshot."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            if "buf_u16" in z:  # bf16 rows as raw bit patterns
                buf = torch.from_numpy(z["buf_u16"].view(np.int16)).view(torch.bfloat16)
            else:
                buf = torch.from_numpy(z["buf"])
            quantize = str(z["quantize"]) if "quantize" in z else None
            if "quantize" in kw and kw.pop("quantize") != quantize:
                raise ValueError(
                    f"snapshot was saved with quantize={quantize!r}; stored rows "
                    "are already in that storage form and cannot be re-quantized"
                )
            kw.setdefault("mode", str(z["mode"]) if "mode" in z else "exact")
            kw.setdefault("score_dtype", _named_dtype(str(z["score_dtype"]))
                          if "score_dtype" in z else torch.float32)
            kw.setdefault("chunk_size", int(z["chunk_size"]) if "chunk_size" in z else 65536)
            if "dtype" in z and not quantize:
                kw.setdefault("dtype", _named_dtype(str(z["dtype"])))
            if "center" in z:
                # rows are stored centered already; the mean transforms queries
                # (and stays frozen under 'auto')
                kw.setdefault("center", np.asarray(z["center"], np.float32))
            idx = cls(int(z["dim"]), capacity or int(z["capacity"]), device=device,
                      metric=str(z["metric"]), quantize=quantize, **kw)
            if "center_mode" in z:
                idx.center_mode = str(z["center_mode"])
            scales = torch.from_numpy(np.asarray(z["scales"], np.float32)) if quantize else None
        if buf.shape[0] > idx.capacity:
            raise ValueError(f"snapshot holds {buf.shape[0]} rows > capacity {idx.capacity}")
        if buf.shape[0]:
            idx._append(buf, scales)
        return idx


def build_index(
    emb,
    metric: str = "cos",
    chunk_size: int = 65536,
    quantize: Optional[str] = None,
    center=None,
    *,
    device,
) -> DenseIndex:
    """One-shot construction from a full corpus [n, d] (numpy or tensor);
    ``center='auto'`` fits the mean from the whole corpus."""
    if not isinstance(emb, torch.Tensor):
        emb = np.asarray(emb)
    index = DenseIndex(emb.shape[1], emb.shape[0], device=device, metric=metric,
                       chunk_size=chunk_size, quantize=quantize, center=center)
    index.add(emb)
    return index
