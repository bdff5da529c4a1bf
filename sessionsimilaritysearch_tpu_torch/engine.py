"""SessionSearchEngine: the serving facade (counterpart of
``sessionsimilaritysearch_tpu/engine.py:151``).

Encode sessions with the encoder, keep the embedding corpus on the device
(a flat ``DenseIndex``, or a two-stage ``TwoStageIndex``; with ``mesh=``
their sharded twins ``ShardedDenseIndex`` and ``ShardedTwoStageIndex``,
row-sharded over the mesh's shards), stream-insert new sessions (on the
caller's thread or a background one), answer top-k queries (deduplicated,
filtered by a session predicate, or re-ranked by fusing the dense score
with an item-overlap or STAN cosine), answer radius queries, remove
sessions by id, content or age, save the serving state and restore it, and
report timing counters.

The per-row metadata and its helpers (``_item_set``, ``_overlap_cos``,
``_item_stan_weights``, ``_session_key``, ``_GrowArr``, ``SaveHandle``, the
metadata compaction, ``_hybrid_rerank``, ``_dedup_topk``, ``_where_mask``)
are copied from the JAX engine, where they are plain Python/numpy in a
module that imports JAX. A snapshot is the JAX engine's: the index's npz
and a ``.sessions.pkl`` with the same keys, so each package restores the
other's dense and two-stage engine snapshots, sharded ones included (a JAX
``'binary'`` two-stage one given the SimHash projection, see
``index/twostage.py``).

A sharded engine keeps stable global ids, as in JAX: sessions go in whole
stripes of the shard count (the remainder waits in ``pending``), and a
removal leaves a tombstone (``_removed``) in the per-row metadata, which
stays indexed by global id, where the single-device engine compacts it.
"""

from __future__ import annotations

import math
import pickle
import queue as queue_mod
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.config import Config
from sessionsimilaritysearch_tpu_torch.data.schema import Action
from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.evalharness import metrics as metrics_mod
from sessionsimilaritysearch_tpu_torch.evalharness.harness import EmbeddingPipeline
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex, compaction_plan
from sessionsimilaritysearch_tpu_torch.index.sharded import ShardedDenseIndex
from sessionsimilaritysearch_tpu_torch.index.twostage import ShardedTwoStageIndex, TwoStageIndex
from sessionsimilaritysearch_tpu_torch.ops.hamming import TBLOCK
from sessionsimilaritysearch_tpu_torch.ops.topk import check_selection
from sessionsimilaritysearch_tpu_torch.utils.profiling import PhaseTimer, counters, trace


def _item_set(sess) -> frozenset:
    """Distinct product ids of a session (schema.get_item)."""
    return frozenset(a[-1] for a in sess if a[1] != "s")


def _overlap_cos(a: frozenset, b: frozenset) -> float:
    """Cosine of the L2-normalized binary item-indicator vectors, computed
    set-wise: |A∩B| / sqrt(|A||B|) (test_amazon_filterd.py:48-57 without
    ever materializing asin_num-dim vectors)."""
    if not a or not b:
        return 0.0
    return len(a & b) / ((len(a) * len(b)) ** 0.5)


def _item_stan_weights(sess, lammy: float = 1.04) -> dict:
    """Per-distinct-item L2-normalized recency weights — STAN semantics
    (test_amazon_filterd.py:37-46) without materializing the asin_num-dim
    vector. The dot of two such dicts over shared keys IS the STAN
    cosine."""
    item_seq = [a for a in sess if a[1] != "s"]
    L = len(item_seq)
    acc: dict = {}
    for i, a in enumerate(item_seq):
        acc[a[-1]] = acc.get(a[-1], 0.0) + math.exp((i - L) / lammy)
    norm = math.sqrt(sum(w * w for w in acc.values()))
    if norm <= 0:
        return {}
    return {k: w / norm for k, w in acc.items()}


def _session_key(sess) -> tuple:
    """Hashable content digest of a session: (type, asin, text) per action —
    exactly the fields the graph transform reads, so two sessions with equal
    keys embed identically."""
    return tuple(
        (a[1], 0, a[2]) if a[1] == "s" else (a[1], int(a[-1]), a[-2])
        for a in sess
    )


def _session_of(d):
    """The stored session of a datum: the prefix of a (prefix, future) pair."""
    return d[0] if isinstance(d, tuple) and len(d) == 2 else d


class _GrowArr:
    """Append-only numpy array with amortized-doubling growth.

    ``view()`` snapshots are O(1), and removal compacts with one vectorized
    gather. Lock-free reader contract: writers hold the ingest lock;
    readers call ``view()``/``len()`` without it. ``_n`` is published AFTER
    the data is written, so ``view(len(self))`` is always a fully-written
    prefix. Growth swaps in a new backing array; readers holding the old
    one still see a consistent snapshot.
    """

    __slots__ = ("_a", "_n")

    def __init__(self, dtype, data=None):
        if data is not None:
            self._a = np.ascontiguousarray(data, dtype=dtype)
            self._n = len(self._a)
        else:
            self._a = np.empty(1024, dtype=dtype)
            self._n = 0

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        return self._a[: self._n][i]

    def __setitem__(self, i, v) -> None:
        self._a[: self._n][i] = v

    def view(self, n: int = None) -> np.ndarray:
        a = self._a  # snapshot the reference once (growth may swap it)
        if n is None:
            n = self._n
        return a[: min(n, len(a))]

    def append(self, v) -> None:
        self.extend((v,))

    def extend(self, vals) -> None:
        vals = np.asarray(list(vals) if not isinstance(vals, np.ndarray)
                          else vals, dtype=self._a.dtype)
        need = self._n + len(vals)
        if need > len(self._a):
            new = np.empty(max(need, 2 * len(self._a)), dtype=self._a.dtype)
            new[: self._n] = self._a[: self._n]
            self._a = new
        self._a[self._n: need] = vals
        self._n = need  # publish last: seals the write for lock-free reads


class SaveHandle:
    """Handle for an in-flight :meth:`SessionSearchEngine.save_async`.
    ``join()`` blocks until the snapshot is fully on disk and re-raises
    any writer error; ``done()`` polls without blocking."""

    def __init__(self, work: Callable):
        self._err: List[BaseException] = []

        def runner():
            try:
                work()
            except BaseException as e:  # surfaced on join()
                self._err.append(e)

        self._thread = threading.Thread(target=runner, daemon=True)

    def done(self) -> bool:
        return not self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)
        if self._err:
            raise self._err.pop(0)


# the Action class as either package pickles it; the port maps both to its
# own, so restoring a JAX snapshot never imports the JAX package
_ACTION_MODULES = ("sessionsimilaritysearch_tpu.data.schema",
                   "sessionsimilaritysearch_tpu_torch.data.schema")
_NUMPY_NAMES = ("_reconstruct", "_frombuffer", "ndarray", "dtype", "scalar")


class _SessionPickler(pickle.Pickler):
    """Writes every ``Action`` as a plain tuple, so that either package
    reads the file without importing the other."""

    def reducer_override(self, obj):
        if isinstance(obj, Action):
            return tuple, (tuple(obj),)
        return NotImplemented


class _SessionUnpickler(pickle.Unpickler):
    """Reads a ``.sessions.pkl`` of either package: the JAX package's
    ``Action`` becomes the port's, numpy arrays load, and every other class
    is refused."""

    def find_class(self, module, name):
        if name == "Action" and module in _ACTION_MODULES:
            return Action
        if (module, name) == ("builtins", "tuple") or (
                module.split(".")[0] == "numpy" and name in _NUMPY_NAMES):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} has no place in a sessions snapshot")


class SessionSearchEngine:
    """Encode-then-exact-search session similarity serving.

    Args:
      cfg: config (graph dims, ignore_query, retrieval defaults).
      tokenizer: host tokenizer.
      encode_fn: ``SessionGraph`` of tensors -> [B, d] embeddings, e.g. the
        port's ``GraphLevelEncoder``, or the flagship serving forward
        ``evalharness.harness.make_cached_encode_fn(serving_params(enc),
        title_table, query_table, kw_lookup)``; it is called under
        ``torch.inference_mode`` (see ``EmbeddingPipeline`` for its
        ``prepare`` hook).
      dim: embedding dimension.
      capacity: max corpus size.
      device: where the encoder runs and, without a mesh, the corpus lives
        ('cpu' or a CUDA device); required without ``mesh``, with no
        fallback; with one it defaults to the first local shard's device.
      metric: 'cos', 'ip' or 'l2' (the flat index only).
      mesh: a ``parallel.Mesh``: the corpus shards row-wise over its
        ``'data'`` axis (``ShardedDenseIndex``, or ``ShardedTwoStageIndex``
        with a prefilter); capacity rounds up to whole stripes (packed stage
        1: whole 2048-slot pack blocks per shard). Ids are stable global
        ids; a removal leaves a tombstone. Not with ``center`` or 'l2'.
      batch_size: encoder batch (the last batch is wrap-padded).
      mode: the top-k selection ('exact', 'approx', 'exact_cert' or
        'sort'). Accepted as the JAX engine accepts it, whose single-device
        ``DenseIndex`` is built without it (only its sharded index takes
        it): the flat index here selects exactly, as in JAX.
      quantize: None, 'int8' or 'int8x8' -- int8-code corpus storage in the
        flat ``DenseIndex`` (a quarter of the f32 corpus memory); 'int8x8'
        also quantizes the queries and scans through the int8 kernel K2.
        Not combined with a prefilter, which stores its own codes.
      prefilter: None (a flat ``DenseIndex``) or 'binary', 'itq', 'int8x8'
        or 'pca' -- two-stage serving (``index.twostage.TwoStageIndex``): a
        stage-1 top-``pool`` over codes, then an exact re-rank of the pool
        at full width. A two-stage engine removes, expires, saves and
        restores like a dense one; it has no range search (a pool has no
        radius semantics).
      pool: stage-1 candidates per query (two-stage mode).
      projector: fitted projector for ``prefilter='itq'`` or 'pca'
        (``ops.projection.fit_itq`` / ``fit_pca``, or the JAX package's).
      center: centered-cosine serving (the flat index only): a [dim] mean,
        or 'auto' to fit it from the first ingested batch.
      stage1: two-stage code scan of the 'binary' / 'itq' prefilters:
        'matmul' (+-1 bf16 codes, K1) or 'packed' (packed codes, K4).
      dtype: corpus storage dtype; None keeps each index's default (float32
        dense, bfloat16 for the two-stage full-width rows).
    """

    def __init__(
        self,
        cfg: Config,
        tokenizer,
        encode_fn: Callable,
        dim: int,
        capacity: int,
        *,
        device=None,
        metric: str = "cos",
        mesh=None,
        batch_size: int = 256,
        mode: str = "exact",
        quantize: Optional[str] = None,
        prefilter: Optional[str] = None,
        pool: int = 512,
        projector=None,
        center=None,
        stage1: str = "matmul",
        dtype: Optional[torch.dtype] = None,
    ):
        check_selection(mode, 0.95)
        if device is None:
            if mesh is None:
                raise TypeError("SessionSearchEngine needs device= (or mesh=)")
            device = mesh.shard_devices()[mesh.local_shards()[0]]
        self.cfg = cfg
        self.device = resolve_device(device)
        # with a mesh the index is sharded: stable global ids (tombstones in
        # place of compaction) and no device-side snapshot
        self._mesh = mesh
        # host seconds: nothing on the request path waits for the device
        self.timer = PhaseTimer(self.device, sync=False)
        self.sessions: List = []  # retained for metric reports and where=
        self._pipe = EmbeddingPipeline(
            cfg, tokenizer, encode_fn, device=self.device, batch_size=batch_size
        )
        # (datum, stamp) pairs not inserted yet; a restored snapshot may
        # carry some, and the next add inserts them first
        self._pending: List = []
        # background ingest (add_sessions_async / flush)
        self._ingest_q: Optional[queue_mod.Queue] = None
        self._ingest_thread: Optional[threading.Thread] = None
        self._ingest_err: List[BaseException] = []
        # reentrant: expire() computes matching rows and calls
        # remove_sessions under one critical section
        self._ingest_lock = threading.RLock()
        # canonical key and distinct item-id set per inserted session
        self._canon: List = []
        self._items: List[frozenset] = []
        # numpy mirrors for the vectorized query paths. Append ORDER matters
        # for lock-free snapshots: _canon_ids and _item_flat are written
        # BEFORE _item_lens for each row, so reading n = len(_item_lens)
        # first yields a consistent prefix of all three even while a
        # background ingest thread is appending.
        self._key_to_id: dict = {}
        self._canon_ids = _GrowArr(np.int64)
        self._item_flat = _GrowArr(np.int64)
        self._item_wstan = _GrowArr(np.float64)  # STAN w per _item_flat row
        self._item_lens = _GrowArr(np.int64)
        self._meta_cache: Optional[tuple] = None
        # optional caller-supplied ingest stamp per row (TTL expiry); NaN =
        # unstamped
        self._stamps = _GrowArr(np.float64)
        # gids removed from a sharded index: its ids are stable, so their
        # metadata rows stay (tombstones) where the single-device index compacts
        self._removed: set = set()
        # sharded inserts go in whole stripes of the shard count
        self._pad_to = 1
        if quantize is not None and prefilter is not None:
            raise ValueError("two-stage mode stores its own code buffers; drop quantize")
        if mesh is not None:
            if center is not None:
                raise ValueError("center= applies to the single-device DenseIndex only")
            ndev = mesh.shape["data"]
            unit = ndev * (TBLOCK if prefilter is not None and stage1 == "packed" else 1)
            capacity = -(-capacity // unit) * unit
            if prefilter is None:
                self.index = ShardedDenseIndex(
                    dim=dim, capacity=capacity, mesh=mesh, metric=metric, mode=mode,
                    quantize=quantize, **({} if dtype is None else {"dtype": dtype}),
                )
            else:
                self.index = ShardedTwoStageIndex(
                    dim=dim, capacity=capacity, mesh=mesh, metric=metric,
                    prefilter=prefilter, pool=pool, projector=projector, stage1=stage1,
                    **({} if dtype is None else {"store_dtype": dtype}),
                )
            self._pad_to = ndev
        elif prefilter is None:
            self.index = DenseIndex(
                dim=dim, capacity=capacity, device=self.device, metric=metric,
                quantize=quantize, center=center,
                **({} if dtype is None else {"dtype": dtype}),
            )
        elif center is not None:
            raise ValueError("center= applies to the flat DenseIndex only; drop prefilter")
        else:
            self.index = TwoStageIndex(
                dim=dim, capacity=capacity, device=self.device, metric=metric,
                prefilter=prefilter, pool=pool, projector=projector,
                stage1=stage1,
                **({} if dtype is None else {"store_dtype": dtype}),
            )

    # ------------------------------------------------------------------
    def embed(self, data: Sequence, out: str = "np"):
        """Embed raw sessions / (prefix, future) pairs. ``out='device'``
        keeps the embeddings on the device (the ingest and query paths)."""
        with self.timer("encode"), trace("sss.embed"):
            return self._pipe(data, out=out)

    def add_sessions(self, data: Sequence, stamp: Optional[float] = None) -> None:
        """Encode + stream-insert sessions into the corpus. ``stamp``: an
        optional ingest timestamp (any monotonic float) recorded per row for
        :meth:`expire`; unstamped rows never expire. A sharded engine inserts
        whole stripes of the shard count; the remainder waits (``pending`` in
        :meth:`stats`) for the next add."""
        with self._ingest_lock:
            self._add_locked(data, stamp)

    def _add_locked(self, data: Sequence, stamp: Optional[float] = None) -> None:
        self._pending.extend((d, stamp) for d in data)
        m = (len(self._pending) // self._pad_to) * self._pad_to
        if m == 0:
            return
        pairs, self._pending = self._pending[:m], self._pending[m:]
        emb = self.embed([d for d, _ in pairs], out="device")
        with self.timer("insert"), trace("sss.insert"):
            self.index.add(emb)
        for d, ts in pairs:
            sess = _session_of(d)
            self._stamps.append(np.nan if ts is None else float(ts))
            self.sessions.append(sess)
            key = _session_key(sess)
            items = _item_set(sess)
            sw = _item_stan_weights(sess)
            self._canon.append(key)
            self._items.append(items)
            self._canon_ids.append(
                self._key_to_id.setdefault(key, len(self._key_to_id))
            )
            ids = list(items)
            self._item_flat.extend(ids)
            self._item_wstan.extend(sw.get(i, 0.0) for i in ids)
            self._item_lens.append(len(ids))  # last: seals the row

    def _np_meta(self):
        """Consistent numpy snapshot of per-row metadata: (n, canon_ids,
        item_offsets[n+1], item_flat, item_wstan). Lock-free:
        ``_item_lens`` is appended last per row, so its length bounds a
        fully-written prefix. Cached until new rows arrive."""
        n = len(self._item_lens)
        cache = self._meta_cache
        if cache is not None and cache[0] == n:
            return cache
        lens = self._item_lens.view(n)
        n = len(lens)  # re-bound: a concurrent shrink may have raced us
        off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens[:n], out=off[1:])
        flat = self._item_flat.view(int(off[-1]))
        wstan = self._item_wstan.view(int(off[-1]))
        canon = self._canon_ids.view(n)
        self._meta_cache = (n, canon, off, flat, wstan)
        return self._meta_cache

    # ------------------------------------------------------------------
    # Background ingest: encode+insert off the caller's thread so serving
    # threads keep answering queries while new sessions stream in. Both
    # threads enqueue on the device's current stream, so the device runs a
    # search and an insert in the order they were issued; a search scans
    # the rows [0, size) it read once (DenseIndex.search).
    def add_sessions_async(self, data: Sequence, stamp: Optional[float] = None) -> None:
        """Queue sessions for background encode+insert. Failures surface on
        the next :meth:`flush` (or :meth:`close`)."""
        if self._ingest_thread is None:
            self._ingest_q = queue_mod.Queue()
            self._ingest_thread = threading.Thread(target=self._ingest_loop, daemon=True)
            self._ingest_thread.start()
        self._ingest_q.put((list(data), stamp))

    def _ingest_loop(self) -> None:
        while True:
            item = self._ingest_q.get()
            try:
                if item is None:
                    return
                data, stamp = item
                with self._ingest_lock:
                    self._add_locked(data, stamp)
            except BaseException as e:  # surfaced on flush()
                self._ingest_err.append(e)
            finally:
                self._ingest_q.task_done()

    def flush(self) -> None:
        """Block until all queued background inserts are in the index."""
        if self._ingest_q is not None:
            self._ingest_q.join()
        if self._ingest_err:
            raise self._ingest_err.pop(0)

    def close(self) -> None:
        if self._ingest_thread is not None:
            self.flush()
            self._ingest_q.put(None)
            self._ingest_thread.join()
            self._ingest_thread = None
            self._ingest_q = None

    # ------------------------------------------------------------------
    def _rebuild_meta(self) -> None:
        """Recompute every per-row metadata structure from
        ``self.sessions`` (used by restore)."""
        self._canon = [_session_key(s) for s in self.sessions]
        self._items = [_item_set(s) for s in self.sessions]
        self._key_to_id = {}
        canon_ids = [
            self._key_to_id.setdefault(key, len(self._key_to_id))
            for key in self._canon
        ]
        flat: List[int] = []
        wstan: List[float] = []
        lens: List[int] = []
        for sess, items in zip(self.sessions, self._items):
            sw = _item_stan_weights(sess)
            ids = list(items)
            flat.extend(ids)
            wstan.extend(sw.get(i, 0.0) for i in ids)
            lens.append(len(ids))
        # lens seals LAST on append; on shrink assign it FIRST so a racing
        # _np_meta never computes offsets past the (shorter) new arrays
        self._item_lens = _GrowArr(np.int64, lens)
        self._canon_ids = _GrowArr(np.int64, canon_ids)
        self._item_flat = _GrowArr(np.int64, flat)
        self._item_wstan = _GrowArr(np.float64, wstan)
        self._meta_cache = None

    def _compact_meta(self, src: np.ndarray, dst: np.ndarray, new_size: int) -> None:
        """Mirror the index's swap-with-last compaction on every per-row
        metadata structure in O(moved + items). ``src``/``dst``/``new_size``
        must be the SAME ``compaction_plan`` applied to the index."""
        for s, d in zip(src.tolist(), dst.tolist()):
            self.sessions[d] = self.sessions[s]
            self._canon[d] = self._canon[s]
            self._items[d] = self._items[s]
        del self.sessions[new_size:]
        del self._canon[new_size:]
        del self._items[new_size:]
        st = self._stamps.view(len(self._stamps)).copy()
        st[dst] = st[src]
        self._stamps = _GrowArr(np.float64, st[:new_size])
        # stale keys may linger in _key_to_id; canonical ids only need
        # EQUALITY semantics (dedup groups rows with the same content), so
        # ids need not stay dense — restore() rebuilds the dense form.
        n_old = len(self._item_lens)
        lens = self._item_lens.view(n_old).copy()
        canon = self._canon_ids.view(n_old).copy()
        off = np.zeros(n_old + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
        flat = self._item_flat.view(int(off[-1]))
        wstan = self._item_wstan.view(int(off[-1]))
        perm = np.arange(new_size, dtype=np.int64)
        keep = dst < new_size
        perm[dst[keep]] = src[keep]
        counts = lens[perm]
        new_off = np.zeros(new_size + 1, dtype=np.int64)
        np.cumsum(counts, out=new_off[1:])
        gather = (np.repeat(off[perm] - new_off[:-1], counts)
                  + np.arange(int(new_off[-1]), dtype=np.int64))
        # shrink order (see _rebuild_meta): lens first, then the arrays
        self._item_lens = _GrowArr(np.int64, counts)
        self._canon_ids = _GrowArr(np.int64, canon[perm])
        self._item_flat = _GrowArr(np.int64, flat[gather])
        self._item_wstan = _GrowArr(np.float64, wstan[gather])
        self._meta_cache = None

    def remove_sessions(self, data: Optional[Sequence] = None,
                        ids: Optional[Sequence] = None) -> int:
        """Delete sessions from the corpus (``faiss.Index.remove_ids`` at the
        serving layer). Pass EITHER ``data`` (sessions or (prefix, future)
        pairs: every stored row with the same content goes, and so do
        matching pending rows) OR ``ids`` (row ids as :meth:`search` returns
        them). Single-device rows compact positionally as in FAISS
        ``remove_ids``: ids already handed out renumber. A sharded engine's
        ids are stable: removed ids are never reused or returned, and their
        metadata rows stay as tombstones. Takes the ingest lock (safe
        against ``add_sessions_async``); a query running meanwhile may read
        renumbered metadata. Returns the number of rows removed."""
        if (data is None) == (ids is None):
            raise ValueError("pass exactly one of data= or ids=")
        with self._ingest_lock:
            if data is not None:
                keys = {_session_key(_session_of(d)) for d in data}
                # drop matching rows still waiting to be inserted
                self._pending = [
                    (d, ts) for d, ts in self._pending
                    if _session_key(_session_of(d)) not in keys
                ]
                # canonical ids group identical content, so membership is
                # one np.isin over the id mirror
                kids = np.fromiter(
                    (self._key_to_id[k] for k in keys if k in self._key_to_id),
                    np.int64,
                )
                mask = np.isin(self._canon_ids.view(len(self._canon)), kids)
                mask[self._tombstones()] = False
                rows = np.flatnonzero(mask).tolist()
            else:
                rows = [int(i) for i in ids if int(i) >= 0]
            if not rows:
                return 0
            if self._mesh is not None:
                removed = self.index.remove_ids(rows)
                self._removed.update(rows)
                return removed
            src, dst, new_size = compaction_plan(self.index.ntotal, rows)
            removed = self.index.remove_ids(rows)
            # the same compaction on every row-aligned metadata structure
            self._compact_meta(src, dst, new_size)
            return removed

    def expire(self, before: float) -> int:
        """TTL eviction: remove every row (and pending entry) whose ingest
        ``stamp`` is older than ``before``; unstamped rows never expire.
        Returns the indexed rows removed."""
        with self._ingest_lock:
            self._pending = [
                (d, ts) for d, ts in self._pending if ts is None or ts >= before
            ]
            mask = self._stamps.view() < before  # NaN compares False
            mask[self._tombstones()] = False
            ids = np.flatnonzero(mask)
            if ids.size == 0:
                return 0
            return self.remove_sessions(ids=ids)

    def _tombstones(self) -> np.ndarray:
        """The removed gids of a sharded engine (empty otherwise)."""
        return np.fromiter(self._removed, np.int64, len(self._removed))

    # ------------------------------------------------------------------
    def search(self, data: Sequence, k: Optional[int] = None,
               dedup: bool = False, hybrid_alpha: Optional[float] = None,
               overfetch: int = 4, hybrid_kind: str = "overlap",
               hybrid_fusion: str = "score",
               where: Optional[Callable] = None):
        """Full query path: sessions -> embed -> exact top-k. Returns (D, I)
        numpy arrays. ``dedup=True`` drops hits whose stored session
        duplicates a better-ranked hit's and backfills from deeper ranks.
        ``where``: optional predicate ``session -> bool``; only stored
        sessions it accepts can rank.

        ``hybrid_alpha``: re-rank the dense top-(overfetch*k) candidates by
        ``alpha * dense_cos + (1 - alpha) * sparse_cos``, on the host.
        ``hybrid_kind``: the sparse term -- 'overlap' (binary item-indicator
        cosine) or 'stan' (recency-decayed STAN cosine). ``hybrid_fusion``:
        'score' (the linear fusion) or 'rrf' (reciprocal-rank fusion
        ``1/(60+rank_dense) + 1/(60+rank_sparse)`` over the candidates;
        ``hybrid_alpha`` then only turns the hybrid path on)."""
        k = k or self.cfg.retrieval_k
        if hybrid_kind not in ("overlap", "stan"):
            raise ValueError(f"unknown hybrid_kind {hybrid_kind!r}")
        if hybrid_fusion not in ("score", "rrf"):
            raise ValueError(f"unknown hybrid_fusion {hybrid_fusion!r}")
        if hybrid_alpha is not None and self.index.metric != "cos":
            raise ValueError(
                "hybrid_alpha fuses a cosine with an overlap cosine; "
                f"metric={self.index.metric!r} scores are unbounded and the "
                "alpha weighting would be meaningless (use metric='cos')"
            )
        with trace("sss.search"):
            emb = self.embed(data, out="device")
            t0 = time.perf_counter()
            if hybrid_alpha is None:
                D, I = self.search_embeddings(emb, k, dedup=dedup, where=where)
            else:
                m = min(max(overfetch * k, k), max(self.index.ntotal, 1))
                D2, I2 = self.search_embeddings(emb, m, dedup=dedup, where=where)
                D2 = np.asarray(D2, dtype=np.float32)
                gid = np.asarray(I2, dtype=np.int64)
                sessions = [_session_of(d) for d in data]
                if hybrid_kind == "stan":
                    q_w = [_item_stan_weights(s) for s in sessions]
                else:
                    q_w = []
                    for s in sessions:
                        items = _item_set(s)
                        w = 1.0 / (len(items) ** 0.5) if items else 0.0
                        q_w.append({i: w for i in items})
                D, I = self._hybrid_rerank(D2, gid, q_w, k, float(hybrid_alpha),
                                           hybrid_kind, fusion=hybrid_fusion)
            self.timer.totals["search"] += time.perf_counter() - t0
            self.timer.counts["search"] += 1
        return D, I

    def _hybrid_rerank(self, D2, gid, q_weights, k: int, alpha: float,
                       kind: str = "overlap", fusion: str = "score"):
        """Vectorized fusion re-rank: ``alpha * dense + (1-alpha) * sparse``
        over the [q, m] candidate matrix, one numpy pass for the whole batch.
        ``q_weights`` is one {item: weight} dict per query with
        L2-normalized weights (or one item set per query: uniform weights),
        so the sparse term is a cosine for both kinds: 'overlap' uses
        uniform 1/sqrt(n) weights and 'stan' recency-decayed weights.
        Candidates inserted so recently that their metadata isn't sealed yet
        (concurrent add_sessions_async) score 0."""
        q, m = D2.shape
        if q_weights and not isinstance(q_weights[0], dict):
            q_weights = [
                {i: 1.0 / (len(s) ** 0.5) for i in s} if s else {}
                for s in q_weights
            ]
        n_meta, _, off, flat, wstan = self._np_meta()
        present = gid >= 0
        known = present & (gid < n_meta)
        g = np.where(known, gid, 0).ravel()
        starts = off[g]
        lens = np.where(known.ravel(), off[g + 1] - starts, 0)
        # gather every candidate's item ids into one flat stream
        total = int(lens.sum())
        ends = np.cumsum(lens)
        seg0 = ends - lens
        gather_ix = np.arange(total) + np.repeat(starts - seg0, lens)
        cand_items = flat[gather_ix]
        if kind == "stan":
            cand_w = wstan[gather_ix]
        else:
            # binary-indicator weights: 1/sqrt(#items of that candidate)
            inv = np.zeros(lens.shape, np.float64)
            np.divide(1.0, np.sqrt(lens.astype(np.float64)), out=inv, where=lens > 0)
            cand_w = np.repeat(inv, lens)
        # membership of (query row, item) pairs, encoded as single ints and
        # resolved by binary search in the (small, sorted) query-key set
        q_lens = np.asarray([len(s) for s in q_weights], dtype=np.int64)
        q_items = np.asarray([i for s in q_weights for i in s], dtype=np.int64)
        q_w = np.asarray([w for s in q_weights for w in s.values()], dtype=np.float64)
        big = int(max(flat.max(initial=0), q_items.max(initial=0))) + 1
        qkeys = np.repeat(np.arange(q), q_lens) * big + q_items
        korder = np.argsort(qkeys)
        qkeys, q_w = qkeys[korder], q_w[korder]
        row_of_cand = np.repeat(
            np.arange(q, dtype=np.int64), lens.reshape(q, m).sum(axis=1)
        )
        ckeys = row_of_cand * big + cand_items
        if qkeys.size:
            p = np.searchsorted(qkeys, ckeys)
            pc = np.minimum(p, qkeys.size - 1)
            member = (p < qkeys.size) & (qkeys[pc] == ckeys)
            contrib = np.where(member, cand_w * q_w[pc], 0.0)
        else:
            contrib = np.zeros(total, dtype=np.float64)
        # per-candidate weighted intersections: segment sums via one cumsum
        cm = np.zeros(total + 1, dtype=np.float64)
        np.cumsum(contrib, out=cm[1:])
        ov = (cm[ends] - cm[seg0]).reshape(q, m).astype(np.float32)
        if fusion == "rrf":
            # rank each system independently (dense rank = column order;
            # sparse rank by ov with the dense order as the tiebreak);
            # missing slots sort last so real candidates get contiguous
            # sparse ranks
            rr = np.repeat(np.arange(q, dtype=np.int64), m)
            cc = np.tile(np.arange(m, dtype=np.int64), q)
            ovr = np.where(present, ov, -np.inf)
            sp_order = np.lexsort((cc, -ovr.ravel(), rr)).reshape(q, m) % m
            cols = cc.reshape(q, m)
            sp_rank = np.empty((q, m), np.int64)
            np.put_along_axis(sp_rank, sp_order, cols, axis=1)
            fused = (1.0 / (60.0 + cols) + 1.0 / (60.0 + sp_rank)).astype(np.float32)
        else:
            fused = alpha * D2 + np.float32(1.0 - alpha) * ov
        fused[~present] = -np.inf
        # top-k per row; ties keep the dense rank order (column tiebreak)
        rowsf = np.repeat(np.arange(q), m)
        colsf = np.tile(np.arange(m), q)
        order = np.lexsort((colsf, -fused.ravel(), rowsf)).reshape(q, m)
        top = (order % m)[:, : min(k, m)]
        D = np.full((q, k), -np.inf, dtype=np.float32)
        I = np.full((q, k), -1, dtype=np.int64)
        D[:, : top.shape[1]] = np.take_along_axis(fused, top, axis=1)
        I[:, : top.shape[1]] = np.take_along_axis(gid, top, axis=1)
        I[~np.isfinite(D)] = -1
        return D, I

    def search_embeddings(self, emb, k: Optional[int] = None,
                          dedup: bool = False,
                          where: Optional[Callable] = None):
        k = k or self.cfg.retrieval_k
        with trace("sss.search_embeddings"):
            mask = None if where is None else self._where_mask(where)
            if not dedup:
                return self.index.search(emb, k, row_mask=mask)
            # over-fetch so dropped duplicates can be backfilled
            k2 = min(max(2 * k, k + 8), max(self.index.ntotal, 1))
            D2, I2 = self.index.search(emb, k2, row_mask=mask)
            return self._dedup_topk(D2, I2, k)

    def range_search(self, data: Sequence, radius: float, k0: int = 128,
                     where: Optional[Callable] = None):
        """All stored sessions within ``radius`` of each query session
        (a cosine floor under the default 'cos' metric):
        ``faiss.Index.range_search`` at the serving layer. Returns the CSR
        triple ``(lims [q+1], D, I)``: query ``i``'s neighbours are
        ``I[lims[i]:lims[i+1]]``, sorted best-first. ``where`` filters as in
        :meth:`search`. Needs the flat index: a two-stage pool has no radius
        semantics."""
        if not isinstance(self.index, (DenseIndex, ShardedDenseIndex)):
            raise ValueError(
                "range_search needs an exact full-corpus index; this engine "
                f"serves a {type(self.index).__name__} (two-stage pools have "
                "no radius semantics)"
            )
        emb = self.embed(data, out="device")
        mask = self._where_mask(where) if where is not None else None
        t0 = time.perf_counter()
        out = self.index.range_search(emb, radius, k0=k0, row_mask=mask)
        self.timer.totals["search"] += time.perf_counter() - t0
        self.timer.counts["search"] += 1
        return out

    def _where_mask(self, where: Callable) -> np.ndarray:
        """Evaluate a session predicate into the index's row mask:
        positional for the single-device indexes, keyed by global id for the
        sharded ones (whose session list is the id space, tombstones
        included)."""
        return np.fromiter(
            (bool(where(s)) for s in self.sessions),
            dtype=bool, count=len(self.sessions),
        )

    def _dedup_topk(self, D2, I2, k: int):
        """Drop candidates whose session duplicates a better-ranked hit
        (same canonical key), backfilling from deeper ranks."""
        D2 = np.asarray(D2)
        gid = np.asarray(I2, dtype=np.int64)
        q, m = gid.shape
        n_meta, canon, _, _, _ = self._np_meta()
        valid = gid >= 0
        # rows whose metadata isn't sealed yet (concurrent ingest) fall back
        # to a unique per-gid key past the canon-id range
        g = np.where(valid, gid, 0)
        key = np.where(
            g < n_meta,
            canon[np.minimum(g, max(n_meta - 1, 0))] if n_meta else g,
            g + (np.int64(1) << 40),
        )
        # group by (row, key), keep each group's best-ranked column, then
        # restore rank order and take the first k per row
        rowsf = np.repeat(np.arange(q), m)
        colsf = np.tile(np.arange(m), q)
        order = np.lexsort((colsf, key.ravel(), rowsf))
        rs, ks = rowsf[order], key.ravel()[order]
        first = np.ones(q * m, dtype=bool)
        first[1:] = (rs[1:] != rs[:-1]) | (ks[1:] != ks[:-1])
        keep = first & valid.ravel()[order]
        kr, kc = rs[keep], colsf[order][keep]
        o2 = np.lexsort((kc, kr))
        kr, kc = kr[o2], kc[o2]
        pos = np.arange(len(kr)) - np.searchsorted(kr, np.arange(q))[kr]
        sel = pos < k
        kr, kc, pos = kr[sel], kc[sel], pos[sel]
        D = np.full((q, k), -np.inf, dtype=D2.dtype)
        I = np.full((q, k), -1, dtype=np.asarray(I2).dtype)
        D[kr, pos] = D2[kr, kc]
        I[kr, pos] = gid[kr, kc]
        return D, I

    # ------------------------------------------------------------------
    def report(self, test_data: Sequence, I, D=None) -> dict:
        """Ground-truth quality report for retrieved results."""
        return metrics_mod.full_report(D, I, list(test_data), self.sessions)

    def reconstruct(self, ids) -> np.ndarray:
        """Stored embedding rows for result ids, [m, d] float32."""
        return self.index.reconstruct_batch(ids)

    def stats(self) -> dict:
        """Per phase (``encode``, ``search``, ``insert``) its host seconds
        (``total_s``, ``count``, ``mean_ms``): no phase waits for the device,
        so a phase counts what the host spent, device work it waited on
        included; ``ntotal`` and ``pending`` rows; ``counters``, the
        process's ``utils.profiling`` counters (sessions embedded, bytes
        uploaded, chunks and rows scanned, candidates re-ranked)."""
        s = self.timer.summary()
        s["ntotal"] = self.index.ntotal
        s["pending"] = len(self._pending)
        s["counters"] = counters()
        return s

    # ------------------------------------------------------------------
    # Snapshot / restore: ``prefix + '.index.npz'`` (DenseIndex's npz) and
    # ``prefix + '.sessions.pkl'`` (keys sessions, stamps, pending,
    # pending_stamps), the JAX engine's files
    def save(self, prefix: str) -> None:
        """Snapshot corpus + sessions; the blocking form of
        :meth:`save_async`."""
        self.save_async(prefix).join()

    def save_async(self, prefix: str) -> SaveHandle:
        """Capture a point-in-time copy of the serving state under the
        ingest lock (the index's rows are cloned on the device, the
        metadata lists copied shallowly), then download and write it on a
        background thread while searches and ingest go on. Queued background
        inserts are flushed first. Returns a :class:`SaveHandle`: call
        ``join()`` before restoring from ``prefix``; a writer error
        surfaces there. The index's own ``write_snapshot`` writes its
        npz. A sharded index has no device-side capture, as in JAX: the
        writer saves it under the ingest lock, so searches go on while
        ingest and maintenance wait for the write."""
        self.flush()
        with self._ingest_lock:
            snap = None if self._mesh is not None else self.index.snapshot()
            index = self.index
            meta = {
                "sessions": list(self.sessions),
                # float array, NaN = unstamped
                "stamps": self._stamps.view(len(self._stamps)).copy(),
                "pending": [d for d, _ in self._pending],
                "pending_stamps": [ts for _, ts in self._pending],
            }

        def work():
            if snap is not None:
                type(index).write_snapshot(snap, prefix + ".index")
            else:
                with self._ingest_lock:
                    index.save(prefix + ".index")
            with open(prefix + ".sessions.pkl", "wb") as f:
                _SessionPickler(f).dump(meta)

        handle = SaveHandle(work)
        handle._thread.start()
        return handle

    def restore(self, prefix: str, projection=None) -> None:
        """Load a snapshot (either package's engine) into this engine. The
        index class is this engine's (``DenseIndex`` or ``TwoStageIndex``),
        its serving configuration comes from the snapshot, its capacity
        from this engine. A mesh engine loads the snapshot's sharded class
        (two-stage when it has a prefilter) on its own mesh, re-striped if
        the shard count differs, with the snapshot's capacity, and rebuilds
        its tombstones from the ids the index no longer holds.
        ``projection``: the SimHash projection of a JAX ``'binary'``
        two-stage snapshot, which stores only its seed
        (``TwoStageIndex.load``). The live index is dropped before the
        snapshot loads, so the device never holds two corpora; if the load
        fails, the engine is left without an index. The encoder is not part
        of the snapshot."""
        with self._ingest_lock:
            kind, cap, mesh = type(self.index), self.index.capacity, self._mesh
            self.index = None
            if mesh is not None:
                with np.load(prefix + ".index.npz") as z:
                    two_stage = "prefilter" in z
                self.index = (
                    ShardedTwoStageIndex.load(prefix + ".index", mesh, projection=projection)
                    if two_stage else ShardedDenseIndex.load(prefix + ".index", mesh))
            elif kind is TwoStageIndex:
                self.index = TwoStageIndex.load(prefix + ".index", capacity=cap,
                                                device=self.device, projection=projection)
            else:
                self.index = DenseIndex.load(prefix + ".index", capacity=cap,
                                             device=self.device)
            with open(prefix + ".sessions.pkl", "rb") as f:
                blob = _SessionUnpickler(f).load()
            self.sessions = list(blob["sessions"])
            raw = blob.get("stamps")
            if raw is None:
                arr = np.full(len(self.sessions), np.nan)
            elif isinstance(raw, np.ndarray):
                arr = raw.astype(np.float64)
            else:  # list-of-Optional[float] snapshots
                arr = np.asarray([np.nan if t is None else float(t) for t in raw], np.float64)
            self._stamps = _GrowArr(np.float64, arr)
            pend = list(blob["pending"])
            pend_ts = list(blob.get("pending_stamps", [None] * len(pend)))
            self._pending = list(zip(pend, pend_ts))
            self._rebuild_meta()
            self._removed = set()
            if mesh is not None:
                held = self.index._host_ids[self.index._host_ids >= 0]
                self._removed = set(np.setdiff1d(np.arange(self.index._next_id), held).tolist())
