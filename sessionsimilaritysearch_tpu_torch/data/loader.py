"""Batched session-graph loader.

Replaces the reference's PyG DataLoader + collation stack (DataLoader.py:
Collater/MyCollater/MyDataLoader + pin_memory monkeypatch). With fixed-shape
padded graphs, collation is a stack (data/graph.py:batch_graphs); what
remains is shuffling, static batch shapes (pad-final-batch so one jit
covers every step), tuple batches for triplet data (MyCollater's role), and
a background-thread prefetcher that overlaps host graph-building with
device compute.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from sessionsimilaritysearch_tpu_torch.config import GraphDims
from sessionsimilaritysearch_tpu_torch.data.graph import (
    SessionGraph,
    batch_graphs,
    build_graph_batch,
)
from sessionsimilaritysearch_tpu_torch.utils.profiling import attach, current, trace

# --- multiprocess graph building -------------------------------------------
# sequence_to_graph is ~1 ms/session of single-threaded Python; at corpus
# scale it, not the TPU, bounds embed throughput (docs/RESULTS.md). Worker
# processes hold the dataset once (initializer) and return whole stacked
# batches, so per-batch IPC is one pickled SessionGraph.

_POOL_STATE: dict = {}


def _pool_init(data, tokenizer, dims, ignore_query):
    _POOL_STATE.update(
        data=data, tokenizer=tokenizer, dims=dims, ignore_query=ignore_query
    )


def _pool_build_batch(indices):
    s = _POOL_STATE
    return build_graph_batch(
        [s["data"][int(i)] for i in indices], s["tokenizer"], s["dims"],
        indices=[int(i) for i in indices], ignore_query=s["ignore_query"],
    )


class SessionGraphLoader:
    """Iterates padded SessionGraph batches from raw (prefix, future) data.

    Graphs are built lazily per epoch (supporting per-epoch augmentation
    transforms like the reference's random_exchange_order) or precomputed
    once when ``transform`` is None and ``cache=True``.
    """

    def __init__(
        self,
        data: Sequence,
        tokenizer,
        dims: GraphDims,
        batch_size: int,
        shuffle: bool = True,
        ignore_query: bool = False,
        transform: Optional[Callable] = None,
        drop_last: bool = False,
        cache: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        workers: int = 0,
    ):
        """``workers > 0``: build batches in a process pool (only valid with
        ``transform=None`` -- augmentations are rng-stateful on the host)."""
        self.data = list(data)
        self.tokenizer = tokenizer
        self.dims = dims
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.ignore_query = ignore_query
        self.transform = transform
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.workers = 0 if transform is not None else workers
        self._pool: Optional[ProcessPoolExecutor] = None
        self._cache: Optional[List[SessionGraph]] = None
        if cache and transform is None:
            # one native whole-corpus build, sliced back into per-session
            # graphs (row views of a batched SessionGraph are exactly the
            # unbatched layout)
            big = build_graph_batch(
                self.data, tokenizer, dims, ignore_query=ignore_query,
            ) if len(self.data) else None
            self._cache = [
                SessionGraph(*[f[i] for f in big])
                for i in range(len(self.data))
            ] if big is not None else []

    def _get_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            # never fork: JAX's runtime is multithreaded by the time a pool
            # is created, and fork()ing a threaded process deadlocks. The
            # forkserver children are forked from a clean helper process.
            try:
                ctx = multiprocessing.get_context("forkserver")
            except ValueError:
                ctx = multiprocessing.get_context("spawn")
            self._pool = ProcessPoolExecutor(
                max_workers=self.workers,
                mp_context=ctx,
                initializer=_pool_init,
                initargs=(self.data, self.tokenizer, self.dims,
                          self.ignore_query),
            )
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        n = len(self.data)
        full, rem = divmod(n, self.batch_size)
        return full if (self.drop_last or rem == 0) else full + 1

    def _batch_index_lists(self):
        order = (
            self.rng.permutation(len(self.data))
            if self.shuffle
            else np.arange(len(self.data))
        )
        bs = self.batch_size
        out = []
        for s in range(0, len(order), bs):
            sel = order[s : s + bs]
            if len(sel) < bs:
                if self.drop_last:
                    break
                # pad with wrap-around samples: batch shape stays static so
                # the train step never recompiles
                extra = order[: bs - len(sel)]
                sel = np.concatenate([sel, extra])
            out.append(sel)
        return out

    def _batches(self) -> Iterator[SessionGraph]:
        selections = self._batch_index_lists()
        if self.workers > 0 and self._cache is None:
            pool = self._get_pool()
            yield from pool.map(_pool_build_batch, selections)
            return
        for sel in selections:
            if self._cache is not None:
                with trace("sss.embed.build"):
                    b = batch_graphs([self._cache[i] for i in sel])
                yield b
                continue
            if self.transform is not None:
                pairs = [
                    self.transform(self.data[int(i)], self.rng) for i in sel
                ]
            else:
                pairs = [self.data[int(i)] for i in sel]
            with trace("sss.embed.build"):
                b = build_graph_batch(
                    pairs, self.tokenizer, self.dims,
                    indices=[int(i) for i in sel],
                    ignore_query=self.ignore_query,
                )
            yield b

    def __iter__(self) -> Iterator[SessionGraph]:
        """The batches; their ``sss.embed.build`` spans are children of the
        span open where the iteration began (``utils.profiling``)."""
        return self._iterate(current())

    def _iterate(self, parent) -> Iterator[SessionGraph]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _END = object()
        err: List[BaseException] = []
        stop = threading.Event()

        def worker():
            try:
                with attach(parent):
                    for b in self._batches():
                        # bounded put that notices an abandoned consumer, so a
                        # dropped iterator (e.g. next(iter(loader))) doesn't pin
                        # the thread + its prefetched batches forever
                        while not stop.is_set():
                            try:
                                q.put(b, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                # the sentinel must not be dropped when the queue is full,
                # or the consumer blocks forever; retry until delivered or
                # the consumer has gone away
                while not stop.is_set():
                    try:
                        q.put(_END, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # generator closed (normally or abandoned): release the worker
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


class ContrastiveViewLoader:
    """Yields (batch, augmented_view_batch) pairs for contrastive
    pretraining -- the reference's second-view construction
    (pretrain_filtered_amazon.py:460-463 with random_exchange_order)."""

    def __init__(self, base: SessionGraphLoader, view_transform: Callable,
                 seed: int = 0):
        self.base = base
        self.view_transform = view_transform
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.base)

    def __iter__(self):
        # regenerate the same index order as the base loader by sharing it:
        # iterate base batches and rebuild the view from the graphs' idx
        for batch in self.base:
            idxs = [int(i) for i in np.asarray(batch.idx)]
            pairs = [
                self.view_transform(self.base.data[i], self.rng)
                for i in idxs
            ]
            yield batch, build_graph_batch(
                pairs, self.base.tokenizer, self.base.dims, indices=idxs,
                ignore_query=self.base.ignore_query,
            )


class TupleLoader:
    """Element-wise collation of tuple datasets (MyCollater's role,
    DataLoader.py:42-54): each item is a tuple whose graph elements batch
    with ``batch_graphs`` and whose scalars stack."""

    def __init__(self, items: Sequence[tuple], batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        self.items = list(items)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.items) // self.batch_size

    def __iter__(self):
        order = (
            self.rng.permutation(len(self.items))
            if self.shuffle
            else np.arange(len(self.items))
        )
        bs = self.batch_size
        for s in range(0, len(order) - bs + 1, bs):
            group = [self.items[i] for i in order[s : s + bs]]
            out = []
            for elems in zip(*group):
                if isinstance(elems[0], SessionGraph):
                    out.append(batch_graphs(elems))
                else:
                    out.append(np.asarray(elems))
            yield tuple(out)
