"""The FAISS-maintenance surface timed at the bench shape (counterpart of
``examples/maintenance_bench.py``).

At 2^20 x 1600 (bf16 corpus and scores, 'cos') on one card, with the
capacity N + 2 * 2^18 and the whole capacity as one chunk:

1. ``range_search`` across radii, from easy (one depth) to hostile (a
   radius holding about half the corpus, which drives the adaptive depth to
   the corpus size), reporting the top-k depths each radius scanned;
2. filtered search (``row_mask``, 50% of the rows) against the unmasked
   scan;
3. bulk ``remove_ids`` and the search after it: positional compaction on
   the index, and the stable-id compaction of a ``ShardedDenseIndex`` on a
   one-shard mesh (``parallel.create_mesh`` over the one device);
4. ``merge_from`` (shard consolidation), twice.

    python -m sessionsimilaritysearch_tpu_torch.examples.maintenance_bench
    python -m sessionsimilaritysearch_tpu_torch.examples.maintenance_bench --device cpu --tiny

Differences from the JAX script:

- ``--platform {cpu,tpu}`` is ``--device {cuda,cpu}``, default ``cuda``,
  resolved first (``device.resolve_device``); ``platform`` in the report
  becomes ``device`` (the card's name, or ``cpu``).
- ``--out`` defaults to ``maintenance_bench.json`` in the temporary
  directory (``tempfile.gettempdir()``; JAX: a file under ``docs/`` that
  holds JAX-era numbers).
- Timing: the host clock between two ``torch.cuda.synchronize()``; JAX
  chains each search's output into the next query and settles writes with
  a host read (``_settle``), because the TPU runtime could return from
  ``block_until_ready`` early. The iteration counts are the same.
- JAX's docstring claims that the latency after a removal must match the
  latency before it (its scan covers the whole capacity). The port scans
  only the filled rows, so a search after a removal may be faster; the
  times are reported as measured and nothing asserts them equal.
- Random draws: ``torch.Generator`` seeded 0 (the corpus, the queries and
  the sharded index's rows) and 7 (the merge source) on the device, so the
  rows differ from JAX's.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.evalharness.harness import _sync


def fill_unit_rows(index, n: int, d: int, generator: torch.Generator, dev,
                   chunk: int = 1 << 17) -> None:
    """Adds ``n`` seeded unit rows to ``index``, ``chunk`` at a time: normal
    draws rounded to bf16, normalized in f32, stored in bf16."""
    from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize

    for s in range(0, n, chunk):
        r = torch.randn(min(chunk, n - s), d, generator=generator, device=dev)
        index.add(l2_normalize(r.to(torch.bfloat16).float()).to(torch.bfloat16))


def radii(d: int) -> list:
    """The sweep's (name, radius): on unit-norm iid Gaussian rows cosines
    concentrate near 0 with sd ~ 1/sqrt(d), so these take the hit sets from
    ~0 to ~half the corpus."""
    sd = 1.0 / np.sqrt(d)
    return [("easy", 5.0 * sd), ("moderate", 3.0 * sd), ("hostile", 0.0)]


def counted_range_search(index, queries, radius: float):
    """``index.range_search(queries, radius)`` with the depth of every top-k
    scan it ran, counted by swapping the instance's ``search`` (put back
    afterwards). Returns ((lims, D, I), depths, seconds)."""
    depths: list = []
    orig = index.search

    def counting_search(q, k, **kw):
        depths.append(k)
        return orig(q, k, **kw)

    index.search = counting_search
    try:
        _sync(index.device)
        t0 = time.perf_counter()
        out = index.range_search(queries, radius)
        _sync(index.device)
        dt = time.perf_counter() - t0
    finally:
        del index.search
    return out, depths, dt


def main(argv=None, keep=None) -> dict:
    """Runs the bench; returns the report. ``keep``: a dict that receives the
    queries, the range queries, the stored rows at the range sweep
    (``range_rows``), each radius's result (``ranges``), the index after the
    removals, the victims and the sharded index, for a caller that checks
    them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "maintenance_bench.json"))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    from sessionsimilaritysearch_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)

    from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
    from sessionsimilaritysearch_tpu_torch.index.sharded import ShardedDenseIndex
    from sessionsimilaritysearch_tpu_torch.ops.topk import l2_normalize
    from sessionsimilaritysearch_tpu_torch.parallel import create_mesh

    if args.tiny:
        N, D, K, Q = 1 << 14, 128, 100, 256
        RQ = 16  # range-search query batch
        merge_n = 1 << 12
        remove_n = 1 << 12
    else:
        N, D, K, Q = 1 << 20, 1600, 100, 1024
        RQ = 64
        merge_n = 1 << 18
        remove_n = 100_000
    bf16 = torch.bfloat16

    rec = {"N": N, "D": D, "K": K, "query_batch": Q}
    # the corpus is drawn and stays on the device, in bf16, normalized chunk
    # by chunk; capacity leaves room for the two merge sources
    cap = N + 2 * merge_n
    rec["capacity"] = cap
    g = torch.Generator(device=dev).manual_seed(0)
    idx = DenseIndex(dim=D, capacity=cap, metric="cos", dtype=bf16, chunk_size=cap,
                     score_dtype=bf16, device=dev)
    fill_unit_rows(idx, N, D, g, dev)
    queries = l2_normalize(torch.randn(Q, D, generator=g, device=dev))
    _sync(dev)

    def timed_search(label, n_iter=None, row_mask=None, index=None):
        ix = index if index is not None else idx
        n_iter = n_iter or args.iters
        for _ in range(2):
            D_, I_ = ix.search(queries, K, row_mask=row_mask, out="device")
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n_iter):
            D_, I_ = ix.search(queries, K, row_mask=row_mask, out="device")
        _sync(dev)
        dt = (time.perf_counter() - t0) / n_iter
        rec[label] = {"ms_per_batch": round(dt * 1e3, 1), "qps": round(Q / dt, 1)}
        print(f"{label:>28}: {dt * 1e3:8.1f} ms  {Q / dt:10,.1f} qps", flush=True)
        return D_, I_

    # --- the unmasked exact scan
    timed_search("search_unmasked")

    # --- 2. filtered search: a 50% random mask over the capacity, on the device
    mask = np.zeros(idx.capacity, bool)
    mask[:N] = np.random.default_rng(0).random(N) < 0.5
    timed_search("search_row_mask_50pct", row_mask=torch.from_numpy(mask).to(dev))

    # --- 1. range_search across radii: the first call, then a second
    rq = queries[:RQ]
    if keep is not None:
        keep.update(queries=queries, range_queries=rq, range_rows=idx._buf[:N].clone(),
                    ranges={})
    for name, radius in radii(D):
        _, _, dt = counted_range_search(idx, rq, radius)
        (lims, Dr, Ir), depths, dt_warm = counted_range_search(idx, rq, radius)
        hits = float(np.diff(lims).mean())
        rec[f"range_{name}"] = {
            "radius": round(float(radius), 5),
            "mean_hits_per_query": round(hits, 1),
            "depths": depths,
            "cold_s": round(dt, 2),
            "warm_s": round(dt_warm, 2),
            "warm_qps": round(RQ / dt_warm, 1),
        }
        if keep is not None:
            keep["ranges"][name] = (radius, lims, Dr, Ir)
        print(f"{'range_' + name:>28}: radius={radius:.4f} hits/q={hits:10,.1f} "
              f"depths={depths} first={dt:.2f}s second={dt_warm:.2f}s "
              f"({RQ / dt_warm:,.1f} qps)", flush=True)

    # --- 4. merge_from: a merge_n-row index into this one, twice
    src = DenseIndex(dim=D, capacity=merge_n, metric="cos", dtype=bf16, chunk_size=merge_n,
                     device=dev)
    g7 = torch.Generator(device=dev).manual_seed(7)
    src.add(l2_normalize(torch.randn(merge_n, D, generator=g7, device=dev)).to(bf16))
    merge_s = []
    for _ in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        added = idx.merge_from(src)
        _sync(dev)
        merge_s.append(time.perf_counter() - t0)
    del src
    rec["merge_from"] = {
        "rows": added, "cold_s": round(merge_s[0], 2),
        "warm_s": round(merge_s[1], 3),
        "warm_rows_per_s": round(added / merge_s[1], 1),
    }
    print(f"{'merge_from':>28}: {added} rows first={merge_s[0]:.2f}s "
          f"second={merge_s[1]:.3f}s ({added / merge_s[1]:,.0f} rows/s)", flush=True)
    timed_search("search_after_merge")

    # --- 3. bulk remove_ids (positional compaction), two disjoint halves;
    # drawn from the first N rows, so the same victims suit the sharded
    # index below
    victims = np.random.default_rng(1).choice(N, size=2 * remove_n, replace=False)
    remove_s = []
    for half in (victims[:remove_n], victims[remove_n:]):
        _sync(dev)
        t0 = time.perf_counter()
        removed = idx.remove_ids(half)
        _sync(dev)
        remove_s.append(time.perf_counter() - t0)
    rec["remove_ids"] = {
        "rows": removed, "cold_s": round(remove_s[0], 2),
        "warm_s": round(remove_s[1], 3),
        "warm_rows_per_s": round(removed / remove_s[1], 1),
    }
    print(f"{'remove_ids':>28}: {removed} rows first={remove_s[0]:.2f}s "
          f"second={remove_s[1]:.3f}s ({removed / remove_s[1]:,.0f} rows/s)", flush=True)
    timed_search("search_after_remove")
    if keep is not None:
        keep.update(index=idx, victims=victims)
    del idx

    # --- the sharded stable-id compaction on a one-shard mesh (ids never
    # renumber); fresh seeded rows, as row identity does not change the cost
    mesh1 = create_mesh(devices=[dev])
    sidx = ShardedDenseIndex(dim=D, capacity=N, mesh=mesh1, dtype=bf16, chunk_size=N,
                             score_dtype=bf16)
    fill_unit_rows(sidx, N, D, torch.Generator(device=dev).manual_seed(0), dev)

    timed_search("sharded_search_before_remove", index=sidx)
    s_remove_s = []
    for half in (victims[:remove_n], victims[remove_n:]):
        _sync(dev)
        t0 = time.perf_counter()
        removed = sidx.remove_ids(half)
        _sync(dev)
        s_remove_s.append(time.perf_counter() - t0)
    rec["sharded_remove_ids"] = {
        "rows": removed, "cold_s": round(s_remove_s[0], 2),
        "warm_s": round(s_remove_s[1], 3),
        "warm_rows_per_s": round(removed / s_remove_s[1], 1),
    }
    print(f"{'sharded_remove_ids':>28}: {removed} rows first={s_remove_s[0]:.2f}s "
          f"second={s_remove_s[1]:.3f}s ({removed / s_remove_s[1]:,.0f} rows/s)", flush=True)
    timed_search("sharded_search_after_remove", index=sidx)
    if keep is not None:
        keep["sharded"] = sidx

    rec["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if not isinstance(v, dict)}))
    return rec


if __name__ == "__main__":
    main()
