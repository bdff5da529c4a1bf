"""Mixed-workload serving soak (counterpart of ``examples/serving_soak.py``).

One sustained ``SessionSearchEngine`` run that interleaves every maintenance
verb of the serving layer -- ingest, search, ``remove_sessions``,
``expire``, a non-blocking ``save_async`` while searches go on, then
``restore`` -- and reports what an operator watches: sustained mixed QPS,
per-batch search latency p50/p99, ingest throughput, the cost of each
maintenance verb, the search latency during the snapshot write, and whether
the serving path and the device memory stayed flat.

The encoder is the flagship ``GraphLevelEncoder`` of the subsession trainer
at init (``training.session_trainers.create_session_state(...,
encoder_kind="flagship")``), served as the port's serving recipe: bf16
``serving_params``, the catalog title table, the keyword table of the
warm-up sessions and ``make_cached_encode_fn``. The corpus is stored in
bf16, so every search scans through K1's bf16 kernel (the TMA + ``wgmma``
variant at d = 1600 on the card). ``--mesh n`` shards the engine over
``n`` shards: ``n`` cards when the machine has them, else ``n`` shards on
the one device (``cuda:0``, or the CPU with ``--device cpu``).

    python -m sessionsimilaritysearch_tpu_torch.examples.serving_soak --out soak.json
    python -m sessionsimilaritysearch_tpu_torch.examples.serving_soak --device cpu --tiny

Differences from the JAX script:

- ``--platform {cpu,tpu}`` is ``--device {cuda,cpu}``, default ``cuda``,
  resolved first (``device.resolve_device``): without a card the run raises
  unless ``--device cpu`` is given; nothing falls back to the CPU.
- The zero-retrace contract (JAX ``jit_cache_*``) becomes
  ``kernel_path_flat``: every search after the warm-up (the mixed phase,
  the snapshot's reference search and the search after ``restore``)
  launched K1 exactly as often as its chunked scan has chunks
  (``ceil(rows / chunk_size)`` unsharded, one per non-empty shard and chunk
  sharded), and every launch was one variant (the counters of
  ``ops.mips``). On the CPU no launch is counted and none is expected.
  ``k1_launches`` gives the counts.
- JAX's ``hbm_bytes_*`` become ``memory_allocated_after_warmup`` and
  ``memory_allocated_end`` (``torch.cuda.memory_allocated``) and
  ``memory_flat``: the end may exceed the warm-up by at most
  ``MEMORY_SLACK`` bytes, since the capacity is fixed. On the CPU all three
  are null.
- ``platform`` is replaced by ``device``, the card's name (``cpu`` on the
  CPU).
- The exit code is 1 when ``kernel_path_flat`` or ``memory_flat`` fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.config import Config, tiny_test_config
from sessionsimilaritysearch_tpu_torch.data import AdversarialSessionGenerator
from sessionsimilaritysearch_tpu_torch.device import resolve_device
from sessionsimilaritysearch_tpu_torch.engine import SessionSearchEngine
from sessionsimilaritysearch_tpu_torch.evalharness.harness import (
    build_keyword_table,
    build_title_table,
    make_cached_encode_fn,
)
from sessionsimilaritysearch_tpu_torch.index import ShardedDenseIndex
from sessionsimilaritysearch_tpu_torch.ops import mips
from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer
from sessionsimilaritysearch_tpu_torch.training.session_trainers import create_session_state
from sessionsimilaritysearch_tpu_torch.utils.precision import serving_params

# how far the device memory at the end may exceed the memory after warm-up
MEMORY_SLACK = 64 << 20


def _pct(lat_s, q):
    a = np.asarray(lat_s, dtype=np.float64) * 1e3
    return {
        "p50_ms": round(float(np.percentile(a, 50)), 3),
        "p99_ms": round(float(np.percentile(a, 99)), 3),
        "mean_ms": round(float(a.mean()), 3),
        "batches": len(a),
        "qps": round(q * len(a) / float(np.sum(a) / 1e3), 1),
    }


def _k1_counts() -> tuple:
    return mips.launch_count, mips.wgmma_launch_count, mips.cp_async_launch_count


def expected_k1_launches(index, device: torch.device) -> int:
    """K1 launches one search of ``index`` makes: one per chunk of its
    chunked scan over the filled rows (per shard for a sharded index); none
    on the CPU, where the plain version runs."""
    if device.type != "cuda":
        return 0
    if not isinstance(index, ShardedDenseIndex):
        return -(-index.ntotal // index.chunk_size)
    chunk = max(1, min(index.chunk_size, index.shard_rows))
    return int(sum(-(-int(f) // chunk) for f in index._fill))


class _SearchLog:
    """Each search's K1 launches by variant, beside what its scan should
    launch."""

    def __init__(self, eng, device):
        self.eng, self.device = eng, device
        self.rows = []  # (launches, wgmma, cp_async, expected)

    def search(self, queries, k):
        expected = expected_k1_launches(self.eng.index, self.device)
        before = _k1_counts()
        out = self.eng.search(queries, k=k)
        after = _k1_counts()
        self.rows.append(tuple(b - a for a, b in zip(before, after)) + (expected,))
        return out

    def summary(self) -> dict:
        rows = np.asarray(self.rows, dtype=np.int64).reshape(-1, 4)
        launches, wgmma, cp, expected = rows.T
        tile = launches - wgmma - cp
        # one variant across every launch: all wgmma, all cp_async or all tile
        one_variant = sum(int(v.sum()) > 0 for v in (wgmma, cp, tile)) <= 1
        return {
            "searches": len(rows),
            "per_search": sorted(set(launches.tolist())),
            "expected_per_search": sorted(set(expected.tolist())),
            "total": int(launches.sum()),
            "wgmma": int(wgmma.sum()),
            "cp_async": int(cp.sum()),
            "flat": bool((launches == expected).all()) and one_variant,
        }


def _memory(device) -> Optional[int]:
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return int(torch.cuda.memory_allocated(device))


def run_soak(args, keep: Optional[dict] = None) -> dict:
    """The soak of the module docstring; returns the report. ``keep``: a
    dict that receives the engine (``engine``), the stored sessions just
    before the restore (``sessions_end``) and the last mixed-phase query
    batch (``queries``), for a caller that checks the kernels on them."""
    dev = resolve_device(getattr(args, "device", "cuda"))
    if args.tiny:
        cfg = tiny_test_config()
        args.rows = min(args.rows, 1024)
        args.fill_chunk, args.batches = 256, 8
        args.qbatch = args.ibatch = 64
        args.remove_every, args.expire_every = 3, 4
        args.embed_batch = 64
    elif args.tiny_model:
        # tiny widths, caller-chosen rows and batches
        cfg = tiny_test_config()
    else:
        cfg = Config().replace(asin_num=args.asin_num, batch_size=256)
    gen = AdversarialSessionGenerator(asin_num=cfg.asin_num, seed=7)
    tok = get_tokenizer(cfg.vocab_size)

    # --- encoder at init, bf16 serving params, cached tables (the flagship
    # serving recipe minus training)
    t0 = time.perf_counter()
    warm = gen.dataset(args.embed_batch)
    model, _ = create_session_state(cfg, dev, mode="subsession", encoder_kind="flagship")
    enc = serving_params(model.encoder)
    del model
    table = build_title_table(cfg, tok, gen.titles, enc, batch_size=args.embed_batch)
    kws = sorted({a[2] or "" for d in warm for a in d[0] if a[1] == "s"})
    qtable, kw_lookup = build_keyword_table(cfg, tok, kws, enc, batch_size=args.embed_batch)
    encode = make_cached_encode_fn(enc, table, query_table=qtable, kw_lookup=kw_lookup)
    t_setup = time.perf_counter() - t0
    dim = cfg.session_emb_dim
    print(f"setup (init encoder + tables, dim={dim}): {t_setup:.1f}s", flush=True)

    # stream headroom: the mixed phase net-adds ibatch rows per iteration
    capacity = args.rows + args.batches * args.ibatch + 4 * args.ibatch
    mesh = None
    if getattr(args, "mesh", 0):
        from sessionsimilaritysearch_tpu_torch.parallel import create_mesh

        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        devices = ([torch.device("cuda", i) for i in range(args.mesh)]
                   if cards >= args.mesh else [dev] * args.mesh)
        mesh = create_mesh(devices=devices)
    # bf16 corpus storage: the production dtype (value recall gated at two
    # bf16 ulps), half the bytes of the f32 default
    eng = SessionSearchEngine(
        cfg, tok, encode, dim=dim, capacity=capacity, mesh=mesh,
        device=None if mesh is not None else dev,
        batch_size=args.embed_batch, dtype=torch.bfloat16,
    )

    # --- phase FILL: bulk ingest to args.rows (unstamped -> never expires;
    # expire acts on the streamed tail, remove_sessions compacts over the
    # whole id space)
    t0 = time.perf_counter()
    n_fill = 0
    gen_s = 0.0
    while n_fill < args.rows:
        m = min(args.fill_chunk, args.rows - n_fill)
        tg = time.perf_counter()
        chunk = gen.dataset(m)
        gen_s += time.perf_counter() - tg
        eng.add_sessions([d[0] for d in chunk])
        n_fill += m
        if n_fill % (args.fill_chunk * 16) == 0:
            print(f"  fill {n_fill}/{args.rows}", flush=True)
    fill_s = time.perf_counter() - t0
    ingest_rate = args.rows / max(fill_s - gen_s, 1e-9)
    print(f"fill {args.rows} rows: {fill_s:.1f}s "
          f"({ingest_rate:.0f} sessions/s ingest, {gen_s:.1f}s generate)", flush=True)

    # --- query pool + streamed-session pool for the mixed phase
    qpool = gen.dataset(max(4 * args.qbatch, 512))
    stream = gen.dataset(args.batches * args.ibatch)
    fixed_q = [d for d in qpool[: args.qbatch]]

    # --- warm-up: touch every verb once before the flat window opens
    eng.search(qpool[: args.qbatch], k=args.k)
    victims = [stream[i][0] for i in range(min(8, len(stream)))]
    eng.add_sessions(victims, stamp=-1.0)
    eng.remove_sessions(data=victims)
    eng.expire(before=-0.5)
    mem0 = _memory(dev)
    print(f"warmup done; device memory allocated {mem0}", flush=True)

    # --- phase MIXED: sustained interleaving
    log = _SearchLog(eng, dev)
    lat, lat_during_save, events = [], [], []
    removed_total = expired_total = 0
    snap = None
    save_handle = None
    save_t0 = save_s = None
    snap_ref = None
    queries = None
    t_mix = time.perf_counter()
    for i in range(args.batches):
        q0 = (i * args.qbatch) % (len(qpool) - args.qbatch + 1)
        save_in_flight = save_handle is not None and not save_handle.done()
        queries = qpool[q0: q0 + args.qbatch]
        t0 = time.perf_counter()
        D, I = log.search(queries, k=args.k)  # host arrays: the search has finished
        float(D[:, 0].sum())
        (lat_during_save if save_in_flight else lat).append(time.perf_counter() - t0)
        if save_handle is not None and save_s is None and save_handle.done():
            save_s = time.perf_counter() - save_t0

        batch = [d[0] for d in stream[i * args.ibatch:(i + 1) * args.ibatch]]
        t0 = time.perf_counter()
        eng.add_sessions(batch, stamp=float(i))
        events.append(("ingest", time.perf_counter() - t0))

        if args.remove_every and (i + 1) % args.remove_every == 0:
            # content-keyed removal of a random slice of the corpus
            rs = np.random.default_rng(i)
            idx = rs.choice(len(eng.sessions), size=args.ibatch, replace=False)
            vict = [eng.sessions[j] for j in idx]
            t0 = time.perf_counter()
            removed_total += eng.remove_sessions(data=vict)
            events.append(("remove", time.perf_counter() - t0))
        if args.expire_every and (i + 1) % args.expire_every == 0:
            # TTL: drop streamed rows older than a sliding window
            t0 = time.perf_counter()
            expired_total += eng.expire(before=float(i - args.expire_every))
            events.append(("expire", time.perf_counter() - t0))
        if i == args.batches // 2:
            # non-blocking snapshot mid-run: capture, start the background
            # write, keep serving; restore and the parity check come after
            # the mixed phase, so the rollback does not touch the window
            prefix = os.path.join(args.workdir, "soak_snap")
            Db, Ib = log.search(fixed_q, k=args.k)
            snap_ref = (Db, Ib)
            save_t0 = time.perf_counter()
            eng_capture_ntotal = eng.index.ntotal
            save_handle = eng.save_async(prefix)
            events.append(("snapshot_capture", time.perf_counter() - save_t0))
            print(f"  snapshot@{i}: capture+dispatch "
                  f"{time.perf_counter() - save_t0:.2f}s (write streams in "
                  "the background; serving continues)", flush=True)
    mix_s = time.perf_counter() - t_mix
    ntotal_end = eng.index.ntotal
    if keep is not None:
        keep.update(engine=eng, sessions_end=list(eng.sessions), queries=queries)
    if save_handle is not None:
        save_handle.join()
        if save_s is None:  # the write outlived the mixed phase
            save_s = time.perf_counter() - save_t0
        t0 = time.perf_counter()
        eng.restore(os.path.join(args.workdir, "soak_snap"))
        t_restore = time.perf_counter() - t0
        Da, Ia = log.search(fixed_q, k=args.k)
        same = bool(np.array_equal(snap_ref[1], Ia))
        snap = {"save_s": round(save_s, 2),
                "restore_s": round(t_restore, 2),
                "search_identical_after_restore": same,
                "search_batches_during_save": len(lat_during_save),
                "ntotal": eng_capture_ntotal}
        print(f"  snapshot: save {save_s:.1f}s (non-blocking, "
              f"{len(lat_during_save)} search batches served during it) "
              f"restore {t_restore:.1f}s identical={same}", flush=True)
    mem1 = _memory(dev)
    k1 = log.summary()

    ev = {}
    for kind, dt in events:
        ev.setdefault(kind, []).append(dt * 1e3)
    search = _pct(lat, args.qbatch)
    search_during_save = (_pct(lat_during_save, args.qbatch) if lat_during_save else None)
    report = {
        "rows": args.rows,
        "dim": dim,
        "capacity": capacity,
        "mesh_devices": getattr(args, "mesh", 0) or None,
        "ntotal_end": ntotal_end,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "setup_s": round(t_setup, 1),
        "fill_s": round(fill_s, 1),
        "ingest_sessions_per_s": round(ingest_rate, 0),
        "mixed_batches": args.batches,
        "mixed_wall_s": round(mix_s, 1),
        "sustained_mixed_qps": round(args.batches * args.qbatch / mix_s, 1),
        "search": search,
        "search_during_save": search_during_save,
        "ops_ms": {
            k: {"mean": round(float(np.mean(v)), 1),
                "max": round(float(np.max(v)), 1), "n": len(v)}
            for k, v in sorted(ev.items())
        },
        "removed_rows": removed_total,
        "expired_rows": expired_total,
        "snapshot": snap,
        "kernel_path_flat": k1["flat"],
        "k1_launches": k1,
        "memory_allocated_after_warmup": mem0,
        "memory_allocated_end": mem1,
        "memory_flat": None if mem0 is None else mem1 - mem0 <= MEMORY_SLACK,
        "engine_stats": {k: v for k, v in eng.stats().items() if k in ("ntotal", "pending")},
    }
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--asin-num", type=int, default=50_000)
    ap.add_argument("--fill-chunk", type=int, default=8192)
    ap.add_argument("--batches", type=int, default=80, help="mixed-phase iterations")
    ap.add_argument("--qbatch", type=int, default=256)
    ap.add_argument("--ibatch", type=int, default=256)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--embed-batch", type=int, default=1024)
    ap.add_argument("--remove-every", type=int, default=10)
    ap.add_argument("--expire-every", type=int, default=20)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard the engine over this many shards (0 = one device)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--tiny-model", action="store_true",
                    help="tiny encoder widths but caller-chosen rows/batches")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.workdir is None:
        args.workdir = tempfile.mkdtemp(prefix="soak_")
    report = run_soak(args)
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    if not report["kernel_path_flat"]:
        print(f"WARNING: the kernel path changed during the mixed phase: "
              f"{report['k1_launches']}", file=sys.stderr)
        return 1
    if report["memory_flat"] is False:
        print(f"WARNING: device memory grew during the mixed phase "
              f"({report['memory_allocated_after_warmup']} -> "
              f"{report['memory_allocated_end']})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
