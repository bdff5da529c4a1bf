#!/usr/bin/env python3
"""Dense search latency of this checkout against another one, on one card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 search_ab.py --parent DIR

``DIR`` is another checkout of the repository (for example the commit
before a change, unpacked with ``git archive`` into a git-ignored
directory). The two checkouts import the same package name, so each run
is a subprocess of this script (``--tree``) that builds its checkout's
kernels and times ``DenseIndex.search`` of 1024 seeded queries at k=100
on seeded rows of d=1600 in four layouts: bf16 at 2^20 rows in 65,536-row
chunks (the index default), bf16 at 2^20 rows as one chunk, f32 at 2^20
rows in 65,536-row chunks, bf16 at 32,768 rows. The runs go parent,
change, change, parent, so that a clock that drifts hits both alike; each
prints one JSON line with the median, minimum and p90 of 15 searches
(host clock between two ``torch.cuda.synchronize()``, after 3 warm-up
searches), and the last line is all four runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LAYOUTS = (("bf16_16chunks", "bfloat16", 1 << 20, 65536),
           ("bf16_1chunk", "bfloat16", 1 << 20, 1 << 20),
           ("f32_16chunks", "float32", 1 << 20, 65536),
           ("bf16_n32768", "bfloat16", 32768, 32768))
SEARCHES = 15


def time_tree(root: str, label: str) -> dict:
    """The search times of the checkout at ``root`` (run in a subprocess of
    its own)."""
    sys.path.insert(0, root)
    import torch

    from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex
    from sessionsimilaritysearch_tpu_torch.ops import _build

    _build.load_library()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": label}
    for name, dtype, n, chunk in LAYOUTS:
        dt = getattr(torch, dtype)
        idx = DenseIndex(1600, n, device=dev, dtype=dt, score_dtype=dt, chunk_size=chunk)
        for s in range(0, n, 1 << 17):
            idx.add(torch.randn(min(1 << 17, n - s), 1600, generator=g, device=dev))
        q = torch.randn(1024, 1600, generator=g, device=dev)
        for _ in range(3):
            idx.search(q, 100, out="device")
        ms = []
        for _ in range(SEARCHES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx.search(q, 100, out="device")
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        ms.sort()
        out[name] = {"median_ms": ms[len(ms) // 2], "min_ms": ms[0],
                     "p90_ms": ms[int(0.9 * len(ms))]}
        del idx
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--tree", nargs=2, metavar=("ROOT", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(time_tree(*args.tree)), flush=True)
        return 0
    if not args.parent or not os.path.isdir(os.path.join(
            args.parent, "sessionsimilaritysearch_tpu_torch")):
        ap.error("--parent must name another checkout of the repository")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card: {card}")
    runs = []
    for label in ("parent", "change", "change", "parent"):
        root = os.path.abspath(args.parent) if label == "parent" else HERE
        sub = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", root, label],
                             capture_output=True, text=True, timeout=900)
        if sub.returncode != 0:
            print(sub.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append(json.loads(sub.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
