#!/usr/bin/env python3
"""Where the time of the Hopper kernels goes: K1's wgmma variant
(``csrc/scores_bmax_sm90.cu``) and K4 (``csrc/packed_scores_bmax.cu``), each
timed beside copies of itself with one part changed, at the bench points of
``chip_smoke.py`` (q=1024, n=2^20; K1 d=1600 bf16 -> bf16, K4 256 bits ->
bf16).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 kernel_ablation.py

Each copy is the source in ``csrc/`` with one text substitution, built with
the package's nvcc flags into its own library under the git-ignored
``_build/ablation/``; nothing in the package changes. The copies:

- ``no_store``: the epilogue skips its score store (bmax is still written);
- ``mask_always``: the epilogue masks every bucket, not only those that
  reach ``valid_count`` or carry a penalty;
- K1 ``wait_group_1``: each slot is released one K slice later, with one
  wgmma group kept in flight;
- K4 ``no_epilogue``: the consumers skip the epilogue;
- K4 ``no_unpack``: the producer skips the unpack (the ring holds stale
  bytes).

Copies that keep the output (``mask_always``, ``wait_group_1``) must equal
the kernel's output; the others are diagnostics only. Every kernel runs two
rounds in turns, each the mean of 10 launches between CUDA events, beside
one library call (cuBLAS bf16 GEMM; for K4 on the unpacked +-1 rows). The
last line is a JSON object of all times.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

STORE = "__stcs(reinterpret_cast<int4*>(dst), *reinterpret_cast<const int4*>(src));"
MASK = "const bool masked = penalty != nullptr || c0 + BUCKET > valid_count;"
K1_LOOP = """        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[ring.slot]);
        ring.advance(ST);
      }"""
K1_WAIT = "          wgmma_wait<0>();\n          fence_regs(acc);\n        }\n"

# kernel -> copy -> ({old: new} in the kernel's source, {old: new} in sm90_common.cuh)
VARIANTS = {
    "k1": {
        "base": ({}, {}),
        "no_store": ({}, {STORE: "if (c0 < 0) " + STORE}),
        "mask_always": ({}, {MASK: "const bool masked = true;"}),
        "wait_group_1": ({
            K1_WAIT: "          wgmma_wait<1>();\n          fence_regs(acc);\n        }\n",
            K1_LOOP: """        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = ring.slot;
        ring.advance(ST);
      }
      if (active) {
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);""",
            "      for (int ks = 0; ks < k_steps; ++ks) {\n        mbar_wait(&full":
                "      int prev = -1;\n      for (int ks = 0; ks < k_steps; ++ks) {\n"
                "        mbar_wait(&full",
        }, {}),
    },
    "k4": {
        "base": ({}, {}),
        "no_store": ({}, {STORE: "if (c0 < 0) " + STORE}),
        "mask_always": ({}, {MASK: "const bool masked = true;"}),
        "no_epilogue": ({"        if (active) {\n          float v[64];":
                         "        if (active && b < 0) {\n          float v[64];"}, {}),
        "no_unpack": ({"for (int i = 0; i < 16; ++i) {":
                       "for (int i = 0; i < (j > 99u ? 16 : 0); ++i) {"}, {}),
    },
}
SOURCES = {"k1": "scores_bmax_sm90.cu", "k4": "packed_scores_bmax.cu"}
# each kernel's C entry point: queries, corpus or words, penalty, scores,
# bmax (pointers); q, n, d or bits, valid_count, out_bf16; stream
ENTRY = {"k1": "sss_scores_bmax_sm90", "k4": "sss_packed_scores_bmax"}
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def build(_build):
    """Write and compile every copy side by side; {(kernel, name): the
    copy's entry point}."""
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    header = (_build.CSRC / "sm90_common.cuh").read_text()
    cmds, libs = [], {}
    for kernel, variants in VARIANTS.items():
        source = (_build.CSRC / SOURCES[kernel]).read_text()
        for name, (subs, hsubs) in variants.items():
            d = out_dir / f"{kernel}_{name}"
            d.mkdir(exist_ok=True)
            src, hdr = source, header
            for old, new in subs.items():
                if old not in src:
                    raise SystemExit(f"{kernel} {name}: substitution target not found")
                src = src.replace(old, new)
            for old, new in hsubs.items():
                if old not in hdr:
                    raise SystemExit(f"{kernel} {name}: header target not found")
                hdr = hdr.replace(old, new)
            (d / "kernel.cu").write_text(src)
            (d / "sm90_common.cuh").write_text(hdr)
            libs[kernel, name] = d / "lib.so"
            cmds.append([_build._find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                         str(libs[kernel, name]), str(d / "kernel.cu")])
    _build._run_all(cmds)
    entries = {}
    for (kernel, name), path in libs.items():
        fn = getattr(ctypes.CDLL(str(path)), ENTRY[kernel])
        fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
        entries[kernel, name] = fn
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from sessionsimilaritysearch_tpu_torch.ops import _build, packed

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card: {card}")
    entries = build(_build)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ms(fn, iters=10):
        fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    g = torch.Generator(device=dev).manual_seed(0)
    q_n, n, d, bits = 1024, 1 << 20, 1600, 256
    times = {}

    def run(kernel, launch, library):
        outs, res = {}, {}
        for rnd in range(2):
            for name in VARIANTS[kernel]:
                s = torch.empty(q_n, n, dtype=torch.bfloat16, device=dev)
                bm = torch.empty(q_n, n // 128, device=dev)
                fn = launch(entries[kernel, name], s, bm)
                err = fn()
                if err != 0:
                    raise SystemExit(f"{kernel} {name}: launch failed with {err}")
                res.setdefault(name, []).append(ms(fn))
                outs[name] = (s, bm)
            res.setdefault("library", []).append(ms(library))
        base = outs["base"]
        for name in ("mask_always", "wait_group_1"):
            if name in outs and not (torch.equal(outs[name][0], base[0])
                                     and torch.equal(outs[name][1], base[1])):
                raise SystemExit(f"{kernel} {name}: output differs from the kernel's")
        for name, t in res.items():
            print(f"{kernel} {name}: " + " / ".join(f"{x:.3f}" for x in t) + " ms")
        times[kernel] = res

    corpus = torch.randn(n, d, generator=g, device=dev)
    corpus = (corpus / corpus.norm(dim=1, keepdim=True)).bfloat16()
    queries = torch.randn(q_n, d, generator=g, device=dev)
    queries = (queries / queries.norm(dim=1, keepdim=True)).bfloat16()
    run("k1", lambda fn, s, bm: lambda: fn(
        queries.data_ptr(), corpus.data_ptr(), None, s.data_ptr(), bm.data_ptr(),
        q_n, n, d, n, 1, stream),
        lambda: torch.matmul(queries, corpus.T))
    del corpus, queries
    torch.cuda.empty_cache()

    words = torch.randint(-2**31, 2**31 - 1, (n // 32, bits), generator=g, device=dev,
                          dtype=torch.int32)
    codes = torch.where(torch.rand(q_n, bits, generator=g, device=dev) < 0.5,
                        1.0, -1.0).bfloat16()
    rows = packed.unpack_bits_t(words)
    run("k4", lambda fn, s, bm: lambda: fn(
        codes.data_ptr(), words.data_ptr(), None, s.data_ptr(), bm.data_ptr(),
        q_n, n, bits, n, 1, stream),
        lambda: torch.matmul(codes, rows.T))
    print(json.dumps({"card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
