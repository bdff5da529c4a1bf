#!/usr/bin/env python3
"""Where the time of the Hopper kernels goes: K1's bf16 wgmma variant
(``csrc/scores_bmax_sm90.cu``), the same kernel fed by cp.async for rows
TMA cannot describe (``csrc/sm90_cp_async.cuh``), K1's f32 wgmma variant
(``csrc/scores_bmax_f32_sm90.cu``, the 3xTF32 split), K4
(``csrc/packed_scores_bmax.cu``), K2's wgmma variant
(``csrc/scores_bmax_int8_sm90.cu``) and K5's wgmma variant
(``csrc/hamming_bucket_min_sm90.cu``), each timed beside copies of itself
with one part changed, at the bench points of ``chip_smoke.py`` (q=1024,
n=2^20; K1 d=1600 bf16 -> bf16, K1's cp_async variant d=250 +-1 codes ->
bf16 (the sign-mode shape), K1 f32 d=1600 f32 -> f32 on f32 unit rows, K4
256 bits -> bf16, K2 d=1600 int8 -> f32, the int8x8 index's score dtype,
K5 256 bits (8 words) row-major, no penalty; ``--k5-words`` times K5 at
other widths too, ``--k4-bits`` K4, with f32 scores above 256 bits).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 kernel_ablation.py [--parent DIR] [--only k5 ...] [--k5-words 4 8 ...]
                               [--k4-bits 256 2048 ...]

``--only`` builds and times the named kernels alone (k1, k1cp, k1f32, k4,
k2, k5; all by default).

Each copy is the source in ``csrc/`` with one text substitution, built with
the package's nvcc flags into its own library under the git-ignored
``_build/ablation/``; nothing in the package changes. ``--parent DIR`` adds
a copy ``parent`` of K1 and K4 built from the sources of another checkout
(``DIR/sessionsimilaritysearch_tpu_torch/csrc``), timed in the same rounds:
the way to compare a change with the commit before it on one card. The
copies:

- ``no_store``: the epilogue skips its score store (bmax is still written);
- ``mask_always``: the epilogue masks every bucket, not only those that
  reach ``valid_count`` or carry a penalty;
- K1 ``wait_group_1``: each slot is released one K slice later, with one
  wgmma group kept in flight;
- K1 cp_async ``no_copy``: the producer starts no cp.async (the ring holds
  stale bytes; groups, fences and arrivals stay): the consumers' and the
  epilogue's share;
- K1 cp_async ``zero_fill``: every copy has src-size 0 (zeros written, no
  device memory read): the instructions' share without the reads;
- K1 cp_async ``no_l2_prefetch``: the copies without the ``.L2::128B``
  prefetch hint;
- K1 cp_async ``no_consumer_fence``: the consumers skip the async-proxy
  fence after their full-barrier wait (CUTLASS's cp.async + GMMA mainloop
  fences nowhere);
- K1 cp_async ``wait_group_lag2`` / ``wait_group_lag1``: the first design of
  the completion, one cp.async group per slot, each thread waiting for the
  group two or one slots back, fencing its writes and arriving itself,
  instead of the noinc arrivals;
- K1 cp_async ``tile``: not a copy, the tile loop (``csrc/scores_bmax.cu``)
  through its C entry point, timed in the same rounds;
- K4 ``no_epilogue``: the consumers skip the epilogue;
- K4 ``no_unpack``: the producer skips the unpack (the ring holds stale
  bytes);
- K4 ``stream``: the streamed layout (row-major corpus, query slices
  through the ring) at every width, not only where the resident layout
  cannot stage the pack block's words; ``stream_no_qcopy``: the same
  without the query slices' bulk copies (stale A slots);
  ``stream_no_load``: its producer copying no corpus words (it unpacks
  stale raw slots); ``stream_no_relayout``: the corpus
  not written row-major first (the scan reads stale scratch);
  ``stream_no_unpack``: its producer storing no corpus slice (unless a
  word is 0x12345678);
- K2 ``no_epilogue``: the consumers skip the epilogue (products only);
- K2 ``scales_in_epilogue``: each bucket's scales are read in the
  epilogue, behind branches on n, not at the tile's start (the first
  design);
- K2 ``no_dequant``: the epilogue converts the int32 dots to f32 and
  multiplies by no scale (the scale loads, then unused, go too);
- K1 f32 ``one_pass``: the two small-term products go (A_big x B_big only;
  the split itself still runs): the share of the products;
- K1 f32 ``no_split``: the producer warpgroup's splitter warps write no
  small parts (the consumers read stale bytes);
- K1 f32 ``no_promote``: one wgmma chain over the whole depth, its sum in
  the tensor core's own accumulation, instead of one chain per 32-deep K
  slice added into a register sum with round-to-nearest adds;
- K1 f32 ``a_in_smem``: the two products with A_big read A from shared
  memory (wgmma's SS form), not from the registers the split already
  loaded (the first design);
- K1 f32 ``tile``: not a copy, the tile loop (``csrc/scores_bmax.cu``, exact
  FMA) through its C entry point, timed in the same rounds;
- K5 ``no_unpack``: the producer unpacks nothing (the ring holds stale
  bytes; the bulk copies, fences and arrivals stay): the products, loads
  and epilogue alone;
- K5 ``no_min``: the epilogue stores nothing (so the compiler drops the
  minimum too): the products and the unpack alone;
- K5 ``no_mma``: the consumers issue no wgmma (groups, waits and the
  epilogue stay): the producer's and the epilogue's share;
- K5 ``skeleton``: no unpack and no wgmma: the barriers, the bulk copies,
  the loop and the epilogue on stale accumulators;
- K5 ``mma_only``: no unpack, no epilogue, no bulk copy: the products and
  the barriers alone;
- K5 ``stages8``: a ring of up to 8 slots, not 4;
- K5 ``one_acc``: one accumulator per consumer warpgroup (128 queries a
  tile), not two (256);
- K5 ``stream``: the query slices streamed (the kernel of codes no
  resident tile holds) at every width; ``stream_no_load``: the same, its
  producer making each word from its row and column instead of loading
  it; ``stream_no_qunpack``: the same, its consumers storing no query
  slice (stale A buffers; the loads and barriers stay);
- K5 ``popc``: not a copy, K5's popc variant (``csrc/hamming_bucket_min.cu``)
  through its C entry point, timed in the same rounds.

Copies that keep the output (``mask_always``, ``wait_group_1``, ``parent``,
``scales_in_epilogue``, ``no_l2_prefetch``, ``no_consumer_fence``,
``wait_group_lag2``, ``wait_group_lag1``; K1 cp_async's ``tile``; K4's
``stream``; K5's ``stages8``, ``one_acc``, ``stream``
and ``popc``) must equal the kernel's output; the others are diagnostics
only. For K1 f32 each copy's largest |score - f64| on the two
cases of the accuracy gate is printed beside cuBLAS SGEMM's. Every kernel
runs three rounds in turns, each the mean of 10 launches between CUDA
events, beside one library call (cuBLAS bf16 GEMM; for K4 on the unpacked +-1 rows; for
K2 ``torch._int_mm``; for K1 f32 cuBLAS SGEMM, TF32 off; none for K5), with the SM
clock and power that ``nvidia-smi`` reads after each round. The last line
is a JSON object of all times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))

STORE = "__stcs(reinterpret_cast<int4*>(dst), *reinterpret_cast<const int4*>(src));"
MASK = "const bool masked = penalty != nullptr || c0 + BUCKET > valid_count;"
K1_LOOP = """        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[ring.slot]);
        ring.advance(ST);
      }"""
K1_WAIT = "          wgmma_wait<0>();\n          fence_regs(acc);\n        }\n"

# K2's first design: each bucket's scales read in the epilogue, behind
# branches on n
K2_EPILOGUE_SCALES = """for (int j = 0; j < 64; j += 4) {
              const int col = c0 + (j / 4) * 8 + (lane % 4) * 2;
              float s0 = 0.f, s1 = 0.f;
              if (col + 1 < n) {
                const float2 s = __ldg(reinterpret_cast<const float2*>(scales + col));
                s0 = s.x;
                s1 = s.y;
              } else if (col < n) {
                s0 = __ldg(scales + col);
              }
              v[j] = __fmul_rn(__int2float_rn(acc[h][j]), s0);
              v[j + 1] = __fmul_rn(__int2float_rn(acc[h][j + 1]), s1);
              v[j + 2] = __fmul_rn(__int2float_rn(acc[h][j + 2]), s0);
              v[j + 3] = __fmul_rn(__int2float_rn(acc[h][j + 3]), s1);
            }"""

F32_RS = "wgmma_m64n128k8_tf32_rs(acc, as[kk], db + 2 * kk, kk > 0);"
F32_SMALL_B = "wgmma_m64n128k8_tf32_rs(acc, ab[kk], ds + 2 * kk, 1);"
F32_BIG = "wgmma_m64n128k8_tf32_rs(acc, ab[kk], db + 2 * kk, 1);"
# the descriptor of this warpgroup's query rows in the slot, from db's
F32_DA = "(db - ((A_BYTES - (int)(threadIdx.x / WG) * 64 * K_BYTES) >> 4))"
# the tf32 wgmma with A from shared memory, which the shipped kernel does not use
F32_SS = """using namespace sm90;

__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t a, uint64_t b,
                                                     int scale_d) {
  asm volatile(
      "{\\n .reg .pred p;\\n setp.ne.b32 p, %66, 0;\\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " SM90_ACC64_REGS
      ", %64, %65, p, 1, 1;\\n}\\n"
      : SM90_ACC64_F32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}"""

CP_LOOP = "for (int i = 0; i < ROWS / 4; i += 2) {"
CP_LIVE = "if (col < d) live = max(0, min(ROWS / 4, (rows - row0 - warp + 3) / 4));"
CP_ASM = "cp.async.ca.shared.global.L2::128B [%0], [%1], 4, %2;"
CP_ARRIVE = "      cp_async_arrive_noinc(&full[ring.slot]);\n      ring.advance(ST);"
CP_RING = "  const uint32_t ring0 = smem_u32(smem);\n  Ring ring;"
CP_FENCE = "        if constexpr (!Ops::TMA) fence_proxy_async();"


def cp_wait_group(lag):
    """The producer's first design: one cp.async group per slot; a thread
    waits for the group `lag` slots back, fences its own writes for the
    async proxy and arrives on that slot's full barrier; the last groups
    drain at the end."""
    return {
        CP_RING: CP_RING.replace("Ring ring;", "Ring ring, done;\n  int pending = 0;"),
        CP_ARRIVE: f"""      asm volatile("cp.async.commit_group;\\n" ::: "memory");
      ring.advance(ST);
      if (++pending > {lag}) {{
        asm volatile("cp.async.wait_group {lag};\\n" ::: "memory");
        fence_proxy_async();
        mbar_arrive(&full[done.slot]);
        done.advance(ST);
        --pending;
      }}""",
        "  cp_async_wait_all();  // no copy outlives its thread": """  cp_async_wait_all();
  fence_proxy_async();
  for (; pending > 0; --pending) {
    mbar_arrive(&full[done.slot]);
    done.advance(ST);
  }""",
    }


# kernel -> copy -> ({old: new} in the kernel's source, {old: new} in the one
# header of csrc/ that holds `old`)
# K4's streamed layout at every width, with the substitutions of each named
# part: the dispatch's test for the resident layout, then one part off
K4_STREAM = {
    "force": {"  if (bits <= MAX_SMEM / (PACK_ROWS * 4) && layout<S>(2, bits).bytes <= MAX_SMEM)":
              "  if (false)"},
    "no_qcopy": {"        mbar_arrive_expect_tx(&full[ring.slot], BQ * KS);\n"
                 "        bulk_load(qa + ring.slot * BQ * KS, src, BQ * KS, &full[ring.slot]);":
                 "        mbar_arrive(&full[ring.slot]);\n        (void)src;"},
    "no_load": {"        cp_async16(raw + slot * BUCKET * 16, rm + row * k_slices + c.ks);":
                "        (void)row;"},
    "no_relayout": {"  relayout_rows_kernel<<<n / 32, 256, 0, stream>>>(": "  if (false)\n"
                    "  relayout_rows_kernel<<<n / 32, 256, 0, stream>>>("},
    "no_unpack": {"      store_unpacked(dst, pt, 0, v0.x);": "      if (v0.x == 0x12345678u) {\n"
                  "      store_unpacked(dst, pt, 0, v0.x);",
                  "      store_unpacked(dst, pt, 3, v0.w);": "      store_unpacked(dst, pt, 3, v0.w);\n"
                  "      }"},
}


def k4_stream(*parts):
    """A K4 copy on the streamed layout with each named part switched off."""
    return ({old: new for part in ("force", *parts) for old, new in K4_STREAM[part].items()},
            {})


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
    "k1cp": {
        "base": ({}, {}),
        "no_copy": ({}, {CP_LOOP: "for (int i = 0; i < 0; i += 2) {"}),
        "zero_fill": ({}, {CP_LIVE: CP_LIVE.replace("col < d", "col < 0")}),
        "no_l2_prefetch": ({}, {CP_ASM: CP_ASM.replace(".L2::128B", "")}),
        "no_consumer_fence": ({CP_FENCE: ""}, {}),
        "wait_group_lag2": ({}, cp_wait_group(2)),
        "wait_group_lag1": ({}, cp_wait_group(1)),
    },
    "k4": {
        "base": ({}, {}),
        "no_store": ({}, {STORE: "if (c0 < 0) " + STORE}),
        "mask_always": ({}, {MASK: "const bool masked = true;"}),
        "no_epilogue": ({"        if (active) {\n          float v[64];":
                         "        if (active && b < 0) {\n          float v[64];"}, {}),
        "no_unpack": ({"for (int i = 0; i < 16; ++i) {":
                       "for (int i = 0; i < (j > 99u ? 16 : 0); ++i) {"}, {}),
        "stream": k4_stream(),
        "stream_no_qcopy": k4_stream("no_qcopy"),
        "stream_no_load": k4_stream("no_load"),
        "stream_no_relayout": k4_stream("no_relayout"),
        "stream_no_unpack": k4_stream("no_unpack"),
    },
    "k2": {
        "base": ({}, {}),
        "no_store": ({}, {STORE: "if (c0 < 0) " + STORE}),
        "no_epilogue": ({"          if (c0 < n) {": "          if (c0 < 0) {"}, {}),
        "scales_in_epilogue": ({"      load_scales(sc, scales, n0, n);\n": "",
                                "dequantise(acc[h], sc[h], v);": K2_EPILOGUE_SCALES}, {}),
        "no_dequant": ({"dequantise(acc[h], sc[h], v);":
                        "for (int j = 0; j < 64; ++j) v[j] = __int2float_rn(acc[h][j]);"},
                       {}),
    },
    "k1f32": {
        "base": ({}, {}),
        "one_pass": ({F32_RS: "if (kk < 0) " + F32_RS, F32_SMALL_B: "if (kk < 0) " + F32_SMALL_B,
                      F32_BIG: F32_BIG.replace(", 1);", ", kk > 0);")}, {}),
        "no_split": ({"for (int i = st; i < TB / 16; i += SPLITTERS)":
                      "for (int i = st; i < 0; i += SPLITTERS)"}, {}),
        "no_promote": ({F32_RS: F32_RS.replace("kk > 0", "1"),
                        "sum[i] = 0.f;": "sum[i] = acc[i] = 0.f;",
                        "sum[i] = __fadd_rn(sum[i], acc[i]);": "sum[i] = acc[i];"}, {}),
        "no_store": ({}, {STORE: "if (c0 < 0) " + STORE}),
        "a_in_smem": ({"using namespace sm90;": F32_SS,
                       F32_SMALL_B:
                           f"wgmma_m64n128k8_tf32(acc, {F32_DA} + 2 * kk, ds + 2 * kk, 1);",
                       F32_BIG: f"wgmma_m64n128k8_tf32(acc, {F32_DA} + 2 * kk, db + 2 * kk, 1);"},
                      {}),
    },
}
K5_WGMMA = "wgmma_m64n128k32_s8(acc[h], a_desc + 512 * h + 2 * kk, b_desc + 2 * kk,"
K5_PART = {
    "no_unpack": {"for (int m = 0; m < BUCKET / 32; ++m) {": "for (int m = 0; m < 0; ++m) {"},
    "no_min": {"if (lane % 4 == 0) {": "if (lane % 4 == 0 && n_buckets < 0) {"},
    "no_mma": {K5_WGMMA: "if (kk < 0) " + K5_WGMMA},
    "force_stream": {"  if (words <= MAX_SMEM / (128 * KS) * SLICE_WORDS) {": "  if (false) {"},
    "no_load": {"v[m] = w < words && row < n ? __ldg(c_codes + (size_t)row * words + w) : 0u;":
                "v[m] = w < words && row < n ? (uint32_t)row * 0x9E3779B9u + w : 0u;"},
    "no_qunpack": {"        if (real)\n          store_unpacked(row, r, qwi, p[j]);\n"
                   "        else\n          store_zero(row, r, qwi);": "        (void)row;"},
    "no_fetch": {"      if (b >= full_buckets) return;": "      return;",
                 "        mbar_wait(&raw_full[buf * 4 + pw], (raw_phase >> buf) & 1u);\n": ""},
}


def k5_copy(*parts):
    """A K5 copy with the substitutions of each named part."""
    return ({old: new for part in parts for old, new in K5_PART[part].items()}, {})


VARIANTS["k5"] = {
    "base": ({}, {}),
    "no_unpack": k5_copy("no_unpack"),
    "no_min": k5_copy("no_min"),
    "no_mma": k5_copy("no_mma"),
    "skeleton": k5_copy("no_unpack", "no_mma"),
    "mma_only": k5_copy("no_unpack", "no_min", "no_fetch"),
    "stages8": ({"constexpr int MAX_STAGES = 4;": "constexpr int MAX_STAGES = 8;"}, {}),
    "one_acc": ({"    if (layout(256, words, st).bytes <= MAX_SMEM)": "    if (false)"}, {}),
    "stream": k5_copy("force_stream"),
    "stream_no_load": k5_copy("force_stream", "no_load"),
    "stream_no_qunpack": k5_copy("force_stream", "no_qunpack"),
}
SOURCES = {"k1": "scores_bmax_sm90.cu", "k1cp": "scores_bmax_sm90.cu",
           "k4": "packed_scores_bmax.cu",
           "k2": "scores_bmax_int8_sm90.cu", "k1f32": "scores_bmax_f32_sm90.cu",
           "k5": "hamming_bucket_min_sm90.cu"}
# each kernel's C entry point: queries, corpus or words, (K2: scales,)
# penalty, scores, bmax (pointers); q, n, d or bits, valid_count, out_bf16;
# stream
ENTRY = {"k1": "sss_scores_bmax_sm90", "k1cp": "sss_scores_bmax_cp_sm90",
         "k4": "sss_packed_scores_bmax",
         "k2": "sss_scores_bmax_int8_sm90", "k1f32": "sss_scores_bmax_f32_sm90",
         "k5": "sss_hamming_bucket_min_sm90"}
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
ARGTYPES_K2 = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# K5: q codes, corpus codes, penalty, bmin; q, n, words; stream
ARGTYPES_K5 = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def build(_build, parent=None, only=tuple(VARIANTS)):
    """Write and compile every copy side by side, each beside copies of the
    headers of csrc/ (each header substitution applied to the header that
    holds its target);
    {(kernel, name): the copy's entry point}. ``parent``: the csrc/ of
    another checkout, whose K1 and K4 become the copy ``parent``."""
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}

    def copy(kernel, name, csrc, subs, hsubs):
        d = out_dir / f"{kernel}_{name}"
        d.mkdir(exist_ok=True)
        src = (csrc / SOURCES[kernel]).read_text()
        for old, new in subs.items():
            if old not in src:
                raise SystemExit(f"{kernel} {name}: substitution target not found")
            src = src.replace(old, new)
        (d / "kernel.cu").write_text(src)
        headers = {h.name: h.read_text() for h in csrc.glob("*.cuh")}
        for old, new in hsubs.items():
            holders = [h for h, text in headers.items() if old in text]
            if len(holders) != 1:
                raise SystemExit(f"{kernel} {name}: header target found in {holders}")
            headers[holders[0]] = headers[holders[0]].replace(old, new)
        for h, text in headers.items():
            (d / h).write_text(text)
        libs[kernel, name] = d / "lib.so"
        cmds.append([_build._find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     str(libs[kernel, name]), str(d / "kernel.cu")])

    for kernel, variants in VARIANTS.items():
        if kernel not in only:
            continue
        for name, (subs, hsubs) in variants.items():
            copy(kernel, name, _build.CSRC, subs, hsubs)
        if parent is not None and kernel in ("k1", "k4"):
            copy(kernel, "parent", parent, {}, {})
    _build._run_all(cmds)
    entries = {}
    for (kernel, name), path in libs.items():
        fn = getattr(ctypes.CDLL(str(path)), ENTRY[kernel])
        fn.argtypes = {"k2": ARGTYPES_K2, "k5": ARGTYPES_K5}.get(kernel, ARGTYPES)
        fn.restype = ctypes.c_int
        entries[kernel, name] = fn
    return entries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose K1 and K4 are timed beside this tree's")
    ap.add_argument("--only", nargs="+", choices=sorted(VARIANTS), default=sorted(VARIANTS),
                    help="the kernels to build and time (default: all)")
    ap.add_argument("--k5-words", nargs="+", type=int, default=[8],
                    help="K5's code widths in int32 words (default: 8, the bench point)")
    ap.add_argument("--k4-bits", nargs="+", type=int, default=[256],
                    help="K4's code widths in bits (default: 256, the bench point)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from sessionsimilaritysearch_tpu_torch.ops import _build, mips_int8, packed

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card: {card}")
    parent = None
    if args.parent is not None:
        parent = args.parent / "sessionsimilaritysearch_tpu_torch" / "csrc"
        if not parent.is_dir():
            raise SystemExit(f"--parent: {parent} is not a directory")
    entries = build(_build, parent, args.only)
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

    def smi():
        return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()

    g = torch.Generator(device=dev).manual_seed(0)
    q_n, n, d, bits = 1024, 1 << 20, 1600, 256
    times = {}

    def run(kernel, launch, library, score_dtype=torch.bfloat16, key=None):
        key = key or kernel
        names = [name for (k, name) in entries if k == kernel]
        outs, res, state = {}, {}, []
        for rnd in range(3):
            for name in names:
                s = torch.empty(q_n, n, dtype=score_dtype, device=dev)
                bm = torch.empty(q_n, n // 128, device=dev)
                fn = launch(entries[kernel, name], s, bm)
                err = fn()
                if err != 0:
                    raise SystemExit(f"{kernel} {name}: launch failed with {err}")
                res.setdefault(name, []).append(ms(fn))
                outs[name] = (s, bm)
                del s, bm
            res.setdefault("library", []).append(ms(library))
            state.append(smi())
        base = outs["base"]
        same = ("mask_always", "wait_group_1", "parent", "scales_in_epilogue",
                "no_l2_prefetch", "no_consumer_fence", "wait_group_lag2", "wait_group_lag1")
        same += ("stream",) if kernel == "k4" else ()
        for name in same + (("tile",) if kernel == "k1cp" else ()):
            if name in outs and not (torch.equal(outs[name][0], base[0])
                                     and torch.equal(outs[name][1], base[1])):
                raise SystemExit(f"{key} {name}: output differs from the kernel's")
        for name, t in res.items():
            print(f"{key} {name}: " + " / ".join(f"{x:.3f}" for x in t) + " ms")
        print(f"{key} SM clock, power after each round: " + " / ".join(state))
        times[key] = {**res, "smi": state}

    if "k1" in args.only:
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

    lib = _build.load_library()

    if "k1cp" in args.only:
        def tile_bf16(qp, cp, pen, sp, bp, q_, n_, d_, vc, out_bf16, st):
            return lib.sss_scores_bmax(qp, cp, pen, sp, bp, q_, n_, d_, vc, 1, out_bf16, st)

        # K1's cp_async variant at the sign-mode shape: +-1 codes of 250 bits
        # (rows 500 bytes apart), bf16 scores; the tile loop in the same rounds
        entries["k1cp", "tile"] = tile_bf16
        codes = torch.where(torch.rand(n, 250, generator=g, device=dev) < 0.5, 1.0, -1.0).bfloat16()
        signs = torch.where(torch.rand(q_n, 250, generator=g, device=dev) < 0.5,
                            1.0, -1.0).bfloat16()
        run("k1cp", lambda fn, s, bm: lambda: fn(
            signs.data_ptr(), codes.data_ptr(), None, s.data_ptr(), bm.data_ptr(),
            q_n, n, 250, n, 1, stream),
            lambda: torch.matmul(signs, codes.T))
        del codes, signs
        torch.cuda.empty_cache()

    if "k1f32" in args.only:
        # K1 f32: f32 unit rows (every mantissa bit in use); the tile loop in the
        # same rounds through its own entry point
        corpus32 = torch.empty(n, d, device=dev)
        for s0 in range(0, n, 1 << 16):
            r = torch.randn(1 << 16, d, generator=g, device=dev)
            corpus32[s0: s0 + (1 << 16)] = r / r.norm(dim=1, keepdim=True)
        queries32 = torch.randn(q_n, d, generator=g, device=dev)
        queries32 = queries32 / queries32.norm(dim=1, keepdim=True)

        def tile(qp, cp, pen, sp, bp, q_, n_, d_, vc, out_bf16, st):
            return lib.sss_scores_bmax(qp, cp, pen, sp, bp, q_, n_, d_, vc, 0, out_bf16, st)

        entries["k1f32", "tile"] = tile
        run("k1f32", lambda fn, s, bm: lambda: fn(
            queries32.data_ptr(), corpus32.data_ptr(), None, s.data_ptr(), bm.data_ptr(),
            q_n, n, d, n, 0, stream),
            lambda: torch.matmul(queries32, corpus32.T), torch.float32)
        del corpus32, queries32
        torch.cuda.empty_cache()

        # each f32 copy's largest |score - f64| on the two cases of the accuracy
        # gate (chip_smoke.py phase 4c): 1024 x 65,536 unit rows at d=1600 and
        # standard-normal rows at d=200, beside cuBLAS SGEMM's
        errs, m = {}, 1 << 16
        for d_g, unit in ((d, True), (200, False)):
            qg = torch.randn(q_n, d_g, generator=g, device=dev)
            cg = torch.randn(m, d_g, generator=g, device=dev)
            if unit:
                qg, cg = qg / qg.norm(dim=1, keepdim=True), cg / cg.norm(dim=1, keepdim=True)
            exact = qg.double() @ cg.double().T
            row = {}
            for (kernel, name), fn in entries.items():
                if kernel != "k1f32" or name in ("no_split", "no_store"):
                    continue  # copies that write no valid scores
                s = torch.empty(q_n, m, device=dev)
                bm = torch.empty(q_n, m // 128, device=dev)
                if fn(qg.data_ptr(), cg.data_ptr(), None, s.data_ptr(), bm.data_ptr(), q_n, m,
                      d_g, m, 0, stream) != 0:
                    raise SystemExit(f"k1f32 {name}: launch failed at d={d_g}")
                row[name] = (s.double() - exact).abs().max().item()
            row["library"] = (torch.matmul(qg, cg.T).double() - exact).abs().max().item()
            errs[f"d{d_g}"] = row
            print(f"k1f32 largest |score - f64| at d={d_g}: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in row.items()))
            del exact
        times["k1f32_err"] = errs

    for k4_bits in args.k4_bits if "k4" in args.only else ():
        # bf16 scores up to 256 bits, f32 above (as packed.packed_topk asks)
        out_bf16 = int(k4_bits <= 256)
        words = torch.randint(-2**31, 2**31 - 1, (n // 32, k4_bits), generator=g, device=dev,
                              dtype=torch.int32)
        codes = torch.where(torch.rand(q_n, k4_bits, generator=g, device=dev) < 0.5,
                            1.0, -1.0).bfloat16()
        rows = packed.unpack_bits_t(words)
        run("k4", lambda fn, s, bm: lambda: fn(
            codes.data_ptr(), words.data_ptr(), None, s.data_ptr(), bm.data_ptr(),
            q_n, n, k4_bits, n, out_bf16, stream),
            lambda: torch.matmul(codes, rows.T),
            torch.bfloat16 if out_bf16 else torch.float32,
            key="k4" if k4_bits == bits else f"k4_b{k4_bits}")
        del words, codes, rows
        torch.cuda.empty_cache()

    if "k2" in args.only:
        # K2: unit rows quantized per row, as the int8x8 index stores them
        qc, _ = mips_int8.quantize_rows_int8(torch.randn(q_n, d, generator=g, device=dev))
        cc = torch.empty(n, d, dtype=torch.int8, device=dev)
        sc = torch.empty(n, device=dev)
        for s0 in range(0, n, 1 << 16):
            cc[s0: s0 + (1 << 16)], sc[s0: s0 + (1 << 16)] = mips_int8.quantize_rows_int8(
                torch.randn(1 << 16, d, generator=g, device=dev))
        run("k2", lambda fn, s, bm: lambda: fn(
            qc.data_ptr(), cc.data_ptr(), sc.data_ptr(), None, s.data_ptr(), bm.data_ptr(),
            q_n, n, d, n, 0, stream),
            lambda: torch._int_mm(qc, cc.T), torch.float32)
    if "k5" in args.only:
        # K5: random row-major codes (every bit in use), no penalty; the popc
        # variant through its C entry point in the same rounds
        k5 = {name: fn for (k, name), fn in entries.items() if k == "k5"}
        k5["popc"] = lib.sss_hamming_bucket_min
        for words in args.k5_words:
            key = "k5" if words == 8 else f"k5_w{words}"
            k5_q = torch.randint(-2**31, 2**31 - 1, (q_n, words), generator=g, device=dev,
                                 dtype=torch.int32)
            k5_c = torch.randint(-2**31, 2**31 - 1, (n, words), generator=g, device=dev,
                                 dtype=torch.int32)
            outs, res, state = {}, {}, []
            for _ in range(3):
                for name, fn in k5.items():
                    bmin = torch.empty(q_n, n // 128, dtype=torch.int32, device=dev)

                    def call(fn=fn, bmin=bmin, k5_q=k5_q, k5_c=k5_c, words=words):
                        return fn(k5_q.data_ptr(), k5_c.data_ptr(), None, bmin.data_ptr(), q_n,
                                  n, words, stream)

                    if call() != 0:
                        raise SystemExit(f"{key} {name}: launch failed")
                    res.setdefault(name, []).append(ms(call))
                    outs[name] = bmin
                state.append(smi())
            for name in ("stages8", "one_acc", "stream", "popc"):
                if not torch.equal(outs[name], outs["base"]):
                    raise SystemExit(f"{key} {name}: output differs from the kernel's")
            bound = 2 * q_n * n * 32 * words / 1979e12 * 1e3  # +-1 products at the s8 rate
            print(f"{key}: {words} words, bound {bound:.3f} ms")
            for name, t in res.items():
                print(f"{key} {name}: " + " / ".join(f"{x:.3f}" for x in t) + " ms")
            print(f"{key} SM clock, power after each round: " + " / ".join(state))
            times[key] = {**res, "smi": state, "bound_ms": bound}
            del k5_q, k5_c, outs
    print(json.dumps({"card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
