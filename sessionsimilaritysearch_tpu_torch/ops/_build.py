"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources under ``csrc/`` compile at first use into one shared library
with a plain C interface, under ``_build/`` in the package directory (listed
in ``.gitignore``). Each ``.cu`` file compiles in its own ``nvcc`` process,
all started together, and one more ``nvcc`` links the objects. The library's
name carries a hash of the sources and the flags, so a second run reuses it
and an edit rebuilds it. A missing ``nvcc`` or a failed build raises with
the compiler's output: there is no path that carries on without the kernels.

The TMA-fed Hopper variants of K1, K2 and K6 (``csrc/scores_bmax_sm90.cu``,
``csrc/scores_bmax_f32_sm90.cu``, ``csrc/scores_bmax_int8_sm90.cu``, on
``csrc/sm90_tma.cuh``) encode TMA
tensor maps with the driver's ``cuTensorMapEncodeTiled``, which they reach
at run time through the CUDA runtime's driver entry point
(``cudaGetDriverEntryPointByVersion``): the link needs no ``-lcuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process reported: seconds, ptxas' resource
# lines (registers, shared memory, stack and spills), the spill bytes
# (stores + loads) of each kernel and ptxas' "Potential Performance Loss"
# notes (such as wgmma serialized); None when the library was reused
build_info: Optional[dict] = None


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "sessionsimilaritysearch_tpu_torch cannot be built"
        )
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsss_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands side by side; raise with the output of the first
    that fails. Returns the combined output of all."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {p.returncode}:\n"
                f"{' '.join(cmd)}\n{out}"
            )
    return "".join(outs)


def _compile(so: Path) -> None:
    global build_info
    nvcc = _find_nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{so.name}.{os.getpid()}"
    cus = [p for p in _sources() if p.suffix == ".cu"]
    objs = [so.with_name(f"{tag}.{p.stem}.o") for p in cus]
    tmp = so.with_name(f"{tag}.tmp")
    t0 = time.perf_counter()
    try:
        out = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                        for p, o in zip(cus, objs)])
        out += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, so)  # atomic: concurrent builders never load half a file
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    build_info = {"seconds": time.perf_counter() - t0, "path": str(so),
                  **parse_ptxas(out)}


def parse_ptxas(out: str) -> dict:
    """``-Xptxas -v`` output -> its resource lines, the spill bytes (stores
    + loads) of each function, by mangled name, and its performance notes."""
    lines, spills, notes, fn = [], {}, [], None
    for ln in out.splitlines():
        ln = ln.strip()
        if "Potential Performance Loss" in ln:
            notes.append(ln)
            lines.append(ln)
        elif "Function properties for" in ln:
            fn = ln.split("Function properties for", 1)[1].strip()
            lines.append(ln)
        elif "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            # "<a> bytes stack frame, <b> bytes spill stores, <c> bytes spill loads"
            if fn is not None and len(nums) == 3:
                spills[fn] = nums[1] + nums[2]
            lines.append(ln)
        elif "ptxas info" in ln and "Used" in ln:
            lines.append(ln)
    return {"ptxas": lines, "spills": spills, "perf_notes": notes}


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
            ptr = ctypes.c_void_p
            i32 = ctypes.c_int
            lib.sss_scores_bmax.argtypes = [
                ptr, ptr, ptr, ptr, ptr,   # queries, corpus, penalty, scores, bmax
                i32, i32, i32, i32,        # q, n, d, valid_count
                i32, i32,                  # in_bf16, out_bf16
                ptr,                       # stream
            ]
            lib.sss_scores_bmax_sm90.argtypes = [
                ptr, ptr, ptr, ptr, ptr,   # queries, corpus, penalty, scores, bmax
                i32, i32, i32, i32,        # q, n, d, valid_count
                i32,                       # out_bf16
                ptr,                       # stream
            ]
            lib.sss_packed_scores_bmax.argtypes = [
                ptr, ptr, ptr, ptr, ptr,   # queries, words, penalty, scores, bmax
                i32, i32, i32, i32,        # q, n, bits, valid_count
                i32,                       # out_bf16
                ptr,                       # stream
            ]
            lib.sss_hamming_bucket_min.argtypes = [
                ptr, ptr, ptr, ptr,        # q_codes, c_codes, penalty, bmin
                i32, i32, i32,             # q, n, words
                ptr,                       # stream
            ]
            lib.sss_hamming_bucket_min_sm90.argtypes = lib.sss_hamming_bucket_min.argtypes
            lib.sss_scores_bmax_int8_sm90.argtypes = [
                ptr, ptr, ptr, ptr,        # q codes, corpus codes, scales, penalty
                ptr, ptr,                  # scores, bmax
                i32, i32, i32, i32,        # q, n, d, valid_count
                i32,                       # out_bf16
                ptr,                       # stream
            ]
            lib.sss_scores_matmul_sm90.argtypes = [
                ptr, ptr, ptr,             # queries, corpus, scores (bf16, bf16, f32)
                i32, i32, i32,             # q, n, d
                ptr,                       # stream
            ]
            lib.sss_scores_bmax_f32_sm90.argtypes = lib.sss_scores_bmax_sm90.argtypes
            lib.sss_scores_bmax_cp_sm90.argtypes = lib.sss_scores_bmax_sm90.argtypes
            lib.sss_scores_matmul_cp_sm90.argtypes = lib.sss_scores_matmul_sm90.argtypes
            lib.sss_scores_matmul_f32_sm90.argtypes = [
                ptr, ptr, ptr,             # queries, corpus, scores (all f32)
                i32, i32, i32,             # q, n, d
                ptr,                       # stream
            ]
            lib.sss_scores_bmax_int8.argtypes = [
                ptr, ptr, ptr, ptr,        # q codes, corpus codes, scales, penalty
                ptr, ptr,                  # scores, bmax
                i32, i32, i32, i32,        # q, n, d, valid_count
                i32,                       # out_bf16
                ptr,                       # stream
            ]
            lib.sss_bucket_max.argtypes = [
                ptr, ptr, ptr,             # queries, corpus, bmax
                i32, i32, i32, i32,        # q, n, d, valid_count
                i32,                       # in_bf16
                ptr,                       # stream
            ]
            lib.sss_scores_matmul.argtypes = [
                ptr, ptr, ptr,             # queries, corpus, scores
                i32, i32, i32,             # q, n, d
                i32,                       # in_bf16
                ptr,                       # stream
            ]
            for fn in (lib.sss_scores_bmax, lib.sss_scores_bmax_sm90,
                       lib.sss_packed_scores_bmax,
                       lib.sss_hamming_bucket_min, lib.sss_hamming_bucket_min_sm90,
                       lib.sss_scores_bmax_int8,
                       lib.sss_bucket_max, lib.sss_scores_matmul,
                       lib.sss_scores_bmax_int8_sm90, lib.sss_scores_matmul_sm90,
                       lib.sss_scores_bmax_f32_sm90, lib.sss_scores_matmul_f32_sm90,
                       lib.sss_scores_bmax_cp_sm90, lib.sss_scores_matmul_cp_sm90):
                fn.restype = i32
            _lib = lib
        return _lib
