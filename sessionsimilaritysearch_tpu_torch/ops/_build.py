"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources under ``csrc/`` compile at first use into one shared library
with a plain C interface, under ``_build/`` in the package directory (listed
in ``.gitignore``). The library's name carries a hash of the sources and the
flags, so a second run reuses it and an edit rebuilds it. A missing ``nvcc``
or a failed build raises with the compiler's output: there is no path that
carries on without the kernel.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process reported: seconds and ptxas' resource
# lines (registers, shared memory, spills); None when the library was reused
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


def _compile(so: Path) -> None:
    global build_info
    nvcc = _find_nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: concurrent builders never load half a file
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "ptxas info" in ln and ("Used" in ln or "spill" in ln)]
    build_info = {"seconds": seconds, "ptxas": ptxas, "path": str(so)}


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
            lib.sss_scores_bmax.restype = i32
            _lib = lib
        return _lib
