"""Build the port's native host library (graph building, tokenizing) before
the serving path first looks for it.

``sessionsimilaritysearch_tpu_torch.native.load()`` builds
``native/libsss_native.so`` with ``make`` on first use and caches its first
answer; when the build fails, graph building quietly runs in Python, about
ten times slower. The Makefile compiles with ``-fopenmp``, which fails
where the C++ compiler has no OpenMP runtime. :func:`ensure_native_library`
therefore runs the Makefile as it is and, if that fails, again with the
same flags but without ``-fopenmp``: the sources hold only ``#pragma omp``
lines, so the serial build is the same code on one thread.

Each build runs in a scratch copy of the sources under ``_build/`` and the
finished library is renamed into ``native/`` in one step, so processes that
build side by side never load half a file. The library and ``_build/`` are
git-ignored; no tracked file changes.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

from sessionsimilaritysearch_tpu_torch import native

NATIVE_DIR = Path(native.__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
LIBRARY = "libsss_native.so"
SOURCES = ("Makefile", "graph_builder.cpp", "levenshtein.cpp", "tokenize_inl.h")
# the Makefile's CXXFLAGS without -fopenmp
SERIAL_CXXFLAGS = "-O3 -fPIC -shared -std=c++17 -Wall"

# how this process got the library: 'present', 'openmp', 'serial' or 'failed'
build_kind: Optional[str] = None


def build_native_library(native_dir: Path, openmp: bool) -> bool:
    """Run the Makefile of ``native_dir`` on a scratch copy of its sources
    (without ``-fopenmp`` when ``openmp`` is False) and move the library
    into ``native_dir``; True when it is there afterwards."""
    native_dir = Path(native_dir)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR, prefix="native_") as tmp:
        for name in SOURCES:
            shutil.copy(native_dir / name, tmp)
        cmd = ["make", "-C", tmp]
        if not openmp:
            cmd.append(f"CXXFLAGS={SERIAL_CXXFLAGS}")
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            os.replace(Path(tmp) / LIBRARY, native_dir / LIBRARY)
        except (OSError, subprocess.SubprocessError):
            return False
    return (native_dir / LIBRARY).exists()


def ensure_native_library() -> str:
    """Make sure the native library exists; returns how (see
    ``build_kind``). Runs its builds once per process."""
    global build_kind
    if build_kind is None:
        if (NATIVE_DIR / LIBRARY).exists():
            build_kind = "present"
        elif build_native_library(NATIVE_DIR, openmp=True):
            build_kind = "openmp"
        elif build_native_library(NATIVE_DIR, openmp=False):
            build_kind = "serial"
        else:
            build_kind = "failed"
        if build_kind in ("openmp", "serial") and native._lib is None:
            native._tried = False  # a failed earlier load() may look again
    return build_kind
