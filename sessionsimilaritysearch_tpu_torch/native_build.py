"""Build the shared native host library (graph building, tokenizing) before
the serving path first looks for it.

``sessionsimilaritysearch_tpu.native.load()`` builds
``native/libsss_native.so`` with ``make`` on first use and caches its first
answer; when the build fails, graph building quietly runs in Python, about
ten times slower. The Makefile compiles with ``-fopenmp``, which fails
where the C++ compiler has no OpenMP runtime. :func:`ensure_native_library`
therefore runs the Makefile as it is and, if that fails, again with the
same flags but without ``-fopenmp``: the sources hold only ``#pragma omp``
lines, so the serial build is the same code on one thread. The library is
the git-ignored file the Makefile produces; no tracked file changes.
"""

from __future__ import annotations

import subprocess
from pathlib import Path
from typing import Optional

from sessionsimilaritysearch_tpu import native

NATIVE_DIR = Path(native.__file__).resolve().parent
LIBRARY = "libsss_native.so"
# the Makefile's CXXFLAGS without -fopenmp
SERIAL_CXXFLAGS = "-O3 -fPIC -shared -std=c++17 -Wall"

# how this process got the library: 'present', 'openmp', 'serial' or 'failed'
build_kind: Optional[str] = None


def build_native_library(native_dir: Path, openmp: bool) -> bool:
    """Run the Makefile in ``native_dir`` (without ``-fopenmp`` when
    ``openmp`` is False); True when the library exists afterwards."""
    cmd = ["make", "-C", str(native_dir)]
    if not openmp:
        cmd.append(f"CXXFLAGS={SERIAL_CXXFLAGS}")
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return False
    return (Path(native_dir) / LIBRARY).exists()


def ensure_native_library() -> str:
    """Make sure the shared native library exists; returns how (see
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
