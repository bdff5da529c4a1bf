"""ctypes bindings for the native host-side kernels (libsss_native.so).

Builds lazily via ``make`` on first use if the shared object is missing;
every entry point has a pure-Python fallback in its caller, so the package
works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libsss_native.so")
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _HERE],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_SO)
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib or None
    _tried = True
    if not os.path.exists(_SO) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.lev_ratio.restype = ctypes.c_double
    lib.lev_ratio.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.lev_seqratio.restype = ctypes.c_double
    lib.lev_seqratio.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_size_t,
    ]
    lib.lev_string_match.restype = None
    lib.lev_string_match.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.tokenize_batch.restype = None
    lib.tokenize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_size_t, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.topk_f32.restype = None
    lib.topk_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
    ]
    if hasattr(lib, "build_graph_batch"):  # absent in pre-rebuild .so files
        _stream = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p,
        ]
        lib.build_graph_batch.restype = None
        lib.build_graph_batch.argtypes = _stream + _stream + [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p),
        ]
    _lib = lib
    return lib


def _as_cstrings(strings: Sequence[str]):
    enc = [s.encode("utf-8") for s in strings]
    arr = (ctypes.c_char_p * len(enc))(*enc)
    lens = (ctypes.c_size_t * len(enc))(*[len(e) for e in enc])
    return arr, lens, enc  # keep enc alive


def ratio(a: str, b: str) -> Optional[float]:
    lib = load()
    if lib is None:
        return None
    ab, bb = a.encode("utf-8"), b.encode("utf-8")
    return float(lib.lev_ratio(ab, len(ab), bb, len(bb)))


def seqratio(a: List[str], b: List[str]) -> Optional[float]:
    lib = load()
    if lib is None:
        return None
    aa, al, ka = _as_cstrings(a)
    ba, bl, kb = _as_cstrings(b)
    return float(lib.lev_seqratio(aa, al, len(a), ba, bl, len(b)))


def string_match(a: List[str], b: List[str]) -> Optional[Tuple[int, int]]:
    lib = load()
    if lib is None:
        return None
    aa, al, ka = _as_cstrings(a)
    ba, bl, kb = _as_cstrings(b)
    am = ctypes.c_int64()
    bm = ctypes.c_int64()
    lib.lev_string_match(aa, al, len(a), ba, bl, len(b),
                         ctypes.byref(am), ctypes.byref(bm))
    return int(am.value), int(bm.value)


def tokenize_batch(
    texts: Sequence[str], max_len: int, vocab_size: int
) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    # Unicode-aware lowercasing happens HERE: the C side lowercases
    # byte-wise ASCII only, so chars whose lowercase maps into ASCII
    # (e.g. U+212A KELVIN SIGN -> 'k') must be folded before marshalling
    # to keep bit-equivalence with HashTokenizer (text.lower() first).
    arr, lens, keep = _as_cstrings([t.lower() for t in texts])
    out = np.zeros((len(texts), max_len), dtype=np.int32)
    lib.tokenize_batch(
        arr, lens, len(texts), max_len, vocab_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


_TYPE_CODE = {"s": 0, "c": 1, "ca": 2, "p": 3}


def _marshal_stream(sessions: Sequence[Sequence]):
    """Flatten action lists into the C stream layout (graph_builder.cpp):
    per-session offsets, per-action type codes / asin ids / text blob with
    offsets and None flags. Text is keyword for searches, title otherwise
    (the only fields sequence_to_graph reads)."""
    off = np.zeros(len(sessions) + 1, dtype=np.int32)
    types: List[int] = []
    asins: List[int] = []
    nulls: List[int] = []
    chunks: List[bytes] = []
    toff: List[int] = [0]
    total = 0
    for si, acts in enumerate(sessions):
        total += len(acts)
        off[si + 1] = total
        for a in acts:
            t = a[1]
            if t == "s":
                types.append(0)
                asins.append(0)
                txt = a[2]
            else:
                # unknown click kinds behave like 'c' (CLICK_TYPE_IDS.get)
                types.append(_TYPE_CODE.get(t, 1))
                asins.append(int(a[-1]))
                txt = a[-2]
            if txt is None:
                nulls.append(1)
                b = b""
            else:
                nulls.append(0)
                # pre-fold case Unicode-aware; the C tokenizer only
                # lowercases ASCII bytes (see tokenize_batch above)
                b = txt.lower().encode("utf-8")
            chunks.append(b)
            toff.append(toff[-1] + len(b))
    return (
        off,
        np.asarray(types, dtype=np.uint8),
        np.asarray(asins, dtype=np.int32),
        np.asarray(toff, dtype=np.int64),
        np.asarray(nulls, dtype=np.uint8),
        b"".join(chunks),
    )


def build_graph_batch(
    seqs: Sequence,
    tars: Sequence,
    idxs: Sequence[int],
    dims8: Sequence[int],
    vocab_size: int,
    ignore_query: bool,
    outs: Sequence[np.ndarray],
) -> bool:
    """Fill the 35 pre-zeroed SessionGraph batch arrays in one C call.

    Returns False (arrays untouched) when the native library is unavailable
    or predates the builder; the caller falls back to the Python path.
    """
    lib = load()
    if lib is None or not hasattr(lib, "build_graph_batch"):
        return False

    def p32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def p8(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    s = _marshal_stream(seqs)
    t = _marshal_stream(tars)
    idx_arr = np.ascontiguousarray(idxs, dtype=np.int32)
    dims_arr = np.ascontiguousarray(dims8, dtype=np.int32)
    for o in outs:
        assert o.flags["C_CONTIGUOUS"], "outputs must be C-contiguous"
    out_ptrs = (ctypes.c_void_p * len(outs))(
        *[o.ctypes.data for o in outs]
    )
    lib.build_graph_batch(
        p32(s[0]), p8(s[1]), p32(s[2]), p64(s[3]), p8(s[4]), s[5],
        p32(t[0]), p8(t[1]), p32(t[2]), p64(t[3]), p8(t[4]), t[5],
        p32(idx_arr), len(seqs), p32(dims_arr),
        int(vocab_size), int(bool(ignore_query)), out_ptrs,
    )
    return True


def topk_oracle(
    corpus: np.ndarray, queries: np.ndarray, k: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = load()
    if lib is None:
        return None
    corpus = np.ascontiguousarray(corpus, dtype=np.float32)
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    n, d = corpus.shape
    nq = queries.shape[0]
    out_idx = np.zeros((nq, k), dtype=np.int32)
    out_val = np.zeros((nq, k), dtype=np.float32)
    lib.topk_f32(
        corpus.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, d,
        queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nq, k,
        out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_val.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out_val, out_idx
