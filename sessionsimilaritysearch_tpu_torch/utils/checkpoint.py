"""Checkpoint / resume (counterpart of
``sessionsimilaritysearch_tpu/utils/checkpoint.py:24-100``), and the reader
of the JAX trainers' checkpoints.

``CheckpointManager`` keeps one ``torch.save`` file per tag in a directory
(``latest``, ``best``, ``loop_meta``, ...), written to a temporary name and
renamed, so a crash mid-write leaves the previous file. ``state_to_tree``
covers what a resume needs to replay a run exactly: the parameters, the
BatchNorm statistics, the optimizer state, the step count and the state of
the steps' ``torch.Generator``. Resume is at step granularity.

**The JAX trainers' checkpoints.** The JAX ``CheckpointManager`` writes
Orbax directories (tensorstore) or, with ``use_orbax=False``, one flax
msgpack file per tag; ``train_state.save_state`` always writes msgpack. The
machine that runs the port has neither JAX nor a ``msgpack`` package, so
the port reads the msgpack form with its own small decoder
(:func:`read_flax_msgpack`), which covers the subset flax writes: maps,
arrays, strings, integers, floats, booleans, nil, bin, flax's ndarray and
numpy-scalar extension types and its chunked arrays. An Orbax directory is
refused with a ``ValueError``: save such runs with ``use_orbax=False``.
``weights.load_flax_train_state`` carries what it reads into a port state.
The sharded (multi-device) save and restore wait for multi-GPU support.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Optional

import numpy as np
import torch


class CheckpointManager:
    """One ``torch.save`` file per tag under ``directory``."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, tag) -> str:
        return os.path.join(self.directory, f"{tag}.pt")

    def save(self, tag, tree: Any) -> None:
        path = self._path(tag)
        tmp = path + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)

    def restore(self, tag, map_location=None) -> Optional[Any]:
        """The saved tree, or None when ``tag`` was never saved."""
        path = self._path(tag)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location=map_location, weights_only=True)

    def has(self, tag) -> bool:
        return os.path.exists(self._path(tag))


def state_to_tree(state) -> dict:
    """TrainState -> a tree ``torch.save`` writes: the step, the parameters,
    the BatchNorm statistics (the persistent buffers: not the positional
    tables, which the modules rebuild), the optimizer state and the
    generator state. The tensors are the live ones: save before the next
    step."""
    model = state.model
    params = dict(model.named_parameters())
    return {
        "step": int(state.step),
        "params": params,
        "batch_stats": {k: v for k, v in model.state_dict(keep_vars=True).items()
                        if k not in params},
        "opt_state": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
    }


def tree_to_state(state, tree: dict):
    """Load a tree of :func:`state_to_tree` into ``state`` (in place; every
    parameter and statistic must match, ``strict=True``) and return it."""
    state.model.load_state_dict({**tree["params"], **tree["batch_stats"]}, strict=True)
    state.optimizer.load_state_dict(tree["opt_state"])
    state.generator.set_state(tree["generator"].cpu())
    state.step = int(tree["step"])
    return state


# ---------------------------------------------------------------------------
# flax msgpack (the JAX package's use_orbax=False checkpoints)
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3  # flax.serialization._MsgpackExtType
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder over one buffer (big-endian, as the format is)."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}  # bin
        if b in sized:
            return bytes(self._take(self._unpack(sized[b])))
        ext = {0xC7: "B", 0xC8: "H", 0xC9: "I"}
        if b in ext:
            n = self._unpack(ext[b])
            return self._ext(n)
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self._unpack(numbers[b])
        strs = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if b in strs:
            return self._str(self._unpack(strs[b]))
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self._unpack("H" if b == 0xDC else "I"))]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack("H" if b == 0xDE else "I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not one flax writes")

    def _str(self, n: int) -> str:
        return bytes(self._take(n)).decode("utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _ext(self, n: int):
        code = self._unpack("b")
        payload = self._take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not an ndarray")
        shape, dtype, raw = _Reader(payload).value()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        if dtype == "bfloat16":  # numpy has no bfloat16; torch reads the bytes
            arr = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).reshape(shape)
        else:
            arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    """Rebuild flax's chunked form of arrays above its chunk size."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str) -> dict:
    """A flax msgpack file (``flax.serialization.to_bytes``) -> its state
    dict: nested dicts (tuples and namedtuples appear as dicts keyed by
    position or field name) with numpy array leaves."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{path}: {len(data) - reader.pos} bytes after the msgpack value")
    return _unchunk(tree)


def read_flax_checkpoint(directory: str, tag: str = "latest") -> dict:
    """The tree a JAX ``CheckpointManager(directory, use_orbax=False)`` saved
    under ``tag`` (``<directory>/<tag>.msgpack``). An Orbax checkpoint (a
    directory ``<directory>/<tag>``) raises a ``ValueError``."""
    base = os.path.join(directory, str(tag))
    if os.path.isdir(base):
        raise ValueError(
            f"{base} is an Orbax checkpoint, which the port cannot read without JAX "
            "and tensorstore; save the run with CheckpointManager(..., "
            "use_orbax=False) (flax msgpack)")
    if not os.path.exists(base + ".msgpack"):
        raise FileNotFoundError(f"no checkpoint {base}.msgpack")
    return read_flax_msgpack(base + ".msgpack")
