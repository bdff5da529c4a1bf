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

**Sharded checkpoints** (JAX ``save_sharded`` :117, ``restore_sharded``
:155): a tree whose row-sharded leaves are
``parallel.sharding.ShardedTensor``s is written shard by shard, never
gathered: each process writes one ``.npy`` per shard it holds, and one
process (rank 0 of a group) writes ``manifest.pkl`` in JAX's layout --
``{"leaves": [("inline", array) | ("sharded", {"shape", "dtype",
"shards": [{"file", "index"}]})]}`` with the leaves in the order JAX
flattens the same dict (sorted keys) and each shard found by its index box
-- so either package reads the other's directory. Restore takes a template
of the same structure whose sharded leaves carry the target layout and
devices, and loads each process's boxes; a box that no saved shard covers
raises. Two trees use it: the data-parallel train state
(:func:`sharded_state_tree` / :func:`load_sharded_state_tree`) and the
sharded indexes' ``state_dict()`` / ``load_state``.
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import Any, Optional

import numpy as np
import torch

from sessionsimilaritysearch_tpu_torch.parallel.sharding import ShardedTensor, row_shards


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
# sharded checkpoints
# ---------------------------------------------------------------------------

def _flatten(tree) -> list:
    """The leaves of a tree of dicts (sorted keys, as JAX flattens them),
    lists and tuples; None holds no leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [] if tree is None else [tree]


def _unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (an iterator) in its leaves'
    places."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return None if tree is None else next(leaves)


def _to_numpy(x) -> np.ndarray:
    """A tensor on the host as numpy (bfloat16 as float32, which numpy
    holds without loss); anything else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def save_sharded(directory: str, tree: Any) -> None:
    """Write ``tree`` to ``directory``: one ``.npy`` per shard this process
    holds of each :class:`ShardedTensor` leaf (``leaf{i}_s{shard}.npy``,
    named by shard position), and the manifest with every other leaf
    inline. Where a sharded leaf spans processes, every rank must call this:
    rank 0 writes the manifest, and all wait for each other at the end."""
    os.makedirs(directory, exist_ok=True)
    leaves = _flatten(tree)
    spans = any(isinstance(x, ShardedTensor) and x.distributed for x in leaves)
    if spans:
        import torch.distributed as dist
    writer = not spans or dist.get_rank() == 0
    manifest = {"leaves": []}
    for i, leaf in enumerate(leaves):
        if not isinstance(leaf, ShardedTensor):
            manifest["leaves"].append(("inline", _to_numpy(leaf) if writer else None))
            continue
        for s, t in leaf.shards.items():
            np.save(os.path.join(directory, f"leaf{i:05d}_s{s:05d}.npy"), _to_numpy(t))
        dtype = _dtype_name(next(iter(leaf.shards.values())))
        manifest["leaves"].append(("sharded", {
            "shape": leaf.shape, "dtype": dtype,
            "shards": [{"file": f"leaf{i:05d}_s{s:05d}.npy", "index": leaf.box(s)}
                       for s in range(leaf.n_shards)]}))
    if writer:
        tmp = os.path.join(directory, "manifest.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(manifest, f)
        os.replace(tmp, os.path.join(directory, "manifest.pkl"))
    if spans:
        dist.barrier()


def _like(arr: np.ndarray, template):
    """A restored inline array in the template leaf's form: a tensor of its
    dtype on its device, or numpy / a Python scalar as saved."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(arr).to(template.device, template.dtype)
    if isinstance(template, (bool, int, float)):
        return type(template)(arr)
    return arr


def restore_sharded(directory: str, template: Any) -> Any:
    """Rebuild the tree saved in ``directory`` in ``template``'s structure.
    A sharded leaf is loaded box by box onto the devices of the template's
    :class:`ShardedTensor` (its shards say which boxes this process wants);
    a box that no saved shard covers, a sharded leaf whose template is not
    sharded (or the reverse) and a shape that differs raise ``ValueError``."""
    with open(os.path.join(directory, "manifest.pkl"), "rb") as f:
        saved = pickle.load(f)["leaves"]
    wanted = _flatten(template)
    if len(saved) != len(wanted):
        raise ValueError(f"{directory} holds {len(saved)} leaves, the template {len(wanted)}")
    out = []
    for i, ((kind, payload), t) in enumerate(zip(saved, wanted)):
        if (kind == "sharded") != isinstance(t, ShardedTensor):
            raise ValueError(f"leaf {i} was saved {kind}, but its template is "
                             f"{'not ' if kind == 'sharded' else ''}a ShardedTensor")
        if kind == "inline":
            out.append(_like(payload, t))
            continue
        if tuple(payload["shape"]) != t.shape:
            raise ValueError(f"leaf {i}: saved shape {tuple(payload['shape'])}, "
                             f"template {t.shape}")
        files = {tuple(tuple(int(v) for v in dim) for dim in e["index"]): e["file"]
                 for e in payload["shards"]}
        shards = {}
        for s, like in t.shards.items():
            name = files.get(t.box(s))
            if name is None:
                raise ValueError(
                    f"leaf {i}: no saved shard covers {t.box(s)}; saved boxes "
                    f"{sorted(files)} (re-striping across other shard boundaries is not "
                    "supported)")
            arr = np.load(os.path.join(directory, name))
            shards[s] = torch.from_numpy(arr).to(like.device, like.dtype)
        out.append(ShardedTensor(t.shape, shards, t.n_shards, t.distributed))
    return _unflatten(template, iter(out))


def sharded_state_tree(state) -> dict:
    """A train state as a :func:`save_sharded` tree (and a restore
    template): the step, the parameters and their Adam moments (a
    row-sharded table's as a :class:`ShardedTensor` of this rank's rows;
    zeros where the optimizer has no state yet), the BatchNorm statistics
    and the generator state."""
    model, opt = state.model, state.optimizer
    shards = row_shards(model)
    params = dict(model.named_parameters())

    def leaf(name, t):
        sh = shards.get(name)
        if sh is None:
            return t
        return ShardedTensor((sh.rows,) + tuple(t.shape[1:]), {sh.start // (sh.stop - sh.start): t},
                             sh.n_shards, sh.group.distributed)

    moments = {"step": {}, "exp_avg": {}, "exp_avg_sq": {}}
    for name, p in params.items():
        st = opt.state.get(p) or {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                                  "exp_avg_sq": torch.zeros_like(p)}
        for key in moments:
            moments[key][name] = leaf(name, st[key]) if key != "step" else st[key]
    return {"step": int(state.step),
            "params": {name: leaf(name, p.detach()) for name, p in params.items()},
            "batch_stats": {k: v for k, v in model.state_dict().items() if k not in params},
            "opt_state": moments,
            "generator": state.generator.get_state()}


def load_sharded_state_tree(state, tree: dict):
    """Load a tree of :func:`sharded_state_tree` (e.g. from
    :func:`restore_sharded`) into ``state`` in place and return it."""
    model, opt = state.model, state.optimizer

    def local(x):
        return x.local()[0] if isinstance(x, ShardedTensor) else x

    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(local(tree["params"][name]))
            opt.state[p] = {key: local(tree["opt_state"][key][name])
                            for key in ("step", "exp_avg", "exp_avg_sq")}
        buffers = dict(model.named_buffers())
        for name, v in tree["batch_stats"].items():
            buffers[name].copy_(v)
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
