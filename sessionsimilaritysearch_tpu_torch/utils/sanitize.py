"""Numerical and purity sanitizers (counterpart of
``sessionsimilaritysearch_tpu/utils/sanitize.py``), with their torch
semantics:

- :func:`debug_nans`: a scoped mode in which the op whose floating
  output holds a NaN raises ``FloatingPointError`` naming the op, as
  ``jax_debug_nans`` does. It is a ``TorchDispatchMode`` that checks every
  op's floating outputs after the op has run (an ``.any()`` per op, so a
  device sync per op: a debugging tool, not a serving mode). ``torch.empty``
  and its kin are not checked (their memory is not written yet); infinities
  pass, as under ``jax_debug_nans``. Autograd carries the mode into the
  backward, so a backward op that makes a NaN raises the same way; the
  mode also turns on ``torch.autograd.set_detect_anomaly(True)``, which
  names the backward function and prints the traceback of the forward call
  that recorded it, and on exit restores the previous anomaly state.
- :func:`assert_pure`: calls a function twice on the same inputs and
  asserts bit-identical outputs (every tensor leaf's bytes, dtype and
  shape). Under torch a step that updates its state in place is not pure
  by design: wrap it so that each call starts from the same state (e.g.
  builds the state from the seed), as the JAX step starts from the state it
  is passed.
- :func:`assert_donates`: torch has no buffer donation; its counterpart is
  an in-place update. ``assert_donates(fn, buf, ...)`` asserts that ``fn``
  wrote ``buf`` in place (its version counter moved) and returned it, or a
  view of it (an output tensor shares ``buf``'s storage), rather than a
  copy. A silent copy doubles peak memory on multi-GB corpus and optimizer
  buffers, as a silently dropped donation does in JAX.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

# ops whose output memory is not written yet: their bytes are not values
_UNWRITTEN = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
              "empty_permuted", "resize_"}


class _NaNTrap(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first op whose floating output
    holds a NaN. Ops run inside ``__torch_dispatch__`` are not intercepted
    again (the mode is off while its handler runs)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNWRITTEN:
            return out
        for t in pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN debugging: inside the context, the op that makes a NaN,
    forward or backward, raises ``FloatingPointError`` instead of the NaN
    propagating silently. ``enable=False`` runs the block unchecked."""
    if not enable:
        yield
        return
    prev = torch.is_anomaly_enabled()
    prev_check = torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        with _NaNTrap():
            yield
    finally:
        torch.autograd.set_detect_anomaly(prev, prev_check)


def _bits(x) -> Any:
    """A leaf as something ``==`` compares bit for bit."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous().reshape(-1)
        return ("tensor", str(x.dtype), tuple(x.shape), t.view(torch.uint8).numpy().tobytes())
    if isinstance(x, np.ndarray):
        a = np.ascontiguousarray(x).reshape(-1)
        return ("ndarray", str(x.dtype), x.shape, a.view(np.uint8).tobytes())
    if isinstance(x, float):
        return ("float", np.float64(x).tobytes())
    return ("other", x)


def _leaves_equal(a: Any, b: Any) -> bool:
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    if sa != sb or len(la) != len(lb):
        return False
    return all(_bits(x) == _bits(y) for x, y in zip(la, lb))


def assert_pure(fn: Callable, *args, **kwargs) -> Any:
    """Run ``fn`` twice on identical inputs and assert bit-identical outputs
    (tensors, numpy arrays and Python values, nested in lists, tuples and
    dicts). Catches hidden host state (mutable defaults, caches keyed
    wrongly), draws from a generator that is not reset, and inputs that the
    call changes in place. Returns the first result."""
    out1 = fn(*args, **kwargs)
    # a copy: the second call may write the first one's output in place
    first = pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, out1)
    out2 = fn(*args, **kwargs)
    if not _leaves_equal(first, out2):
        raise AssertionError(
            f"{getattr(fn, '__name__', fn)!r} is impure: two calls on "
            "identical inputs returned different results"
        )
    return out1


def assert_donates(fn: Callable, donated_arg: torch.Tensor, *rest, **kwargs) -> Any:
    """Call ``fn(donated_arg, *rest, **kwargs)`` and assert that it updated
    ``donated_arg`` in place: its version counter moved (a write), and an
    output tensor shares its storage (the result is the buffer or a view of
    it, not a copy). Returns ``fn``'s output."""
    storage = donated_arg.untyped_storage().data_ptr()
    version = donated_arg._version
    out = fn(donated_arg, *rest, **kwargs)
    shares = any(isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() == storage
                 for t in pytree.tree_leaves(out))
    if not shares or donated_arg._version == version:
        raise AssertionError(
            f"{getattr(fn, '__name__', fn)!r} did not update its first argument in "
            "place -- it returned a copy (peak memory doubles)"
        )
    return out
