"""State of the JAX package -> the port: the encoders' and the pretrainer's
Flax parameters (and BatchNorm statistics) as a ``state_dict``, a JAX train
state's Adam moments as torch optimizer state, and the two-stage index's
SimHash projection.

The encoder's input is the params pytree of ``sessionsimilaritysearch_tpu.models``' Flax
``GraphLevelEncoder`` with numpy leaves, i.e.
``jax.tree.map(np.asarray, enc.init(...))`` (with or without the top-level
``'params'`` collection). Output: a ``state_dict`` for the port's
``GraphLevelEncoder`` built from the same ``Config``, so both compute the
same function. What differs between the two naming schemes:

- Flax ``Dense.kernel`` is ``[in, out]``; torch ``Linear.weight`` is
  ``[out, in]``.
- Flax names unnamed submodules after their class: ``Dense_0`` / ``Dense_1``
  (FFN in / out), ``LayerNorm_0`` / ``LayerNorm_1``, ``MultiHeadAttention_0``;
  the port names them ``ffn_in``, ``ffn_out``, ``norm1``, ``norm2``,
  ``self_attn``.
- Flax ``LayerNorm`` calls its gain ``scale`` and ``Embed`` its table
  ``embedding``; torch calls both ``weight``.
- Transformer layers ``layer_{i}`` live in ``layers.{i}``; GNN convs
  ``l{i}_{qp,pq,pp}`` in ``gnn.convs``.
- ``att_src`` / ``att_dst`` are ``[out, 1]`` on both sides.

- The cross-attention branch's ``TransformerEncoder_0`` is the port's
  ``encoder``.

Other leaves keep their name and shape: the recency pooling's 0-d
``raw_lambda`` becomes the 0-d ``product_pooling.raw_lambda`` and its
``lin_rec`` a Linear like the others; the pretrainer's heads keep
``dense_{i}``, ``bn_{i}`` and ``dense_out`` (a BatchNorm's ``scale`` is its
``weight``), the pooling its ``*_lin`` and ``positional_emb``, the model its
``target_asin_embedding``. The ``batch_stats`` leaves ``mean`` and ``var``
become the BatchNorm buffers of the same names. An encoder built with
``use_id_embedding=False`` has no ``product_node_embedder`` on either side.

A JAX train state (``utils/checkpoint.py`` ``state_to_tree``: step, params,
batch_stats and the optax chain state, live or read from a msgpack file by
``utils.checkpoint.read_flax_checkpoint``) loads into a port ``TrainState``
with :func:`load_flax_train_state`: ``ScaleByAdamState.mu``, ``.nu`` and
``.count`` become each parameter's ``exp_avg``, ``exp_avg_sq`` and ``step``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_MODULE_RENAME = {
    "MultiHeadAttention_0": "self_attn",
    "Dense_0": "ffn_in",
    "Dense_1": "ffn_out",
    "LayerNorm_0": "norm1",
    "LayerNorm_1": "norm2",
    "TransformerEncoder_0": "encoder",
}
_LEAF_RENAME = {"kernel": "weight", "embedding": "weight", "scale": "weight"}
_LAYER = re.compile(r"layer_(\d+)")
_CONV = re.compile(r"l\d+_(qp|pq|pp)")


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for key, val in tree.items():
        if hasattr(val, "items"):  # dict or FrozenDict
            yield from _leaves(val, path + (key,))
        else:
            yield path + (key,), np.asarray(val)


def torch_key(path: tuple) -> str:
    """The port's state_dict key for one Flax parameter path."""
    parts = []
    for p in path[:-1]:
        layer = _LAYER.fullmatch(p)
        if layer:
            parts += ["layers", layer.group(1)]
        elif _CONV.fullmatch(p):
            parts += ["convs", p]
        else:
            parts.append(_MODULE_RENAME.get(p, p))
    parts.append(_LEAF_RENAME.get(path[-1], path[-1]))
    return ".".join(parts)


def _to_torch(path: tuple, arr) -> torch.Tensor:
    arr = np.asarray(arr, np.float32)
    return torch.tensor(arr.T if path[-1] == "kernel" else arr)


def flax_to_state_dict(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """Convert a Flax params tree (numpy leaves) of ``GraphLevelEncoder``,
    ``UnifyPoolingGraphLevelEncoder`` or ``PretrainModel`` -- and, for the
    pretrainer, its ``batch_stats`` tree -- into a float32 ``state_dict`` of
    the port's module. Load it with ``load_state_dict(..., strict=True)`` so
    a missing or extra name fails loudly. Carry the float32 training
    parameters across and apply ``utils.precision.serving_params`` on the
    port's side."""
    tree = params["params"] if "params" in params else params
    out = {torch_key(path): _to_torch(path, arr) for path, arr in _leaves(tree)}
    for path, arr in _leaves(batch_stats or {}):
        out[torch_key(path)] = _to_torch(path, arr)
    return out


def _as_dict(node):
    """A chain state node as a dict: namedtuples by field, tuples and lists
    by position (as flax's state dicts key them)."""
    if hasattr(node, "_asdict"):
        return dict(node._asdict())
    if isinstance(node, (tuple, list)):
        return {str(i): v for i, v in enumerate(node)}
    return node


def _adam_state(opt_state) -> dict:
    """The ``ScaleByAdamState`` (the node with ``count``, ``mu`` and ``nu``)
    inside an optax chain state."""
    node = _as_dict(opt_state)
    if isinstance(node, dict):
        if {"count", "mu", "nu"} <= set(node):
            return node
        for child in node.values():
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def flax_adam_state(opt_state, model: torch.nn.Module) -> Dict[int, dict]:
    """The ``state`` part of a torch Adam / AdamW ``state_dict`` over
    ``model.parameters()`` from an optax ``chain(clip_by_global_norm,
    adam | adamw)`` state: per parameter index ``step`` (the Adam count, a
    float32 scalar as torch keeps it), ``exp_avg`` (mu) and ``exp_avg_sq``
    (nu), transposed like their parameters."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer state")
    index = {name: i for i, (name, _) in enumerate(model.named_parameters())}
    count = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    state: Dict[int, dict] = {}
    for key, leaf in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        for path, arr in _leaves(adam[leaf]):
            state.setdefault(index[torch_key(path)], {"step": count.clone()})[key] = \
                _to_torch(path, arr)
    if len(state) != len(index):
        raise ValueError(f"Adam state covers {len(state)} of {len(index)} parameters")
    return state


def load_flax_train_state(state, tree) -> None:
    """Load a JAX train state tree -- ``{"step", "params", "batch_stats",
    "opt_state"}`` with numpy leaves, as ``read_flax_checkpoint`` returns it
    or ``jax.tree.map(np.asarray, state_to_tree(jax_state))`` -- into the
    port's ``TrainState`` of the same ``Config`` (strict). A tree without
    ``opt_state`` (``train_state.save_state``) keeps the optimizer as it is.
    The generator is the port's own: torch cannot continue JAX's streams."""
    state.model.load_state_dict(
        flax_to_state_dict(tree["params"], tree.get("batch_stats")), strict=True)
    if tree.get("opt_state") is not None:
        opt = state.optimizer.state_dict()
        opt["state"] = flax_adam_state(tree["opt_state"], state.model)
        state.optimizer.load_state_dict(opt)
    state.step = int(np.asarray(tree["step"]))


def simhash_projection(jax_projection) -> torch.Tensor:
    """The JAX ``TwoStageIndex(prefilter='binary')`` projection, i.e.
    ``np.asarray(jax.random.normal(PRNGKey(seed), (d, n_bits)))``
    (``index/twostage.py:53``), as the float32 [d, n_bits] tensor the port's
    ``TwoStageIndex(projection=...)`` takes. torch cannot draw JAX's random
    stream, so an index that must reproduce the JAX codes is given this
    array. A JAX ``'binary'`` snapshot stores only the seed
    (``twostage.py:408``): the port's ``TwoStageIndex.load`` (and
    ``SessionSearchEngine.restore``) takes this array as ``projection=`` and
    raises a ``ValueError`` without it. The port's own ``'binary'`` snapshot
    adds the projection under the key ``projection``; the JAX package
    ignores that key and redraws R from the seed, so a port ``'binary'``
    file does not serve correctly there."""
    arr = np.asarray(jax_projection, np.float32)
    if arr.ndim != 2:
        raise ValueError(f"projection must be [d, n_bits], got {arr.shape}")
    return torch.from_numpy(arr.copy())
