"""State of the JAX package -> the port: the encoder's Flax parameters as a
``state_dict``, and the two-stage index's SimHash projection.

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

Other leaves keep their name and shape: the recency pooling's 0-d
``raw_lambda`` becomes the 0-d ``product_pooling.raw_lambda`` and its
``lin_rec`` a Linear like the others. An encoder built with
``use_id_embedding=False`` has no ``product_node_embedder`` on either side.
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


def flax_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """Convert a Flax ``GraphLevelEncoder`` params tree (numpy leaves) into a
    float32 ``state_dict`` for ``models.encoder.GraphLevelEncoder``. Load it
    with ``load_state_dict(..., strict=True)`` so a missing or extra name
    fails loudly. Carry the float32 training parameters across and apply
    ``utils.precision.serving_params`` on the port's side."""
    tree = params["params"] if "params" in params else params
    out = {}
    for path, arr in _leaves(tree):
        arr = np.asarray(arr, np.float32)
        out[torch_key(path)] = torch.tensor(arr.T if path[-1] == "kernel" else arr)
    return out


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
