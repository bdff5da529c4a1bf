"""Precision policies (counterpart of
``sessionsimilaritysearch_tpu/utils/precision.py:14-27``).

Training keeps float32 parameters; for serving and corpus builds a trained
encoder is cast once, into a new module.

The serving policy reproduces the JAX package's forward under bfloat16
parameters, which is not bf16 throughout. There, every floating leaf is cast
to bf16 and each op computes in the promotion of its operands' dtypes:

- the node embedders (``TextEncoder`` over token ids, ``NodeAsinEmbedding``
  over asin ids) see only integer inputs and bf16 parameters, so they
  compute in bf16 and emit bf16;
- the graph's float32 node masks then promote the node embeddings to f32
  (``GraphLevelEncoder``'s padding multiply), and every later layer (GNN,
  poolings) takes f32 activations: Flax ``Dense`` promotes its bf16 kernel
  to the f32 input, so those layers compute in f32 with weights rounded to
  bf16;
- a 0-d parameter (``RecencySRGNNPooling.raw_lambda``) goes through its own
  op in bf16 (softplus), and then a dimensioned f32 tensor absorbs it.

``torch.nn.Linear`` raises on mixed dtypes instead of promoting, so the port
writes the policy out: the node embedders and 0-d parameters are cast to
bf16 (torch, like JAX, lets a dimensioned f32 tensor absorb a 0-d bf16 one),
and every other floating parameter is rounded through bf16 and kept as f32.
Both casts round to nearest even, as JAX's ``astype`` does, so each weight
is bit-equal to the JAX package's bf16 leaf (or its exact f32 widening).
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from sessionsimilaritysearch_tpu_torch.models.embedding import (
    NodeAsinEmbedding,
    TextEncoder,
)

# modules whose inputs are integer ids: under bf16 parameters they compute in bf16
_ID_EMBEDDERS = (TextEncoder, NodeAsinEmbedding)


def cast_floats(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """A copy of ``module`` with every floating parameter and buffer cast to
    ``dtype``; integer and bool tensors pass through. ``module`` is left as
    it is."""
    out = copy.deepcopy(module)
    for t in list(out.parameters()) + list(out.buffers()):
        if t.is_floating_point():
            t.data = t.data.to(dtype)
    return out


def serving_params(module: nn.Module, use_bf16: bool = True) -> nn.Module:
    """The recommended serving form of a trained encoder: a new module under
    the bf16 policy of the module docstring (``module`` itself when
    ``use_bf16`` is False, as the JAX function returns its tree)."""
    if not use_bf16:
        return module
    out = copy.deepcopy(module)
    in_embedder = {id(p) for m in out.modules() if isinstance(m, _ID_EMBEDDERS)
                   for p in m.parameters()}
    for p in out.parameters():
        if not p.is_floating_point():
            continue
        if id(p) in in_embedder or p.dim() == 0:
            p.data = p.data.to(torch.bfloat16)
        else:
            p.data = p.data.to(torch.bfloat16).to(p.dtype)
    return out
