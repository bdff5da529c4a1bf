"""Train state and optimizer (counterpart of
``sessionsimilaritysearch_tpu/training/train_state.py``).

The JAX package carries params, batch stats and optax state in one flax
``TrainState``; here ``TrainState`` holds the model (its parameters and its
BatchNorm buffers), the optimizer, the step count and the
``torch.Generator`` every random draw of a step comes from.

``adam_with_clip`` is optax's ``chain(clip_by_global_norm, adam | adamw)``:

- the clip scales every gradient by ``max_norm / norm`` only when the global
  norm is at least ``max_norm``, as optax does (torch's ``clip_grad_norm_``
  scales by ``max_norm / (norm + 1e-6)``, clamped at 1);
- then ``torch.optim.Adam``, or ``AdamW`` when ``weight_decay > 0``
  (decoupled decay: ``p * (1 - lr * wd) - lr * adam``, the same as optax's
  ``adamw``), with optax's b1 = 0.9, b2 = 0.999 and eps = 1e-8 (added after
  the square root) passed explicitly;
- a parameter that got no gradient (the frozen text backbone, whose pooled
  output is detached) gets a zero one first. JAX's tree holds it with zero
  gradients, so ``optax.adamw`` still decays it; torch would skip a
  parameter whose ``.grad`` is None.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List

import torch
from torch import nn
from torch.profiler import record_function

ADAM_BETAS = (0.9, 0.999)  # optax.adam's b1, b2
ADAM_EPS = 1e-8


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place over ``grads``: scale by
    ``max_norm / norm`` when the global norm is at least ``max_norm``;
    returns the norm before the clip. A few fused (foreach) kernels, no host
    synchronization."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class _ClipFirst:
    """Fills missing gradients with zeros and clips them by their global
    norm before the Adam step of the class it is mixed into (in
    ``torch.profiler`` spans ``clip`` and ``adam``)."""

    clip_norm: float

    @torch.no_grad()
    def step(self, closure=None):
        with record_function("clip"):
            params = [p for group in self.param_groups for p in group["params"]]
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            clip_by_global_norm([p.grad for p in params], self.clip_norm)
        with record_function("adam"):
            return super().step(closure)


class AdamWithClip(_ClipFirst, torch.optim.Adam):
    pass


class AdamWWithClip(_ClipFirst, torch.optim.AdamW):
    pass


def adam_with_clip(params: Iterable[nn.Parameter], lr: float, clip_norm: float = 1.0,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Global-norm clip, then Adam (AdamW when ``weight_decay > 0``); see
    the module docstring."""
    if weight_decay > 0:
        opt = AdamWWithClip(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                            weight_decay=weight_decay)
    else:
        opt = AdamWithClip(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=0.0)
    opt.clip_norm = clip_norm
    return opt


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the number of updates applied and the
    generator of the steps' random draws."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0
