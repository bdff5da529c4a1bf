"""The inputs a run makes from its seed, the same for the program and the
reference: the encoder's weights, the catalog and the corpus rows.

Weights and rows are made on the device with a ``torch.Generator`` there,
in a few large calls and in the dtype they are served in (bfloat16). The
corpus is a clustered mixture on the unit sphere, made in blocks of rows,
each block from its own generator, so that the reference can make any
block again after the program's state is freed.
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple

import numpy as np
import torch

from portbench.reference.encoder import param_spec
from portbench.traffic.sessions import SessionGenerator


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_weights(model: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Every weight of the encoder at the widths ``model``: Linear weights
    normal with std 1/sqrt(fan_in), biases normal with std 0.01,
    embeddings standard normal, LayerNorm ones and zeros, the GAT
    attention vectors glorot-uniform. Two draws (one normal, one uniform)
    cover all of them."""
    spec = param_spec(model)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    normal = [s for s in spec if s[2] in ("normal", "bias")]
    uniform = [s for s in spec if s[2] == "glorot"]
    n_norm = sum(math.prod(s[1]) for s in normal)
    n_unif = sum(math.prod(s[1]) for s in uniform)
    z = torch.randn(n_norm, generator=g, device=device, dtype=dtype)
    u = torch.rand(n_unif, generator=g, device=device, dtype=dtype)
    out, i, j = {}, 0, 0
    for name, shape, init, fan in spec:
        n = math.prod(shape)
        if init in ("normal", "bias"):
            std = 0.01 if init == "bias" else 1.0 / math.sqrt(fan)
            out[name] = (z[i: i + n] * std).view(shape)
            i += n
        elif init == "glorot":
            lim = math.sqrt(6.0 / fan)
            out[name] = ((u[j: j + n] * 2.0 - 1.0) * lim).view(shape)
            j += n
        else:
            fill = 1.0 if init == "ones" else 0.0
            out[name] = torch.full(shape, fill, device=device, dtype=dtype)
    return out


def make_catalog(model: dict, seed: int) -> SessionGenerator:
    """The catalog of ``asin_num`` products (types, brands, titles)."""
    return SessionGenerator(model["asin_num"], seed=sub_seed(seed, 2))


class Corpus:
    """``rows`` stored session embeddings of width ``dim``: each row
    ``normalize(center + noise * g / sqrt(dim))`` for one of ``centers``
    unit centers, g standard normal, in bfloat16."""

    def __init__(self, spec: dict, dim: int, seed: int, device):
        self.rows = int(spec["rows"])
        self.dim = dim
        self.n_centers = int(spec["centers"])
        self.noise = float(spec["noise"])
        self.block = int(spec["block_rows"])
        self.seed = seed
        self.device = device
        g = torch.Generator(device=device).manual_seed(sub_seed(seed, 3))
        c = torch.randn(self.n_centers, dim, generator=g, device=device)
        self._centers = c / c.norm(dim=1, keepdim=True)

    def block_rows(self, b: int) -> torch.Tensor:
        """Rows [b * block, (b + 1) * block) as bfloat16 [m, dim]."""
        start = b * self.block
        m = min(self.block, self.rows - start)
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, 4, b))
        assign = torch.randint(self.n_centers, (m,), generator=g, device=self.device)
        x = torch.randn(m, self.dim, generator=g, device=self.device)
        x.mul_(self.noise / math.sqrt(self.dim)).add_(self._centers[assign])
        x.div_(x.norm(dim=1, keepdim=True))
        return x.to(torch.bfloat16)

    def blocks(self) -> Iterator[Tuple[int, torch.Tensor]]:
        for b in range(-(-self.rows // self.block)):
            yield b * self.block, self.block_rows(b)
