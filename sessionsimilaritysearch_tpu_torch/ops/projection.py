"""PCA and ITQ projectors for binary codes (counterpart of
``sessionsimilaritysearch_tpu/ops/projection.py``).

``PCAProjector`` :25, ``fit_itq`` :70, ``itq_codes`` :118 and ``fit_pca``
:126 are numpy; they are copied here because the JAX module imports
``jax.numpy`` for its device branch. A torch tensor is accepted wherever the
JAX code accepts a jax array: ``PCAProjector`` projects it on its device,
and the fits sample it before the copy to the host. A ``PCAProjector``
fitted by the JAX package (a NamedTuple of numpy arrays) is accepted by the
port as it is: only ``mean``, ``components`` and ``explained`` are read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


class PCAProjector(NamedTuple):
    """Fitted projection: ``project(x) = (x - mean) @ components.T``.

    components: [out_dim, d] orthonormal rows (top right-singular vectors).
    explained: fraction of total variance captured (diagnostic).
    """

    mean: np.ndarray
    components: np.ndarray
    explained: float

    def __call__(self, emb, renormalize: bool = True):
        """Project [n, d] -> [n, out_dim]; ``renormalize`` re-unit-norms
        rows. A tensor projects on its device (f32, TF32 off) and returns a
        tensor."""
        if isinstance(emb, torch.Tensor):
            dev = emb.device
            x = emb.float() - torch.from_numpy(self.mean).to(dev)
            y = x @ torch.from_numpy(self.components).to(dev).T
            if renormalize:
                y = y / y.norm(dim=-1, keepdim=True).clamp(min=1e-12)
            return y
        x = np.asarray(emb, np.float32) - self.mean
        y = x @ self.components.T
        if renormalize:
            n = np.linalg.norm(y, axis=-1, keepdims=True)
            y = y / np.clip(n, 1e-12, None)
        return y.astype(np.float32)


def fit_itq(
    emb,
    n_bits: int,
    iters: int = 50,
    sample: int = 65536,
    seed: int = 0,
) -> PCAProjector:
    """Fit a learned binary-code projector (ITQ, Gong & Lazebnik CVPR'11):
    center + PCA to ``n_bits`` directions, then an orthogonal rotation R
    minimizing ``||sign(VR) - VR||_F`` by alternating minimization (fix
    codes -> orthogonal Procrustes for R). The rotation is folded into the
    returned projector's ``components``: the code of x is
    ``sign((x - mean) @ components.T)``. The same numpy steps and random
    stream as the JAX function, so both return the same projector."""
    n, d = emb.shape
    assert 0 < n_bits <= d, (n_bits, d)
    pca = fit_pca(emb, n_bits, sample=sample, seed=seed)
    rng = np.random.default_rng(seed)
    if n > sample:
        idx = rng.choice(n, sample, replace=False)
        idx.sort()
        emb = emb[idx]
    emb = _host_f32(emb)
    V = (emb - pca.mean) @ pca.components.T  # [n, n_bits], centered
    R = np.linalg.qr(rng.standard_normal((n_bits, n_bits)))[0].astype(
        np.float32
    )
    for _ in range(iters):
        B = np.where(V @ R >= 0, 1.0, -1.0).astype(np.float32)
        U, _, Vt = np.linalg.svd(V.T @ B, full_matrices=False)
        R = (U @ Vt).astype(np.float32)
    return PCAProjector(pca.mean, (R.T @ pca.components), pca.explained)


def itq_codes(emb, projector: PCAProjector) -> np.ndarray:
    """Binary codes for a fitted ITQ projector: [n, n_bits] in {+1, -1}
    (zero projections break ties as +1, the ``simhash_codes`` convention)."""
    emb = _host_f32(emb)
    y = (emb - projector.mean) @ projector.components.T
    return np.where(y >= 0, 1.0, -1.0).astype(np.float32)


def fit_pca(emb, out_dim: int, sample: int = 65536, seed: int = 0) -> PCAProjector:
    """Fit a PCA projector on (a sample of) the corpus embeddings. A tensor
    is sampled on its device and only the [sample, d] rows cross to the
    host."""
    n, d = emb.shape
    assert 0 < out_dim <= d, (out_dim, d)
    if n > sample:
        idx = np.random.default_rng(seed).choice(n, sample, replace=False)
        idx.sort()
        emb = emb[idx]
    emb = _host_f32(emb)
    mean = emb.mean(axis=0)
    x = (emb - mean).astype(np.float32)
    _, s, vt = np.linalg.svd(x, full_matrices=False)
    var = s.astype(np.float64) ** 2
    explained = float(var[:out_dim].sum() / max(var.sum(), 1e-30))
    return PCAProjector(mean, vt[:out_dim].copy(), explained)
