"""PyTorch/CUDA port of ``sessionsimilaritysearch_tpu`` for one NVIDIA H100.

The JAX package stays the reference; every module here is tested against
its counterpart there. This package imports ``torch`` and never ``jax``: it
shares only the JAX package's jax-free modules (``config``, ``tokenizer``,
``data``, ``native``, ``evalharness.metrics``).

Covered so far: the serving path. Sessions -> padded graphs -> the
flagship ``GraphLevelEncoder`` -> ``DenseIndex`` -> exact top-k through the
hand-written fused score + bucket-max CUDA kernel (``csrc/scores_bmax.cu``),
driven by ``SessionSearchEngine``.

Layer map:

- ``device``      -- device resolution; TF32 off
- ``weights``     -- Flax params tree -> port ``state_dict``
- ``models``      -- transformer, embedders, HeteroGGNN, poolings, encoder
- ``ops``         -- the kernel's build and wrapper (``mips``), top-k helpers
- ``index``       -- ``DenseIndex``
- ``evalharness`` -- ``EmbeddingPipeline``
- ``engine``      -- ``SessionSearchEngine``
"""

from sessionsimilaritysearch_tpu.config import Config, tiny_test_config  # noqa: F401
from sessionsimilaritysearch_tpu.data import SyntheticSessionGenerator  # noqa: F401
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer  # noqa: F401
from sessionsimilaritysearch_tpu_torch import device  # noqa: F401  (sets TF32 off)
from sessionsimilaritysearch_tpu_torch.engine import SessionSearchEngine  # noqa: F401
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex  # noqa: F401
from sessionsimilaritysearch_tpu_torch.models.encoder import (  # noqa: F401
    GraphLevelEncoder,
    build_graph_encoder,
)
