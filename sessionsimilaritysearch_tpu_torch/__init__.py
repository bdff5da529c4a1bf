"""PyTorch/CUDA port of ``sessionsimilaritysearch_tpu`` for one NVIDIA H100.

The JAX package stays the reference; every module here is tested against
its counterpart there. This package imports ``torch`` and never ``jax``: it
shares only the JAX package's jax-free modules (``config``, ``tokenizer``,
``data``, ``native``, ``evalharness.metrics``).

Covered so far: the serving path. Sessions -> padded graphs -> the
flagship ``GraphLevelEncoder`` -> ``DenseIndex`` -> exact top-k through the
hand-written fused score + bucket-max CUDA kernel (``csrc/scores_bmax.cu``),
driven by ``SessionSearchEngine``; and the packed binary tier: two-stage
serving (``TwoStageIndex``, ITQ or SimHash sign codes packed 1 bit per bit,
an exact Hamming top-pool through ``csrc/packed_scores_bmax.cu``, then an
exact re-rank at full width), ``BinaryIndex`` and ``ops.hamming.hamming_topk``
(``csrc/hamming_bucket_min.cu``).

Layer map:

- ``device``      -- device resolution; TF32 off
- ``weights``     -- Flax params tree -> port ``state_dict``; SimHash projection
- ``native_build`` -- builds the shared native graph builder
- ``models``      -- transformer, embedders, HeteroGGNN, poolings, encoder
- ``ops``         -- the kernels' build and wrappers (``mips``, ``packed``,
  ``popcount``), Hamming search (``hamming``), projections, top-k helpers
- ``index``       -- ``DenseIndex``, ``BinaryIndex``, ``TwoStageIndex``
- ``evalharness`` -- ``EmbeddingPipeline``
- ``engine``      -- ``SessionSearchEngine``
"""

from sessionsimilaritysearch_tpu.config import Config, tiny_test_config  # noqa: F401
from sessionsimilaritysearch_tpu.data import SyntheticSessionGenerator  # noqa: F401
from sessionsimilaritysearch_tpu.tokenizer import get_tokenizer  # noqa: F401
from sessionsimilaritysearch_tpu_torch import device  # noqa: F401  (sets TF32 off)
from sessionsimilaritysearch_tpu_torch.engine import SessionSearchEngine  # noqa: F401
from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex  # noqa: F401
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex  # noqa: F401
from sessionsimilaritysearch_tpu_torch.index.twostage import TwoStageIndex  # noqa: F401
from sessionsimilaritysearch_tpu_torch.models.encoder import (  # noqa: F401
    GraphLevelEncoder,
    build_graph_encoder,
)
