"""PyTorch/CUDA port of ``sessionsimilaritysearch_tpu`` for one NVIDIA H100.

The JAX package stays the reference; every module here is tested against
its counterpart there. This package imports ``torch`` and nothing of JAX or
of the JAX package: the jax-free modules it needs (``config``,
``tokenizer``, ``data``, ``native``, ``evalharness.metrics``) are copies of
the JAX package's, with their imports pointed at this package.

Covered so far: the serving path. Sessions -> padded graphs -> the
flagship ``GraphLevelEncoder`` -> ``DenseIndex`` -> exact top-k through the
hand-written fused score + bucket-max CUDA kernel K1 (``csrc/scores_bmax*.cu``),
driven by ``SessionSearchEngine``, with the serving verbs of the JAX
package's: the index's ``remove_ids``, ``range_search``, ``merge_from``,
snapshots (``save`` / ``load``, the JAX package's npz format), centered
cosine and ``metric='l2'`` (K1 with a per-row penalty of -|c|^2), and the
engine's async ingest, removal, expiry, hybrid fusion, range search and
save / restore, all searching through K1; int8 storage (``quantize='int8'`` and
``'int8x8'``, the latter through ``csrc/scores_bmax_int8.cu``); the packed
binary tier: two-stage serving (``TwoStageIndex``, ITQ or SimHash sign codes
packed 1 bit per bit, an exact Hamming top-pool through
``csrc/packed_scores_bmax.cu``, then an exact re-rank at full width),
``BinaryIndex`` and ``ops.hamming.hamming_topk``
(``csrc/hamming_bucket_min.cu``); and ``ops.mips.bucketed_topk``
(``csrc/bucket_max.cu``) and ``ops.mips.scores_matmul``
(``csrc/scores_matmul.cu``).

Layer map:

- ``config``, ``tokenizer``, ``data``, ``native``, ``evalharness.metrics``
  -- copies of the JAX package's jax-free modules
- ``device``      -- device resolution; TF32 off
- ``weights``     -- Flax params tree -> port ``state_dict``; SimHash projection
- ``native_build`` -- builds the native graph builder from ``native/``
- ``models``      -- transformer, embedders, HeteroGGNN, poolings, encoder
- ``ops``         -- the kernels' build and wrappers (``mips``, ``mips_int8``,
  ``packed``, ``popcount``), Hamming search (``hamming``), projections,
  top-k helpers
- ``index``       -- ``DenseIndex``, ``BinaryIndex``, ``TwoStageIndex``
- ``evalharness`` -- ``EmbeddingPipeline``, metrics
- ``engine``      -- ``SessionSearchEngine``
"""

from sessionsimilaritysearch_tpu_torch.config import Config, tiny_test_config  # noqa: F401
from sessionsimilaritysearch_tpu_torch.data import SyntheticSessionGenerator  # noqa: F401
from sessionsimilaritysearch_tpu_torch.tokenizer import get_tokenizer  # noqa: F401
from sessionsimilaritysearch_tpu_torch import device  # noqa: F401  (sets TF32 off)
from sessionsimilaritysearch_tpu_torch.engine import SessionSearchEngine  # noqa: F401
from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex  # noqa: F401
from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex  # noqa: F401
from sessionsimilaritysearch_tpu_torch.index.twostage import TwoStageIndex  # noqa: F401
from sessionsimilaritysearch_tpu_torch.models.encoder import (  # noqa: F401
    GraphLevelEncoder,
    build_graph_encoder,
)
