"""PyTorch/CUDA port of ``sessionsimilaritysearch_tpu`` for one NVIDIA H100.

The JAX package stays the reference; every module here is tested against
its counterpart there. This package imports ``torch`` and nothing of JAX or
of the JAX package: the jax-free modules it needs (``config``,
``tokenizer``, ``data``, ``native``, ``evalharness.metrics``,
``evalharness.knn``, ``index.sparse``, ``utils.logging``) are copies of the
JAX package's, with their imports pointed at this package.

Covered so far: the serving path. Sessions -> padded graphs -> the
flagship ``GraphLevelEncoder`` -> ``DenseIndex`` -> exact top-k through the
hand-written fused score + bucket-max CUDA kernel K1 (``csrc/scores_bmax*.cu``),
driven by ``SessionSearchEngine``, with the serving verbs of the JAX
package's: the index's ``remove_ids``, ``range_search``, ``merge_from``,
snapshots (``save`` / ``load``, the JAX package's npz format), centered
cosine and ``metric='l2'`` (K1 with a per-row penalty of -|c|^2), and the
engine's async ingest, removal, expiry, hybrid fusion, range search and
save / restore, all searching through K1; the selection modes of
``ops.topk.chunked_topk`` (``'exact'``, ``'sort'``, and ``'approx'`` /
``'exact_cert'``, which select exactly on the GPU); int8 storage
(``quantize='int8'`` and ``'int8x8'``, the latter through
``csrc/scores_bmax_int8.cu``); the binary and two-stage tiers:
``TwoStageIndex`` with every prefilter ('binary' / 'itq' sign codes ranked
by K1's sign matmul or packed through ``csrc/packed_scores_bmax.cu``,
'int8x8' through K2, 'pca' through K1, then an exact re-rank at full
width), ``BinaryIndex`` in both modes, both with the JAX indexes'
maintenance verbs and snapshots, the two-stage engine's removal, expiry
and save / restore, and ``ops.hamming.hamming_topk``
(``csrc/hamming_bucket_min.cu``); and ``ops.mips.bucketed_topk``
(``csrc/bucket_max.cu``) and ``ops.mips.scores_matmul``
(``csrc/scores_matmul.cu``). The flagship serving forward: bf16 serving
parameters (``utils.precision.serving_params``), catalog title and keyword
tables and the cached forward that gathers from them
(``evalharness.harness.build_title_table``, ``build_keyword_table``,
``make_cached_encode_fn``), the recency SR-GNN pooling, and the evaluation
harness's runners (``evaluate_encoder``, ``evaluate_binary``, the kNN,
sparse and hybrid runners, saved results). The pretrainer: ``PretrainModel``
(the Unify-pooling encoder, the target asin embedding, the heads and the
loss menu), ``adam_with_clip``, ``run_training`` with ``torch.save``
checkpoints, and a reader of the JAX trainers' flax msgpack checkpoints.
The session trainers and the fine-tuner; ``HGT`` and ``NodeLevelEncoder``;
the CLI (``python -m sessionsimilaritysearch_tpu_torch.cli``, on the card
unless ``--device cpu``); the profiling and sanitizer utilities.

Layer map:

- ``config``, ``tokenizer``, ``data``, ``native``, ``evalharness.metrics``,
  ``evalharness.knn``, ``index.sparse``, ``utils.logging`` -- copies of the
  JAX package's jax-free modules
- ``device``      -- device resolution; TF32 off
- ``weights``     -- Flax params tree -> port ``state_dict``; a JAX train
  state -> a port ``TrainState``; SimHash projection
- ``native_build`` -- builds the native graph builder from ``native/``
- ``models``      -- transformer, embedders, HeteroGGNN, HGT, poolings,
  heads, the flagship, node-level and the trainers' encoders
- ``ops``         -- the kernels' build and wrappers (``mips``, ``mips_int8``,
  ``packed``, ``popcount``), Hamming search (``hamming``), projections,
  top-k helpers
- ``index``       -- ``DenseIndex``, ``BinaryIndex``, ``TwoStageIndex``
- ``training``    -- the pretrainer, the session trainers, the fine-tuner,
  their losses, the train state and the loop
- ``utils``       -- precision policies (``serving_params``), profiling,
  sanitizers, checkpoints (and the JAX checkpoint reader)
- ``evalharness`` -- ``EmbeddingPipeline``, catalog tables and the cached
  encode fn, the evaluation runners, metrics
- ``engine``      -- ``SessionSearchEngine``
- ``cli``         -- the command-line entry points (``sss-torch``)
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
