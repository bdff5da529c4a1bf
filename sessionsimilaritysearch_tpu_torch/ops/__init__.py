"""Kernels of the port (CUDA C++ under ``csrc/``) and the torch ops around them.

Re-exports the names the JAX package's ``ops`` exports, from the port's own
modules."""

from sessionsimilaritysearch_tpu_torch.ops.topk import (  # noqa: F401
    chunked_topk,
    exact_topk,
    l2_normalize,
    merge_topk,
    oracle_topk_np,
    recall_at_k,
    value_recall_at_k,
)
from sessionsimilaritysearch_tpu_torch.ops.hamming import (  # noqa: F401
    hamming_topk,
    pack_bits_np,
    sign_topk,
)
from sessionsimilaritysearch_tpu_torch.ops.projection import (  # noqa: F401
    PCAProjector,
    fit_pca,
)
