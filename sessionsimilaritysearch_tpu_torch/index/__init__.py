"""Indexes of the port (counterparts of ``sessionsimilaritysearch_tpu.index``)."""

from sessionsimilaritysearch_tpu_torch.index.dense import DenseIndex, build_index  # noqa: F401
from sessionsimilaritysearch_tpu_torch.index.binary import BinaryIndex  # noqa: F401
from sessionsimilaritysearch_tpu_torch.index.sharded import ShardedDenseIndex  # noqa: F401
from sessionsimilaritysearch_tpu_torch.index.sharded_binary import (  # noqa: F401
    ShardedBinaryIndex,
)
from sessionsimilaritysearch_tpu_torch.index.twostage import (  # noqa: F401
    ShardedTwoStageIndex,
    TwoStageIndex,
    build_twostage_index,
)
