"""The port's parallel layer (counterpart of
``sessionsimilaritysearch_tpu.parallel``): the mesh and its layouts
(``batch_sharding``, ``replicated``, ``shard_batch``), the multi-process
helpers (``initialize_distributed``, ``global_mesh``,
``host_local_batch_to_global``, ``process_slice``), the data-parallel
parameter layout (``param_shardings``, ``shard_params``: the embedding
tables row-sharded over the ranks) and the cross-shard collectives of
sharded serving."""

from sessionsimilaritysearch_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    create_mesh,
    replicated,
    shard_batch,
)
from sessionsimilaritysearch_tpu_torch.parallel.multihost import (  # noqa: F401
    global_mesh,
    host_local_batch_to_global,
    initialize_distributed,
    process_count,
    process_index,
    process_slice,
)
from sessionsimilaritysearch_tpu_torch.parallel.sharding import (  # noqa: F401
    param_shardings,
    shard_params,
)
