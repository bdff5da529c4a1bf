"""The port's parallel layer (counterpart of
``sessionsimilaritysearch_tpu.parallel``): the mesh, the multi-process
helpers and the cross-shard collectives. JAX's ``batch_sharding``,
``replicated``, ``shard_batch``, ``param_shardings`` and ``shard_params``
serve data-parallel training, which is not ported yet (ROADMAP.md Queue 1
item 8b)."""

from sessionsimilaritysearch_tpu_torch.parallel.mesh import Mesh, create_mesh  # noqa: F401
