"""Multi-device training and serving of the port (counterpart of
``pointcloudprocessing_tpu/parallel``): process groups, meshes, row shards,
state broadcast and group batch statistics (``parallel/mesh.py``).

The JAX package's ``batch_sharding`` and ``replicated_sharding`` are
``jax.sharding`` objects and have no twin: a rank takes its rows with
``shard_batch``, and the state is whole on every rank."""

from pointcloudprocessing_tpu_torch.parallel.mesh import (
    data_parallel_mesh,
    initialize_multihost,
    shard_batch,
    shard_train_state,
)

__all__ = [
    "data_parallel_mesh",
    "initialize_multihost",
    "shard_batch",
    "shard_train_state",
]
