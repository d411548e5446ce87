from sed_jax.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
)
