"""Multi-device scaling over a single-controller mesh (``shard``): the
slab-sharded step of the per-step engines and the row-band sharded
resident step, and their traffic audit (``comm_audit``)."""

from .shard import (  # noqa: F401
    Mesh,
    ResidentShardSpec,
    ShardSpec,
    ShardedGridState,
    ShardedState,
    Slab,
    build_resident_spec,
    build_shard_spec,
    gather_resident,
    gather_state,
    init_sharded,
    init_sharded_resident,
    make_eager_sharded_resident_step,
    make_eager_sharded_step,
    make_mesh,
    make_plain_sharded_resident_step,
    make_plain_sharded_step,
    make_resident_mesh,
    make_sharded_resident_step,
    make_sharded_step,
    shard_grid_state,
    unshard_grid_state,
)
