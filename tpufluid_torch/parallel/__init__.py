"""Multi-device scaling: the row-band sharded resident step over a
single-controller mesh (``shard``), and its traffic audit
(``comm_audit``)."""

from .shard import (  # noqa: F401
    Mesh,
    ResidentShardSpec,
    ShardedGridState,
    build_resident_spec,
    gather_resident,
    init_sharded_resident,
    make_plain_sharded_resident_step,
    make_resident_mesh,
    make_sharded_resident_step,
    shard_grid_state,
    unshard_grid_state,
)
