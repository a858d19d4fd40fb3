"""Device-mesh and multi-process sharding of the N x N pair grid (port of
`acoss_tpu.parallel`)."""

from acoss_tpu_torch.parallel.distributed import (  # noqa: F401
    assign_block_rows,
    initialize,
    merge_partials,
    run_process_shard,
    run_process_shard_hybrid,
)
from acoss_tpu_torch.parallel.mesh import (  # noqa: F401
    make_pair_mesh,
    sharded_pair_scores,
    sharded_pair_scores_triangular,
)
