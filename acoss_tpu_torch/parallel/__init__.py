"""Multi-process sharding of the N x N pair grid (port of
`acoss_tpu.parallel`; the device-mesh sweeps are not ported yet)."""

from acoss_tpu_torch.parallel.distributed import (  # noqa: F401
    assign_block_rows,
    merge_partials,
    run_process_shard,
    run_process_shard_hybrid,
)
