"""Host milliseconds a tile: the program's `sweep:tile` stage timer
(`harness.run_pairwise`, around each `tile_scores` call) over the window,
its total over its count. The timer has no synchronise, so it times the
host's enqueue of a tile, not the tile's device time."""

LAYER = "sweep engine"
MOVES = "pairs_per_s"


def read(tracer, window):
    total, count = tracer.stages
    n = count.get("sweep:tile", 0)
    return 1e3 * total["sweep:tile"] / n if n else None
