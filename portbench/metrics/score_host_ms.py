"""Host milliseconds of a tile's scoring: the program's span `score:tile`
(around `tile_scores` alone, inside `sweep:tile`) over the window, its
total over its count. No synchronise: the host's enqueue of the tile's
kernels, where a host-bound tile spends its time."""

LAYER = "tile scoring"
MOVES = "pairs_per_s"


def read(tracer, window):
    total, count = tracer.stages
    n = count.get("score:tile", 0)
    return 1e3 * total["score:tile"] / n if n else None
