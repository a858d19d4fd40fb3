"""Share of the window spent in the sweep's flushes: the program's
`sweep:flush` stage timer (`_TileSweeper.flush`, the stacked readback of
pending tiles) over the window's seconds, in percent."""

LAYER = "sweep engine"
MOVES = "pairs_per_s"


def read(tracer, window):
    total, count = tracer.stages
    if not count.get("sweep:flush"):
        return None
    return 100.0 * total["sweep:flush"] / window["seconds"]
