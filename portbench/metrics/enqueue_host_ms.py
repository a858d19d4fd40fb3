"""Host milliseconds to enqueue one `tile_scores` call of the mesh: the
program's `mesh:enqueue` stage timer (`parallel.mesh`, around each call)
over the window, its total over its count. The timer has no synchronise,
so it times the host's enqueue, not the call's device time."""

LAYER = "mesh"
MOVES = "pairs_per_s"


def read(tracer, window):
    total, count = tracer.stages
    n = count.get("mesh:enqueue", 0)
    return 1e3 * total["mesh:enqueue"] / n if n else None
