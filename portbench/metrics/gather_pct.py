"""Share of the sweeps' time the mesh spends putting its results together
on the host: the program's `mesh:gather` (each block read back into the
host matrix, with the wait for its card) and `mesh:fold` (the triangle,
the mirror and the crop) stage timers over the seconds the window spent
inside sweeps (`sweep_seconds`; in a traced window the profiler's
read-back of its stretch is outside them), in percent."""

LAYER = "mesh"
MOVES = "pairs_per_s"
SPANS = ("mesh:gather", "mesh:fold")


def read(tracer, window):
    total, count = tracer.stages
    if not any(count.get(k) for k in SPANS):
        return None
    return 100.0 * sum(total.get(k, 0.0) for k in SPANS) \
        / window["sweep_seconds"]
