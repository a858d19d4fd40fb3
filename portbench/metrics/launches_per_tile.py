"""Kernel launches a tile in the traced stretch: the profiler's device
kernels (copies and memsets left out) over the tiles the stretch ran."""

LAYER = "tile scoring"
MOVES = "pairs_per_s"


def read(tracer, window):
    s = tracer.stretch_data
    if s is None or not s.kernel_ops:
        return None
    return len(s.kernel_ops) / s.units
