"""Host-to-device copy milliseconds a tile in the traced stretch: the
device time of the profiler's `Memcpy HtoD` operations over the tiles the
stretch ran (the streamed engine slices each column tile from the store's
memmaps and copies its keys to the card)."""

LAYER = "descriptor store"
MOVES = "pairs_per_s"


def read(tracer, window):
    s = tracer.stretch_data
    if s is None or s.h2d_s <= 0:
        return None
    return 1e3 * s.h2d_s / s.units
