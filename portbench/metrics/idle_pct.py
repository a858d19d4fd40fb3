"""The device's idle share of the traced stretch of a sweep: 100 x (1 -
the union of every kernel's and copy's interval over the stretch's
length)."""

LAYER = "device"
MOVES = "pairs_per_s"


def read(tracer, window):
    s = tracer.stretch_data
    if s is None:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
