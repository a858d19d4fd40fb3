"""Device milliseconds a tile in the traced stretch: the union of every
kernel's and copy's interval (overlapping work counted once) over the
tiles the stretch ran."""

LAYER = "tile scoring"
MOVES = "pairs_per_s"


def read(tracer, window):
    s = tracer.stretch_data
    if s is None or s.busy_s <= 0:
        return None
    return 1e3 * s.busy_s / s.units
