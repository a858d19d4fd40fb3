"""Host-to-device copies a tile: the program's counter `store:h2d_copies`
(each descriptor leaf the store's upload moves from host memory to the
card) over the window, over the count of `sweep:tile`. The block-row
fetches are included, spread over the tiles."""

LAYER = "descriptor store"
MOVES = "pairs_per_s"


def read(tracer, window):
    from acoss_tpu_torch.utils import profiling

    counters = getattr(profiling.stages, "counters", None) or {}
    n = tracer.stages[1].get("sweep:tile", 0)
    if not n or "store:h2d_copies" not in counters:
        return None
    return counters["store:h2d_copies"] / n
