"""Host milliseconds a tile in the descriptor store: the program's spans
`store:read` (the tile's rows out of the store's memmaps into RAM, padded),
`store:h2d` (their copies to the card) and `store:upcast` (the int8
dequantization) over the window, their total over the count of
`sweep:tile`. The block-row fetches (under `sweep:row`) are included,
spread over the tiles."""

LAYER = "descriptor store"
MOVES = "pairs_per_s"
SPANS = ("store:read", "store:h2d", "store:upcast")


def read(tracer, window):
    total, count = tracer.stages
    n = count.get("sweep:tile", 0)
    if not n or not any(count.get(k) for k in SPANS):
        return None
    return 1e3 * sum(total.get(k, 0.0) for k in SPANS) / n
