"""Share of the window spent writing results back on the host: the
program's spans `sweep:scatter` (the flushed tiles' scores into the score
matrices and the done map) and `sweep:ledger` (the memmaps flushed and the
tile ledger written) over the window's seconds, in percent."""

LAYER = "sweep engine"
MOVES = "pairs_per_s"
SPANS = ("sweep:scatter", "sweep:ledger")


def read(tracer, window):
    total, count = tracer.stages
    if not any(count.get(k) for k in SPANS):
        return None
    return 100.0 * sum(total.get(k, 0.0) for k in SPANS) / window["seconds"]
