"""The device's idle share of the traced stretch under the descriptor
store: 100 x the stretch's idle seconds (no kernel, copy or memset
running) during which the main thread's innermost program span is a
`store:` span, over the stretch's seconds (`portbench/spans.py`: exact
overlaps)."""

LAYER = "descriptor store"
MOVES = "pairs_per_s"


def read(tracer, window):
    from portbench import spans

    return spans.idle_pct(tracer.stretch_data, "store:")
