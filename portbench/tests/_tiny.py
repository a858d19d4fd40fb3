"""Cells shrunk to a size the CPU runs in seconds (the plain versions of
the kernels): the same drivers, configurations and checks."""

DATACOS = {"corpus": {"n_cliques": 3, "clique_size": 3, "n_distractors": 2,
                      "n_states": 12, "base_duration": 120.0, "width": None}}
COVERS80 = {"corpus": {"n_cliques": 3, "clique_size": 2, "n_states": 12,
                       "base_duration": 120.0, "width": None}}

TINY = {
    "serra09-datacos.stream-sweep": {
        "config": DATACOS,
        "workload": {"traffic": {"tile": 4, "band_rows": 1}}},
    "earlysnf-covers80.sweep": {
        "config": COVERS80,
        "workload": {"traffic": {"tile": 2, "band_rows": 1}}},
}
CELLS = sorted(TINY)
