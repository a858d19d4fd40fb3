"""The benchmark of acoss_tpu_torch on NVIDIA H100 cards: one command runs
one cell (a configuration under a traffic mix) once. See `run.py`."""
