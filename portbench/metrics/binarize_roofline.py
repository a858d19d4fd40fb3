"""The binarize kernel's share of its roofline in the traced stretch: the
least seconds its calls' work needs at the H100's published peaks
(`portbench/roofline/binarize.py`, `portbench/peaks.py`) over the device
seconds of the kernels those calls launched, in percent."""

LAYER = "kernels"
MOVES = "pairs_per_s"


def read(tracer, window):
    s = tracer.stretch_data
    return None if s is None else s.roofline.get("binarize")
