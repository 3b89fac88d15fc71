"""Seconds of the phase "writing outputs" (``cli/emsar.py::_write_sample``:
the .fpkm and .fraglength_effect writers), summed over an invocation's
samples, per invocation."""

from benchmark import spans

LAYER = "cli"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    return spans.mean(run, lambda i: spans.seconds(
        i, lambda n: n == "writing outputs"))
