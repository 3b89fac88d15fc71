"""Seconds of the span "solve: polish" (``quantify._polish``: the host f64
SQUAREM polish, ``csrc/solver.cc``), per invocation."""

from benchmark import spans

LAYER = "model solve"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    return spans.mean(run, lambda i: spans.seconds(
        i, lambda n: n == "solve: polish"))
