"""Seconds of the spans "solve: dense batch" (``quantify._solve_auto``: a
dense size class's upload, convergence loop and read-back), summed, per
invocation."""

from benchmark import spans

LAYER = "model solve"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    return spans.mean(run, lambda i: spans.seconds(
        i, lambda n: n == "solve: dense batch"))
