"""Seconds of the span "solve: sharded loop" of ``emsar -M
--batch_samples`` (``parallel/mesh.py::solve_sharded`` over every sample of
the study, with its upload), per invocation."""

from benchmark import spans

LAYER = "model solve"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    return spans.mean(run, lambda i: spans.seconds(
        i, lambda n: n == "solve: sharded loop"))
