"""Blocks of the dense convergence loops (attribute ``blocks`` of the spans
"solve: dense batch", summed over the size classes), per invocation."""

from benchmark import spans

LAYER = "model solve"
UNIT = "blocks"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    return spans.mean(run, lambda i: spans.attr_sum(
        i, "solve: dense batch", "blocks"))
