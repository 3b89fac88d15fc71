"""Blocks of the batched solve's convergence loop (attribute ``blocks`` of
the span "solve: sharded loop"), per invocation."""

from benchmark import spans

LAYER = "model solve"
UNIT = "blocks"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    return spans.mean(run, lambda i: spans.attr_sum(
        i, "solve: sharded loop", "blocks"))
