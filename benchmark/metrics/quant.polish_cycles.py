"""SQUAREM cycles of the host f64 polish (attribute ``cycles`` of the span
"solve: polish"; its cap is 200 a solve), per invocation."""

from benchmark import spans

LAYER = "model solve"
UNIT = "cycles"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    return spans.mean(run, lambda i: spans.attr_sum(
        i, "solve: polish", "cycles"))
