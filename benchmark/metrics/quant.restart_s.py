"""Seconds of the phases "restart rounds" (model/quantify.py), per
invocation."""

from benchmark import layers

LAYER = "model restart rounds"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    return layers.mean(run, lambda i: layers.phase_s(
        i, lambda n: n == "restart rounds"))
