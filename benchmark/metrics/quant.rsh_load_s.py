"""Seconds of the phase "reading rsh file" (io/rsh.py), per invocation."""

from benchmark import layers

LAYER = "io"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    return layers.mean(run, lambda i: layers.phase_s(
        i, lambda n: n == "reading rsh file"))
