"""Seconds of the phase "writing rsh file" (io/rsh.py), per build."""

from benchmark import layers

LAYER = "io"
UNIT = "s"
SOURCE = "program_span"
MOVES = "build_s"


def read(run):
    return layers.mean(run, lambda i: layers.phase_s(
        i, lambda n: n == "writing rsh file"))
