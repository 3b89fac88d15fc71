"""Seconds of the phase "reading fasta file" (io/fasta.py), per build."""

from benchmark import layers

LAYER = "io"
UNIT = "s"
SOURCE = "program_span"
MOVES = "build_s"


def read(run):
    return layers.mean(run, lambda i: layers.phase_s(
        i, lambda n: n == "reading fasta file"))
