"""Seconds an invocation spends outside the CLI's phases: process start,
imports, CUDA start-up, kernel loading, the writers, exit (the invocation's
wall time less its phases), per invocation."""

from benchmark import layers

LAYER = "cli"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    return layers.mean(run, layers.unphased_s)
