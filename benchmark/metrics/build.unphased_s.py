"""Seconds a build spends outside the CLI's phases: process start, imports,
CUDA start-up, exit (wall time less its phases), per build."""

from benchmark import layers

LAYER = "cli"
UNIT = "s"
SOURCE = "program_span"
MOVES = "build_s"


def read(run):
    return layers.mean(run, layers.unphased_s)
