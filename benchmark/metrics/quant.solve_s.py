"""Seconds of the phase "EM solve" or "batched solve over N samples" less the
restart rounds nested in it (model/dense.py, model/solver.py, model/loop.py,
the kernels, the host polish), per invocation."""

from benchmark import layers

LAYER = "model solve"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    return layers.mean(run, lambda i: layers.phase_s(
        i, lambda n: n == "EM solve" or n.startswith("batched solve over")))
