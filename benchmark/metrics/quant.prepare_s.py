"""Seconds of the phases "fragment-length weighting", "module
decomposition" and "iEUMA" (model/quantify.py, model/modules.py), per
invocation."""

from benchmark import layers

LAYER = "model prepare"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    return layers.mean(run, lambda i: layers.phase_s(
        i, lambda n: n in ("fragment-length weighting", "module decomposition",
                       "iEUMA")))
