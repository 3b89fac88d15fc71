"""Seconds of the phases "reading alignment file ..." and "building native
ingest tables" (ingest/native.py, csrc/ingest.cc), per invocation."""

from benchmark import layers

LAYER = "ingest"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    return layers.mean(run, lambda i: layers.phase_s(
        i, lambda n: n.startswith("reading alignment file")
        or n == "building native ingest tables"))
