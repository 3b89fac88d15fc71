"""Seconds of the phases "SE dev: ..." (index/device_build.py: upload, hash,
sort, accumulate, finalize; each ends in a device sync), per build."""

from benchmark import layers

LAYER = "index"
UNIT = "s"
SOURCE = "program_span"
MOVES = "build_s"


def read(run):
    return layers.mean(run, lambda i: layers.phase_s(
        i, lambda n: n.startswith("SE dev:")))
