"""Seconds of the phase "device start-up" (``emsar_tpu_torch/device.py::
start_up``: the CUDA context, one allocation and one synchronise), per
build."""

from benchmark import spans

LAYER = "cli"
UNIT = "s"
SOURCE = "program_span"
MOVES = "build_s"


def read(run):
    return spans.mean(run, lambda i: spans.seconds(
        i, lambda n: n == "device start-up"))
