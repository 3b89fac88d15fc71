"""Seconds from the program package's first line to the end of the CLI
module's import (the span "imports", ``emsar_tpu_torch/utils/timing.py::
record_imports``; a traced run's profiler start falls after it), per
build."""

from benchmark import spans

LAYER = "cli"
UNIT = "s"
SOURCE = "program_span"
MOVES = "build_s"


def read(run):
    return spans.mean(run, lambda i: spans.seconds(
        i, lambda n: n == "imports"))
