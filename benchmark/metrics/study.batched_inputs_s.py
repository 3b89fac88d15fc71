"""Seconds of the span "solve: batched inputs" of ``emsar -M
--batch_samples`` (``model/quantify.py::quantify_samples_batched``: each
sample's fragment-length weights and EUMA, one module decomposition, the
batch's matrices), per invocation."""

from benchmark import spans

LAYER = "model solve"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(run):
    return spans.mean(run, lambda i: spans.seconds(
        i, lambda n: n == "solve: batched inputs"))
