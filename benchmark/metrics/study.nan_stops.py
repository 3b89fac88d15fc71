"""Batched solves that stopped on a NaN block gain: spans "solve: sharded
loop" with ``stop=nan`` (``model/loop.py::finish``), per invocation."""

from benchmark import spans

LAYER = "model solve"
UNIT = "loops"
SOURCE = "program_span"
MOVES = "reads_per_s"


def nan_stops(inv):
    stops = [a.get("stop") for n, _, a in spans.spans(inv)
             if n == "solve: sharded loop"]
    return sum(s == "nan" for s in stops) if stops else None


def read(run):
    return spans.mean(run, nan_stops)
