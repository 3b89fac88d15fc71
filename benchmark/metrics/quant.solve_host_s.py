"""Seconds of the EM solve's host steps: the spans "solve: problem"
(``solver.build_problem``), "solve: partition"
(``dense.partition_modules``) and "solve: loglik"
(``quantify._host_loglik``), per invocation."""

from benchmark import spans

LAYER = "model solve"
UNIT = "s"
SOURCE = "program_span"
MOVES = "reads_per_s"

NAMES = ("solve: problem", "solve: partition", "solve: loglik")


def read(run):
    return spans.mean(run, lambda i: spans.seconds(
        i, lambda n: n in NAMES))
