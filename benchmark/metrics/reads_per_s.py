"""Reads of every invocation that completed in the window over the window's
wall time, from the first invocation's launch to the last one's exit:
process start and CUDA start-up included, as users pay them per sample."""

UNIT = "reads/s"
SOURCE = "host_clock"
BETTER = "higher"


def read(run):
    done = [i for i in run.invocations if i.ok]
    return sum(i.reads for i in done) / run.window_s if done else None
