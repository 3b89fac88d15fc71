"""Share of an invocation's wall time in which no kernel ran on the device:
100 x (1 - union of the profiler's kernel intervals / wall), per invocation."""

from benchmark import layers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reads_per_s"


def read(run):
    return layers.mean(run, layers.idle_pct)
