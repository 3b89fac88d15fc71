"""Seconds from the harness's start to the window's: imports, the kernels'
build (cached in the checkout after the first run), the configuration's
index (made once per checkout) and the run's inputs."""

UNIT = "s"
SOURCE = "host_clock"
BETTER = "lower"


def read(run):
    return run.setup_s
