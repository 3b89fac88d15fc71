"""Wall time of the builds of the window (FASTA to .rsh, process start
included) over their count."""

UNIT = "s"
SOURCE = "host_clock"
BETTER = "lower"


def read(run):
    done = [i for i in run.invocations if i.ok]
    return sum(i.wall_s for i in done) / len(done) if done else None
