"""The highest torch.cuda.max_memory_allocated() of any invocation of the
window, in GiB."""

UNIT = "GiB"
SOURCE = "host_clock"
BETTER = "lower"


def read(run):
    peaks = [i.record.get("peak_bytes", 0) for i in run.invocations]
    return max(peaks) / 2**30 if any(peaks) else None
