"""Share of its roofline that ``window_hash_kernel`` (csrc/window_hash.cu)
reaches in a build: the least time of the bytes the SE hash has to move, at
the published HBM bandwidth of one H100, over the kernel's device time in
the profiler's trace, per build.  ``bytes_moved`` is a frozen copy of
``emsar_tpu_torch/kernels/window_hash.py::bytes_moved``: the forward codes
the windows read, the reverse-complement stretch of as many bytes when
unstranded, each window's transcript id and the four int32 outputs."""

from benchmark import layers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "build_s"


def bytes_moved(borderpos: int, rl: int, unstranded: bool) -> int:
    n = borderpos - rl + 1
    return (2 if unstranded else 1) * borderpos + 4 * n + 16 * n


def read(run):
    c = run.cell.config
    least = bytes_moved(run.facts["borderpos"], c["read_length"],
                        c["strand"] == "ns") / layers.HBM_BYTES_PER_S

    def share(inv):
        t = sum(v for k, v in inv.record.get("trace", {})
                .get("by_name", {}).items() if "window_hash" in k)
        return 100.0 * least / t if t > 0 else None
    return layers.mean(run, share)
