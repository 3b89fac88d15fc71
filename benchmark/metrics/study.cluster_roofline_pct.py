"""Share of their roofline that the CSR cycle's cluster kernels,
``cluster_em_pair`` and ``cluster_extrap_gain`` (csrc/csr_cluster.cu),
reach in a study: the least time of the bytes their launches have to move,
at the published HBM bandwidth of one H100, over the two kernels' device
time in the profiler's trace, per invocation.

A launch's bytes depend only on the shape of the problem it solves: its
edges E, segments C, transcripts T, the rows R solved together and the
rows of its per-row operands, and the solve's float size.  ``launch_bytes``
is a frozen copy of the byte terms of ``chip_smoke.py::cluster_bounds``,
with the tiled groupings counted as the two groupings of the edges they
hold (each edge's weight and endpoint, each group's end and id).  The
launches and shapes come from the spans that ran the kernels, whose
attributes say so (``cluster_launches``, ``edges``, ``segments``,
``transcripts``, ``rows``, ``operand_rows``): the batched solve's "solve:
sharded loop", each sample's restart rounds and polish.  A cycle is one
launch of each kernel.  Where no such span launched them, or the trace
holds neither kernel, it reads None."""

from benchmark import layers, spans

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reads_per_s"

KERNELS = ("cluster_em_pair", "cluster_extrap_gain")


def launch_bytes(E: int, C: int, T: int, R: int, oR: int, item: int) -> dict:
    """{kernel: bytes of one launch}: each input read once, each output
    written once."""
    groups = 2 * E * (item + 4) + 8 * (C + T + 2) + 4 * (C + T)
    return {"cluster_em_pair": groups + item * oR * (C + T)
            + item * R * 5 * T,
            "cluster_extrap_gain": groups + item * oR * (2 * C + T)
            + item * R * (4 * T + 2 + C)}


def least_s(inv, item: int):
    total, seen = 0.0, False
    for _, _, a in spans.spans(inv):
        if "cluster_launches" not in a:
            continue
        seen = True
        per = launch_bytes(*(int(a[k]) for k in (
            "edges", "segments", "transcripts", "rows", "operand_rows")),
            item)
        total += int(a["cluster_launches"]) / 2 * sum(per.values())
    return total / layers.HBM_BYTES_PER_S if seen else None


def read(run):
    item = 8 if run.cell.config.get("solver_dtype") == "float64" else 4

    def share(inv):
        t = sum(v for k, v in inv.record.get("trace", {})
                .get("by_name", {}).items()
                if any(n in k for n in KERNELS))
        least = least_s(inv, item)
        if not t > 0 or not least:
            return None
        return 100.0 * least / t
    return layers.mean(run, share)
