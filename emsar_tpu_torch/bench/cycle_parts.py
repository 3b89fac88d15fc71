"""``cycle_extrap``'s and ``cycle_select``'s builds on the card: the
package's build of ``csrc/csr_cycle.cu`` (launched with programmatic
stream serialization) against the build launched without it
(``-DEMSAR_CYCLE_PDL=0``: the wait before the last input returns at
once, the kernel starts after the one before it ends) and builds whose
``cycle_select`` loads both rows before the wait at every size, or
only the picked one after it (``-DEMSAR_SELECT_EARLY_BYTES``), at the
shapes of ``bench/cycle_ab.py``:

    python3 -m emsar_tpu_torch.bench.cycle_parts [--large] [--rsh R]
        [--aln A] [--out bench_cache/cycle_parts.json]

At each shape, device ms a call from a cold L2 (``kernels.measure.
device_ms_cold``) of both kernels of every build beside their bounds
(``cycle_ab.kernel_bounds``), the package's also from a clean one (the
flush a read: no dirty line to write back), beside the floor of the
measure (an in-place negation of one element: a launch, a load and a
store), both ways; for the package's build and the one
without the attribute, in turns (package, off, off, package), eight
cycles off clusters replayed from a CUDA graph (``cluster_sweep.
graph_ms``) and, on the oversized module's problem, the solve's ms per
replayed block (``cycle_ab.solve_ms``), each build put in the package's
place for the call.  Then how the stream capture kept the attribute:
the edges of a captured cycle's graph by type (libcuda's
``cuGraphGetEdges_v2`` over torch's graph; a programmatic edge is the
overlap), where torch keeps the graph.  Every build's outputs must be
bit-equal to the package's (the two kernels, the cycles, the solve); the
script raises otherwise.  A measurement tool: the builds (one nvcc each,
all started together) go to ``emsar_tpu_torch/_build/parts/`` and are
used nowhere else.  Prints one JSON object (with the card's name and
power limit) and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import statistics

import torch

from . import ORDER, write_result
from .cluster_sweep import capture, card, graph_ms
from .cycle_ab import (_equal, cases, cycle_calls, cycle_inputs,
                       kernel_bounds, side_inputs, solve_ms)
from ..kernels import _build, csr_cycle, measure
from ..model import solver
from ..parallel import mesh

# the builds beside the package's: {name: nvcc flags}
VARIANTS = {"pdl off": ("-DEMSAR_CYCLE_PDL=0",),
            "select early": ("-DEMSAR_SELECT_EARLY_BYTES=(1LL<<40)",),
            "select late": ("-DEMSAR_SELECT_EARLY_BYTES=0",)}


@contextlib.contextmanager
def using(lib):
    """``kernels.csr_cycle``'s launches go to ``lib`` (None: the
    package's build) inside the block."""
    saved = csr_cycle._lib
    if lib is not None:
        csr_cycle._lib = lambda: lib
    try:
        yield
    finally:
        csr_cycle._lib = saved


class _EdgeData(ctypes.Structure):
    _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]


def graph_edges(fn) -> dict:
    """{"from_port type": count} of the edges of ``fn`` captured into a
    CUDA graph (type 1: programmatic, as a launch with programmatic
    stream serialization is captured), or {"error": why} where torch or
    libcuda does not give them."""
    try:
        graph = capture(fn, torch.cuda.CUDAGraph(keep_graph=True))[0]
        raw = ctypes.c_void_p(graph.raw_cuda_graph())
        drv = ctypes.CDLL("libcuda.so.1")
        get = drv.cuGraphGetEdges_v2
        n = ctypes.c_size_t(0)
        rc = get(raw, None, None, None, ctypes.byref(n))
        if rc != 0:
            return {"error": f"cuGraphGetEdges_v2 returned {rc}"}
        frm = (ctypes.c_void_p * n.value)()
        to = (ctypes.c_void_p * n.value)()
        data = (_EdgeData * n.value)()
        rc = get(raw, frm, to, data, ctypes.byref(n))
        if rc != 0:
            return {"error": f"cuGraphGetEdges_v2 returned {rc}"}
    except (AttributeError, TypeError, OSError, RuntimeError) as err:
        return {"error": repr(err)}
    counts = {}
    for d in data[:n.value]:
        key = f"{d.from_port} {d.type}"
        counts[key] = counts.get(key, 0) + 1
    return counts


def run(dev, all_cases: dict, log=print) -> dict:
    """Every case: each build's two kernels bit-equal to the package's
    and timed from a cold L2; the package's and the PDL-off build's eight
    cycles and (oversized case) solve in turns.  Returns {case: what it
    measured}."""
    libs = {name: csr_cycle.bind(lib) for name, lib in
            _build.build_variants(csr_cycle.SOURCE, VARIANTS).items()}
    libs["package"] = None
    turns = [{"parent": "package", "change": "pdl off"}[w] for w in ORDER]
    result = {}
    for name, case in all_cases.items():
        p, th = side_inputs(solver, mesh, case, dev)
        v = cycle_inputs(p, th)
        R = th.shape[0]
        bounds = kernel_bounds(p, R)
        calls = cycle_calls(csr_cycle, v)
        want = {k: fn() for k, fn in calls.items()}
        entry = {"rows": R, "edges": int(p.by_cid.idx.shape[0]),
                 "transcripts": p.by_tid.n_groups,
                 "bound_ms": {k: bounds[k][0] for k in calls}, "ms": {}}
        for build, lib in libs.items():
            with using(lib):
                for k, fn in calls.items():
                    if not _equal(fn(), want[k]):
                        raise AssertionError(f"{name} {build}: {k} differs "
                                             f"from the package's")
                    host = measure.host_ms(fn, 50)
                    entry["ms"][f"{build} {k}"] = {
                        "ms": measure.device_ms_cold(
                            fn, host_per_call_ms=host), "host_ms": host}
        one = torch.zeros(1, dtype=th.dtype, device=dev)
        timed = {**{f"package {k} clean": (fn, True)
                    for k, fn in calls.items()},
                 "floor": (one.neg_, False), "floor clean": (one.neg_, True)}
        for key, (fn, clean) in timed.items():
            entry["ms"][key] = {"ms": measure.device_ms_cold(fn,
                                                             clean=clean)}
        cycles = {b: [] for b in ("package", "pdl off")}
        theta8 = solver._squarem_cycles(p, th, 8, None)
        for build in turns:
            with using(libs[build]):
                if not _equal(solver._squarem_cycles(p, th, 8, None),
                              theta8):
                    raise AssertionError(f"{name} {build}: eight cycles "
                                         f"differ")
                cycles[build].append(graph_ms(
                    lambda: solver._squarem_cycles(p, th, 8, None)))
        entry["eight_cycles_ms"] = {b: statistics.median(x)
                                    for b, x in cycles.items()}
        entry["eight_cycles_turns"] = cycles
        if name.startswith("oversized"):
            solves = {b: [] for b in cycles}
            for build in turns:
                with using(libs[build]):
                    solves[build].append(solve_ms(solver, p, th))
            first = solves["package"][0]
            if any(x["blocks"] != first["blocks"]
                   or not _equal(x["out"], first["out"])
                   for xs in solves.values() for x in xs):
                raise AssertionError(f"{name}: the builds' solves differ")
            entry["solve"] = {b: {"blocks": xs[0]["blocks"], "median": {
                k: statistics.median(x["median"][k] for x in xs)
                for k in xs[0]["median"]}, "turns": [x["median"] for x in xs]}
                for b, xs in solves.items()}
            entry["graph_edges"] = {}
            for build in ("package", "pdl off"):
                with using(libs[build]):
                    entry["graph_edges"][build] = graph_edges(
                        lambda: solver._squarem_cycles(p, th, 1, None))
        result[name] = entry
        log(f"[cycle_parts] {name} (E={entry['edges']}, R={R}): "
            + ", ".join(f"{k} {m['ms']:.5f} ms"
                        for k, m in entry["ms"].items())
            + f"; bounds {entry['bound_ms']}; eight cycles "
            + f"{entry['eight_cycles_ms']}"
            + (f"; solve {entry['solve']}; graph edges "
               f"{entry['graph_edges']}" if "solve" in entry else ""))
        del p, th, v
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--large", action="store_true",
                    help="also the cluster sweep's largest problem")
    cache = os.path.join("bench_cache", "torch_smoke")
    ap.add_argument("--rsh", default=os.path.join(cache, "smoke.rsh"))
    ap.add_argument("--aln", default=os.path.join(cache, "smoke.bowtieout"))
    ap.add_argument("--out", default=os.path.join("bench_cache",
                                                  "cycle_parts.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cycle_parts: needs a CUDA device")
    dev = torch.device("cuda")
    write_result({"card": card(), "variants": VARIANTS,
                  "cases": run(dev, cases(args.rsh, args.aln, args.large))},
                 args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
