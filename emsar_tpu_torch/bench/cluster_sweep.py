"""The CSR cycle on clusters against the twelve-launch cycle, on the card,
over random CSR problems of growing size: where the cluster path stops
paying (``model/solver.py::CLUSTER_MAX_EDGES``).

    python3 -m emsar_tpu_torch.bench.cluster_sweep [--rows 1]
        [--dtype f64] [--sizes 10000,90000] [--parent DIR]
        [--row-layouts] [--out bench_cache/cluster_sweep.json]

Each problem is made of modules as the smoke fixture's CSR problem is
(gene families: 1 + a geometric number of transcripts, at most 64, ~2.3
segments a transcript, 1 + Poisson(2.2) distinct transcripts a segment;
about 3.2 edges a segment and 7.4 a transcript), read-less segments
among them, float64 unless asked, R rows from the read-attribution start
and uniform draws.  At each size: eight cycles (a block's) both ways must
give the same bits; then each way's eight cycles captured in a CUDA
graph, as the solver's loop replays them, and timed over replays with
CUDA events (``graph_ms``), with the tile plan the cluster path took.
With ``--row-layouts``, the two row layouts of the cluster path at R 3
and R 16 (``row_layouts``).  With ``--parent`` (the root of another
checkout, for example a ``git
archive`` of the parent commit in a directory that ``.gitignore`` lists)
the other checkout's sweep runs against this one's at each size, in
turns, their cycles on clusters bit-equal (``ab``).  Prints one JSON
object with the card's name and power limit and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from ..model import solver

# edges of the sweep's problems: the smoke's CSR problem has 89,744
SIZES = (10_000, 25_000, 50_000, 90_000, 180_000, 360_000, 720_000,
         1_440_000, 2_880_000, 5_760_000, 11_520_000)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_problem(rng, n_edges: int) -> solver.SolverProblem:
    """A random CSR problem of modules (see the module note) with at most
    ``n_edges`` edges, whole modules."""
    n_mod = n_edges // 20 + 2
    nt = np.minimum(1 + rng.geometric(0.2, n_mod), 64)
    nc = np.maximum(1, rng.poisson(2.3 * nt))
    seg_mod = np.repeat(np.arange(n_mod), nc)
    deg = np.minimum(1 + rng.poisson(3.0, len(seg_mod)), nt[seg_mod])
    t0 = np.concatenate([[0], np.cumsum(nt)[:-1]])
    e_seg = np.repeat(np.arange(len(seg_mod)), deg)
    e_mod = seg_mod[e_seg]
    e_tid = t0[e_mod] + (rng.random(len(e_seg)) * nt[e_mod]).astype(np.int64)
    T = int(nt.sum())
    key = np.unique(e_seg * T + e_tid)
    cid, tid = key // T, key % T
    # whole modules up to n_edges edges
    mod_edges = np.bincount(seg_mod[cid], minlength=n_mod)
    keep_mod = np.cumsum(mod_edges) <= n_edges
    keep = keep_mod[seg_mod[cid]]
    cid, tid = cid[keep], tid[keep]
    n_seg = int(nc[keep_mod].sum())
    ntid = int(nt[keep_mod].sum())
    mult = rng.integers(1, 3, len(cid)).astype(np.float64)
    eumaps = rng.uniform(0.1, 2, n_seg)
    denom = np.zeros(ntid)
    np.add.at(denom, tid, mult * eumaps[cid])
    reads = rng.poisson(3, n_seg) * (rng.random(n_seg) < 0.9) * 1.0
    return solver.SolverProblem(
        n_transcripts=ntid, edge_cid=cid.astype(np.int32),
        edge_tid=tid.astype(np.int32), edge_mult=mult, eumaps=eumaps,
        reads=reads, denom=denom)


def rows(problem: solver.SolverProblem, R: int, rng) -> np.ndarray:
    """theta [R, ntid]: the read-attribution start, then uniform draws."""
    th = np.concatenate([solver.read_attribution_start(problem)[None],
                         rng.uniform(0, 100, (R - 1, problem.n_transcripts))])
    return np.where(problem.denom > 0, th, 0.0)


def capture(fn, graph=None):
    """(``graph``, or a new CUDA graph, holding ``fn`` captured after a
    warm-up on a side stream, as ``model/loop.py`` does; what ``fn``
    returned in the capture, which each replay writes)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph() if graph is None else graph
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def graph_ms(fn, n: int = 20) -> float:
    """Device ms of ``fn`` captured in a CUDA graph (``capture``) and
    replayed ``n`` times between CUDA events."""
    graph = capture(fn)[0]
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def time_block(p, theta: torch.Tensor, cycles: int = 8, n: int = 20
               ) -> dict:
    """``cycles`` cycles of ``p`` from ``theta`` on clusters (the tile plan
    ``solver.cycle_plan`` makes) and as twelve launches a cycle: both must
    give the same bits.  Returns each way's device ms replayed from a
    graph, and the plan's tiles and cluster size."""
    plan = solver.cycle_plan(p, theta.shape[0], clusters=True)
    ways = {"cluster": plan, "launches": None}
    blocks = {k: solver._squarem_cycles(p, theta, cycles, way)
              for k, way in ways.items()}
    torch.cuda.synchronize()
    if not torch.equal(blocks["cluster"], blocks["launches"]):
        raise AssertionError("the cluster cycles differ from the twelve "
                             "launches")
    out = {f"{k}_ms": graph_ms(lambda way=way: solver._squarem_cycles(
        p, theta, cycles, way), n) for k, way in ways.items()}
    out.update(tiles=plan.n_tiles, cluster=plan.cluster)
    return out


def sweep(dev: torch.device, sizes=SIZES, R: int = 1,
          dtype: torch.dtype = torch.float64, log=print) -> dict:
    """The sweep over ``sizes`` (edges asked for) at R rows: what
    ``time_block`` measured at each, with the problem's shape, and the
    largest size at which the cluster path was faster ("crossover_edges";
    None when it never was)."""
    results, faster = [], None
    for n_edges in sizes:
        rng = np.random.default_rng(n_edges + R)
        problem = random_problem(rng, n_edges)
        p = solver.problem_to_device(problem, dev, dtype)
        th = torch.as_tensor(rows(problem, R, rng)).to(dev, dtype)
        m = time_block(p, th)
        E = int(p.by_cid.idx.shape[0])
        m.update(edges=E, segments=p.by_cid.n_groups,
                 transcripts=p.by_tid.n_groups,
                 lanes=[p.by_cid.lanes, p.by_tid.lanes])
        results.append(m)
        if m["cluster_ms"] < m["launches_ms"]:
            faster = E
        log(f"cluster sweep R={R} {str(dtype)[6:]} E={E}: eight cycles "
            f"{m['cluster_ms']:.4f} ms on clusters ({m['tiles']} tiles of "
            f"{m['cluster']} blocks), {m['launches_ms']:.4f} ms as twelve "
            f"launches a cycle, graph replays; bit-equal")
    return {"rows": R, "dtype": str(dtype)[6:], "sizes": results,
            "crossover_edges": faster}


def tilings(dev: torch.device, n_edges: int = 90_000, log=print) -> list:
    """Eight cycles of one sweep problem (R 1, float64) on each cluster
    size at the tiles the card holds at once, a half and a quarter of
    them (where a block's share fits), from CUDA graphs, each bit-equal
    to the twelve launches: [{tiles, cluster, smem, ms}], and the twelve
    launches' ms."""
    from ..kernels import csr_cluster
    rng = np.random.default_rng(n_edges + 1)
    problem = random_problem(rng, n_edges)
    p = solver.problem_to_device(problem, dev, torch.float64)
    th = torch.as_tensor(rows(problem, 1, rng)).to(dev)
    want = solver._squarem_cycles(p, th, 8, None)
    out = [{"tiles": 0, "cluster": 0, "smem": 0, "ms": graph_ms(
        lambda: solver._squarem_cycles(p, th, 8, None))}]
    for cl in csr_cluster.CLUSTERS:
        fit = csr_cluster.max_active_clusters(torch.float64, 0, cl,
                                              dev.index or 0)
        for n_tiles in sorted({max(1, fit // 4), max(1, fit // 2), fit}):
            plan = csr_cluster.tile_plan(p.by_cid, p.by_tid, n_tiles, cl)
            if plan.smem > csr_cluster.SMEM_BYTES:
                continue
            got = solver._squarem_cycles(p, th, 8, plan)
            if not torch.equal(got, want):
                raise AssertionError(f"{n_tiles} tiles of {cl} blocks "
                                     f"differ from the twelve launches")
            out.append({"tiles": n_tiles, "cluster": cl, "smem": plan.smem,
                        "ms": graph_ms(lambda plan=plan: solver.
                                       _squarem_cycles(p, th, 8, plan))})
    log(f"tilings at E={p.by_cid.idx.shape[0]}: twelve launches "
        f"{out[0]['ms']:.4f} ms; " + ", ".join(
            f"{m['tiles']} x {m['cluster']} {m['ms']:.4f} ms" for m in
            out[1:]) + " (eight cycles from a graph, bit-equal)")
    return out


def row_layouts(dev: torch.device, sizes=(25_000, 90_000, 360_000),
                rows_list=(3, 16), dtype: torch.dtype = torch.float64,
                log=print) -> list:
    """Eight cycles of sweep problems at R rows on clusters in both row
    layouts of ``csr_cluster.plan_for``: a cluster a row (R x n_tiles
    clusters, the default) and a cluster over all R rows (n_tiles
    clusters, each staging its tile once and taking the rows one after
    another), both bit-equal to the twelve launches, from CUDA graphs:
    [{rows, edges, row_ms, all_rows_ms, row_tiles, all_rows_tiles,
    cluster}]."""
    from ..kernels import csr_cluster
    out = []
    for R in rows_list:
        for n_edges in sizes:
            rng = np.random.default_rng(n_edges + R)
            problem = random_problem(rng, n_edges)
            p = solver.problem_to_device(problem, dev, dtype)
            th = torch.as_tensor(rows(problem, R, rng)).to(dev, dtype)
            want = solver._squarem_cycles(p, th, 8, None)
            plans = {k: csr_cluster.plan_for(p.by_cid, p.by_tid, R, a)
                     for k, a in (("row", 1), ("all_rows", R))}
            m = {"rows": R, "edges": int(p.by_cid.idx.shape[0]),
                 "cluster": plans["row"].cluster}
            for k, plan in plans.items():
                got = solver._squarem_cycles(p, th, 8, plan)
                if not torch.equal(got, want):
                    raise AssertionError(f"{k} layout differs from the "
                                         f"twelve launches")
                m[f"{k}_ms"] = graph_ms(lambda plan=plan: solver.
                                        _squarem_cycles(p, th, 8, plan))
                m[f"{k}_tiles"] = plan.n_tiles
            log(f"row layouts R={R} {str(dtype)[6:]} E={m['edges']}: eight "
                f"cycles {m['row_ms']:.4f} ms a cluster a row "
                f"({m['row_tiles']} tiles), {m['all_rows_ms']:.4f} ms a "
                f"cluster over all rows ({m['all_rows_tiles']} tiles); "
                f"bit-equal")
            out.append(m)
    return out


def largest_module(dtype: torch.dtype = torch.float64, cluster: int = 8
                   ) -> dict:
    """The most edges of one module made as ``random_problem`` makes its
    modules (~2.3 segments a transcript, each with 1 + Poisson(3) draws of
    its transcripts) that a cluster of ``cluster`` blocks stages: the
    largest such module, alone in a tile,
    whose blocks' shared memory (``csr_cluster._smem``) fits
    ``SMEM_BYTES``, by bisection over its transcripts.  A count of bytes,
    made on the host."""
    from ..kernels import csr_cluster
    item = torch.finfo(dtype).bits // 8

    def module(nt):
        rng = np.random.default_rng(nt)
        nc = int(round(2.3 * nt))
        deg = np.minimum(1 + rng.poisson(3.0, nc), nt)
        seg = np.repeat(np.arange(nc), deg)
        key = np.unique(seg * nt + (rng.random(len(seg)) * nt).astype(
            np.int64))
        cid, tid = key // nt, key % nt
        return (torch.as_tensor(np.bincount(cid, minlength=nc)),
                torch.as_tensor(np.bincount(tid, minlength=nt)), len(key))

    def fits(nt):
        deg_c, deg_t, _ = module(nt)
        return csr_cluster._smem(
            deg_c, torch.zeros_like(deg_c), deg_t, torch.zeros_like(deg_t),
            1, cluster, item) <= csr_cluster.SMEM_BYTES
    lo, hi = 1, 2
    while fits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    deg_c, deg_t, edges = module(lo)
    return {"cluster": cluster, "dtype": str(dtype)[6:], "edges": edges,
            "segments": int(deg_c.shape[0]), "transcripts": lo}


def ab(parent: str, dev: torch.device, sizes=SIZES, R: int = 1,
       dtype: torch.dtype = torch.float64, log=print) -> dict:
    """The sweep of another checkout (``parent``, its root) against this
    one's, in turns (parent, change, change, parent) at each size, each
    side's problem built by its own solver from the same host arrays:
    each side's ``time_block`` runs and medians, after both sides' eight
    cycles on clusters were found bit-equal."""
    import statistics
    import sys

    from . import ORDER, load_parent
    psweep, psolver = load_parent(parent, "bench.cluster_sweep",
                                  "model.solver")
    sides = {"parent": (psweep, psolver),
             "change": (sys.modules[__name__], solver)}
    results = []
    for n_edges in sizes:
        rng = np.random.default_rng(n_edges + R)
        problem = random_problem(rng, n_edges)
        th = rows(problem, R, rng)
        inputs = {who: (s.problem_to_device(problem, dev, dtype),
                        torch.as_tensor(th).to(dev, dtype))
                  for who, (_, s) in sides.items()}
        got = [s._squarem_cycles(*inputs[who], 8, s.cycle_plan(
            inputs[who][0], R, clusters=True))
            for who, (_, s) in sides.items()]
        if not torch.equal(*got):
            raise AssertionError(f"E={n_edges}: the parent's cycles on "
                                 f"clusters differ from this tree's")
        runs = {who: [] for who in sides}
        for who in ORDER:
            runs[who].append(sides[who][0].time_block(*inputs[who]))
        med = {who: {k: statistics.median(r[k] for r in v)
                     for k in ("cluster_ms", "launches_ms")}
               for who, v in runs.items()}
        E = int(inputs["change"][0].by_cid.idx.shape[0])
        results.append({"edges": E, "median": med, "runs": runs})
        log(f"cluster sweep A/B R={R} {str(dtype)[6:]} E={E}: eight cycles "
            f"on clusters parent {med['parent']['cluster_ms']:.4f} ms, "
            f"change {med['change']['cluster_ms']:.4f} ms (twelve "
            f"launches {med['parent']['launches_ms']:.4f} / "
            f"{med['change']['launches_ms']:.4f}); bit-equal")
    return {"rows": R, "dtype": str(dtype)[6:], "sizes": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f64")
    ap.add_argument("--sizes", default=None,
                    help="edges of the problems, comma-separated")
    ap.add_argument("--parent", default=None,
                    help="the root of another checkout: its sweep against "
                    "this one's, in turns")
    ap.add_argument("--row-layouts", action="store_true",
                    help="the two row layouts at R 3 and 16 (row_layouts)")
    ap.add_argument("--out", default=os.path.join("bench_cache",
                                                  "cluster_sweep.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cluster_sweep runs on the card only")
    dev = torch.device("cuda")
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    sizes = (tuple(int(v) for v in args.sizes.split(",")) if args.sizes
             else SIZES)
    if args.row_layouts:
        result = {"row_layouts": row_layouts(dev, sizes, dtype=dtype)}
    elif args.parent:
        result = ab(args.parent, dev, sizes, R=args.rows, dtype=dtype)
    else:
        result = sweep(dev, sizes, R=args.rows, dtype=dtype)
    result.update(card=card(), torch=torch.__version__,
                  cluster_max_edges=solver.CLUSTER_MAX_EDGES)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
