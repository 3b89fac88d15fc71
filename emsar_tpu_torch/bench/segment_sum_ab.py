"""The CSR segment sums of a parent checkout against this one's, on the
card, in one process:

    python3 -m emsar_tpu_torch.bench.segment_sum_ab PARENT_DIR [--rsh R]
        [--aln A] [--out bench_cache/segment_sum_ab.json]

PARENT_DIR is the root of another checkout of this repository (for
example ``git archive`` of the parent commit unpacked into a directory
that ``.gitignore`` lists).  Its ``emsar_tpu_torch`` is loaded under the
name ``parent_port`` and builds its own kernels into its own ``_build/``.
The CSR problem is the smoke fixture's (``chip_smoke.py`` makes it under
``bench_cache/torch_smoke/``), float64, R = 1.

In turns (parent, change, change, parent), each of:

* the segment sums by cid and by tid: device ms per call
  (``kernels.measure.device_ms``) and host ms per call, through what each
  solver calls (the parent's public ``segment_sum``, this ``sum_groups``);
* one EM step (``model.solver._em_iter`` of each);
* the whole solve through each checkout's own ``em_solve`` (its
  convergence loop: the parent's may read the stop flag every block, this
  one replays a CUDA graph), ms per block with a sync at the end;
* the whole CSR solve, its blocks and logL.

The two must give the same bits (sums, EM step) and the same blocks and
logL; the script raises otherwise.  Prints one JSON object and writes it
to ``--out``.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import numpy as np
import torch

from . import ORDER, load_parent, smoke_sample, write_result
from ..kernels import measure
from ..model import solver


def csr_problem(rsh: str, aln: str):
    """The fixture's whole CSR problem (--solver_mode csr)."""
    x = smoke_sample(rsh, aln)
    return solver.build_problem(x.graph, x.modules, x.eumaps, x.read_count)


def timed(fn) -> dict:
    host = measure.host_ms(fn)
    return {"ms": measure.device_ms(fn, host_per_call_ms=host),
            "host_ms": host}


def blocks_ms(em_solve, p, th0) -> float:
    """Wall ms per SQUAREM block of the whole solve, synced (after a warm
    solve)."""
    em_solve(p, th0, 1e-9, 8, 200000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, it = em_solve(p, th0, 1e-9, 8, 200000)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / it


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    cache = os.path.join("bench_cache", "torch_smoke")
    ap.add_argument("--rsh", default=os.path.join(cache, "smoke.rsh"))
    ap.add_argument("--aln", default=os.path.join(cache, "smoke.bowtieout"))
    ap.add_argument("--out", default=os.path.join("bench_cache",
                                                  "segment_sum_ab.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("segment_sum_ab: needs a CUDA device")
    dev = torch.device("cuda")
    pss, psolver = load_parent(args.parent, "kernels.segment_sum",
                               "model.solver")
    problem = csr_problem(args.rsh, args.aln)
    p = {"parent": psolver.problem_to_device(problem, dev, torch.float64),
         "change": solver.problem_to_device(problem, dev, torch.float64)}
    th0 = torch.as_tensor(solver.read_attribution_start(problem))[None].to(dev)
    rng = np.random.default_rng(5)
    xs = {label: torch.as_tensor(rng.uniform(0, 10, (1, n))).to(dev)
          for label, n in (("by_cid", problem.n_transcripts),
                           ("by_tid", len(problem.eumaps)))}

    def calls(who):
        q = p[who]
        out = {}
        for label, x in xs.items():
            g = getattr(q, label)
            if who == "parent":
                out[label] = (lambda g=g, x=x:
                              pss.segment_sum(x, g.mult, g.idx, g.offsets))
            else:
                out[label] = lambda g=g, x=x: solver._segment_sum(g, x)
        em_iter = psolver._em_iter if who == "parent" else solver._em_iter
        out["em_step"] = lambda: em_iter(q, th0)
        return out

    fns = {who: calls(who) for who in ("parent", "change")}
    for name in fns["change"]:
        a, b = fns["parent"][name](), fns["change"][name]()
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: parent and change differ")
    res = {who: {name: [] for name in list(fns[who]) + ["block_ms"]}
           for who in fns}
    for who in ORDER:
        for name, fn in fns[who].items():
            res[who][name].append(timed(fn))
        em_solve = psolver.em_solve if who == "parent" else solver.em_solve
        res[who]["block_ms"].append(blocks_ms(em_solve, p[who], th0))
    solves = {}
    for who in ORDER[:2]:
        mod = psolver if who == "parent" else solver
        t0 = time.perf_counter()
        _, ll, blocks = mod.solve(problem, dev, dtype=np.float64)
        solves[who] = {"blocks": blocks, "logL": ll,
                       "solve_s": time.perf_counter() - t0}
    if solves["parent"]["blocks"] != solves["change"]["blocks"] or \
            solves["parent"]["logL"] != solves["change"]["logL"]:
        raise AssertionError(f"the CSR solves differ: {solves}")
    summary = {who: {name: (statistics.median(v) if name == "block_ms" else
                            {k: statistics.median(d[k] for d in v)
                             for k in ("ms", "host_ms")})
                     for name, v in res[who].items()} for who in res}
    out = {"card": torch.cuda.get_device_name(0), "order": ORDER,
           "median": summary, "runs": res, "solve": solves,
           "edges": int(problem.edge_cid.shape[0]),
           "segments": len(problem.eumaps),
           "transcripts": problem.n_transcripts,
           "lanes": {label: getattr(p["change"], label).lanes
                     for label in xs}}
    write_result(out, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
