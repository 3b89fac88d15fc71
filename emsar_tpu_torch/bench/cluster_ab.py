"""The two cluster kernels of the CSR cycle (``kernels/csr_cluster.py``)
of a parent checkout against this one's, on the card, in one process:

    python3 -m emsar_tpu_torch.bench.cluster_ab PARENT_DIR [--rsh R]
        [--aln A] [--out bench_cache/cluster_ab.json]

PARENT_DIR is the root of another checkout of this repository (for
example ``git archive`` of the parent commit unpacked into a directory
that ``.gitignore`` lists); its ``emsar_tpu_torch`` is loaded under the
name ``parent_port``.  The problems are the smoke fixture's
(``chip_smoke.py`` makes it under ``bench_cache/torch_smoke/``): its CSR
problem at R 1 (the read-attribution start), its restart problem at R 3
(``restart_inits``' draws), both in float64 and float32, and the
``bench.MS_SAMPLES``-sample batched problem at R 16 (float64, a row of
reads, EUMAps and 1 / denom each).  Each side builds its own device
inputs from the same host arrays and makes its own tile plan
(``solver.cycle_plan``: its host ms is recorded, and for this tree also
the ms of taking it from the plan cache).

In turns (parent, change, change, parent), device ms and host ms a call
(``kernels.measure``) of cluster_em_pair from theta and of
cluster_extrap_gain on that cycle's t1, t2 and row sums.  Both sides'
outputs must be bit-equal; the script raises otherwise.  Prints one JSON
object (with the card's name and power limit) and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import numpy as np
import torch

from . import ORDER, batched_sample, load_parent, smoke_sample, write_result
from .cluster_sweep import card
from ..config import QuantConfig
from ..kernels import csr_cluster, measure
from ..model import quantify, solver
from ..parallel import mesh


def problems(x, b):
    """{case: (host problem or batched inputs, R, dtype)}."""
    problem = solver.build_problem(x.graph, x.modules, x.eumaps,
                                   x.read_count)
    sub = quantify.restart_problem(problem)[0]
    R3 = QuantConfig().num_round - 1
    out = {}
    for dt in (torch.float64, torch.float32):
        name = str(dt)[6:]
        out[f"csr R=1 {name}"] = (problem, 1, dt)
        out[f"csr restarts R={R3} {name}"] = (sub, R3, dt)
    out[f"batched R={b.R.shape[0]} float64"] = (b, b.R.shape[0],
                                                torch.float64)
    return out


def side_inputs(mods, case, dev):
    """One side's (problem on the card, theta [R, T]) of a case."""
    msolver, mmesh = mods
    host, R, dt = case
    if isinstance(host, solver.SolverProblem):
        p = msolver.problem_to_device(host, dev, dt)
        if R == 1:
            th = solver.read_attribution_start(host)[None]
        else:
            th = solver.restart_inits(host, R, 0, np.float64)
        return p, torch.as_tensor(th).to(dev, dt)
    sp = mmesh.shard_problem(host.problem, host.R,
                             mmesh.make_mesh(device=dev), dtype=np.float64,
                             eumaps_per_sample=host.E,
                             denom_per_sample=host.denom)
    return sp, sp.theta0


def kernel_calls(mods, kmod, p, th):
    """{kernel: call()} of one side, and the outputs of one call each."""
    msolver, _ = mods
    t0 = time.perf_counter()
    plan = msolver.cycle_plan(p, th.shape[0], clusters=True)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    pair = kmod.em_pair(th, plan, p.reads, p.inv_denom)
    _, t1, t2, r_sq, v_sq = pair
    ex = (th, t1, t2, torch.sum(r_sq, dim=1, keepdim=True),
          torch.sum(v_sq, dim=1, keepdim=True), plan, p.reads, p.eumaps,
          p.inv_denom)
    fns = {"cluster_em_pair": lambda: kmod.em_pair(th, plan, p.reads,
                                                   p.inv_denom),
           "cluster_extrap_gain": lambda: kmod.extrap_gain(*ex)}
    outs = {"cluster_em_pair": pair,
            "cluster_extrap_gain": kmod.extrap_gain(*ex)}
    torch.cuda.synchronize()
    return fns, outs, {"plan_host_ms": plan_ms, "tiles": plan.n_tiles,
                       "cluster": plan.cluster, "smem_bytes": plan.smem}


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    cache = os.path.join("bench_cache", "torch_smoke")
    ap.add_argument("--rsh", default=os.path.join(cache, "smoke.rsh"))
    ap.add_argument("--aln", default=os.path.join(cache, "smoke.bowtieout"))
    ap.add_argument("--out", default=os.path.join("bench_cache",
                                                  "cluster_ab.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cluster_ab: needs a CUDA device")
    dev = torch.device("cuda")
    x = smoke_sample(args.rsh, args.aln)
    b = batched_sample(args.rsh, args.aln)[3]
    parent = load_parent(args.parent, "model.solver", "parallel.mesh",
                         "kernels.csr_cluster")
    sides = {"parent": (parent[:2], parent[2]),
             "change": ((solver, mesh), csr_cluster)}
    result = {"card": card(), "order": ORDER, "cases": {}}
    for name, case in problems(x, b).items():
        calls, plans = {}, {}
        outs = {}
        for who, (mods, kmod) in sides.items():
            p, th = side_inputs(mods, case, dev)
            if who == "change":
                solver.clear_plans()
            calls[who], outs[who], plans[who] = kernel_calls(mods, kmod, p,
                                                             th)
        t0 = time.perf_counter()
        solver.cycle_plan(p, th.shape[0], clusters=True)
        plans["change"]["cached_plan_host_ms"] = (
            time.perf_counter() - t0) * 1e3
        for k in outs["change"]:
            for a, c in zip(outs["parent"][k], outs["change"][k]):
                if not np.array_equal(_bits(a), _bits(c)):
                    raise AssertionError(f"{name} {k}: parent and change "
                                         f"differ")
        runs = {who: {k: [] for k in calls[who]} for who in calls}
        for who in ORDER:
            for k, fn in calls[who].items():
                host = measure.host_ms(fn, 20)
                runs[who][k].append({"ms": measure.device_ms(
                    fn, host_per_call_ms=host), "host_ms": host})
        med = {who: {k: {m: statistics.median(r[m] for r in v)
                         for m in ("ms", "host_ms")}
                     for k, v in r_who.items()}
               for who, r_who in runs.items()}
        result["cases"][name] = {"median": med, "runs": runs,
                                 "plans": plans}
        print(f"[cluster_ab] {name}: " + "; ".join(
            f"{k} parent {med['parent'][k]['ms']:.5f} ms, change "
            f"{med['change'][k]['ms']:.5f} ms" for k in med["change"])
            + f"; plans {plans}", flush=True)
    write_result(result, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
