"""The CSR cycle's gain pass, its block end and the launch path's cycle
(``kernels/csr_cycle.py``) on the card, this checkout's against
another's:

    python3 -m emsar_tpu_torch.bench.cycle_ab [--parent PARENT_DIR]
        [--large] [--rsh R] [--aln A] [--out bench_cache/cycle_ab.json]

PARENT_DIR is the root of another checkout of this repository (for
example ``git archive`` of the parent commit unpacked into a directory
that ``.gitignore`` lists); its ``emsar_tpu_torch`` is loaded under the
name ``parent_port``.  Without it only this checkout is timed.  The
problems: the smoke fixture's (``chip_smoke.py`` makes it under
``bench_cache/torch_smoke/``) CSR problem at R 1 (the read-attribution
start) and its restart problem at R 3 (``restart_inits``' draws), both in
float64 and float32, and the ``bench.MS_SAMPLES``-sample batched problem
at R 16 (float64, a row of reads, EUMAps and 1 / denom each); the
sweep's modules with one module above the 8-block cluster's limit
(``oversized_problem``, R 1 float64: no tile plan fits, so a solve takes
the launches unforced); with ``--large`` the cluster sweep's 11.52 M-edge
problem (R 1, float64).

At each, in turns (parent, change, change, parent), device ms and host ms
a call of:

* the block end, ``block_end`` (the accept and its intensities picked
  from those the last ``pair_gain`` wrote);
* ``pair_gain``, and writing both intensities (a block's last cycle);
* ``cycle_extrap`` and ``cycle_select``, each side's, and beside
  ``cycle_select`` the one PyTorch call that computes it,
  ``torch.where((gain >= 0)[:, None], cand, t2)`` (``torch.where``);
  all from a cold L2 (``kernels.measure.device_ms_cold``: their inputs
  fit in the H100's 50 MB L2 at most of these shapes);
* eight cycles off clusters (twelve launches a cycle, ended by the
  block's end) replayed from a CUDA graph (``bench.cluster_sweep.
  graph_ms``);
* on the oversized problem, the whole solve (``solver.em_solve`` by its
  own dispatch, a CUDA graph loop), ``SOLVES`` times a turn, each split
  into its eager first block, the graph's capture and the replays
  (``solve_ms``): ms per replayed block.

Both sides' outputs must be bit-equal: theta, intensities and gain terms
of the block end, the gain terms, the extrapolation, the accept (and
``torch.where``'s), eight cycles' theta, the solve's theta and blocks.
The script raises otherwise.  Prints one JSON object (with the card's
name and power limit) and writes it to ``--out``.
``kernel_bounds`` is the roofline bound of each kernel here, which
``chip_smoke.py`` reports too.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time
from typing import Optional

import numpy as np
import torch

from . import ORDER, batched_sample, load_parent, smoke_sample, write_result
from .cluster_sweep import (SIZES, card, graph_ms, largest_module,
                            random_problem)
from ..config import QuantConfig
from ..kernels import csr_cycle, measure
from ..kernels import segment_sum as ss
from ..model import quantify, solver
from ..parallel import mesh

OVERSIZED_SEED = 91


def oversized_problem(n_edges: int = 90_000, seed: int = OVERSIZED_SEED
                      ) -> solver.SolverProblem:
    """The sweep's modules of ``n_edges`` edges (``cluster_sweep.
    random_problem``) and one more module made as ``largest_module``
    makes its modules, with twice the transcripts of the largest that an
    8-block cluster stages in float64: ``solver.cycle_plan`` finds no tile
    plan, so the whole problem takes the launch path.  Every segment holds
    at least one read, as a segment of an alignment does: a read-less
    segment whose intensity collapses makes a NaN gain (0 * log1p(-1)),
    which would stop the solve after a few blocks instead of at its
    convergence (74 blocks of 8 cycles at 1e-9 from this seed on the
    H100)."""
    rng = np.random.default_rng(seed)
    base = random_problem(rng, n_edges)
    nt = 2 * largest_module(torch.float64, 8)["transcripts"]
    nc = int(round(2.3 * nt))
    deg = np.minimum(1 + rng.poisson(3.0, nc), nt)
    seg = np.repeat(np.arange(nc), deg)
    key = np.unique(seg * nt + (rng.random(len(seg)) * nt).astype(np.int64))
    C0, T0 = len(base.eumaps), base.n_transcripts
    cid = np.concatenate([base.edge_cid, C0 + key // nt]).astype(np.int32)
    tid = np.concatenate([base.edge_tid, T0 + key % nt]).astype(np.int32)
    mult = np.concatenate([base.edge_mult,
                           rng.integers(1, 3, len(key)).astype(np.float64)])
    eumaps = np.concatenate([base.eumaps, rng.uniform(0.1, 2, nc)])
    reads = np.maximum(np.concatenate([base.reads, rng.poisson(3, nc) * (
        rng.random(nc) < 0.9) * 1.0]), 1.0)
    denom = np.zeros(T0 + nt)
    np.add.at(denom, tid, mult * eumaps[cid])
    return solver.SolverProblem(n_transcripts=T0 + nt, edge_cid=cid,
                                edge_tid=tid, edge_mult=mult, eumaps=eumaps,
                                reads=reads, denom=denom)


def kernel_bounds(p, R: int) -> dict:
    """{kernel: (bound ms, "bytes" or "operations", bytes)} of the
    csr_cycle kernels and of em_step at R rows of ``p`` (a DeviceProblem
    or ShardedProblem): each input read once, each output
    written once, the operations counted as the kernels do them.  Where
    the work depends on the data, what it needs: block_end and
    cycle_select read one of cand and t2 (and of their intensities) a
    row.  ``pair_gain intensities`` also writes both intensities."""
    dt = p.reads.dtype
    item = p.reads.element_size()
    C, T = p.by_cid.n_groups, p.by_tid.n_groups
    E = p.by_cid.idx.shape[0]
    cid = measure.nbytes(p.by_cid.mult, p.by_cid.idx, p.by_cid.offsets)
    tid = measure.nbytes(p.by_tid.mult, p.by_tid.idx, p.by_tid.offsets)
    rd_eu = measure.nbytes(p.reads, p.eumaps)
    rd_inv = measure.nbytes(p.reads, p.inv_denom)
    em_ops = 4 * E + C + 2 * T
    work = {
        "pair_gain": (cid + measure.nbytes(p.by_cid.tiles) + rd_eu
                      + item * R * (2 * T + C), R * (4 * E + 14 * C)),
        "pair_gain intensities": (
            cid + measure.nbytes(p.by_cid.tiles) + rd_eu
            + item * R * (2 * T + 3 * C), R * (4 * E + 14 * C)),
        "block_end": (rd_eu + item * (R + 2 * R * T + 4 * R * C),
                      R * 14 * C),
        "cycle_extrap": (item * (2 * R + 4 * R * T), R * 10 * T),
        "cycle_select": (item * (R + 2 * R * T), 0),
        "em_step": (cid + tid + rd_inv + item * R * 2 * T, R * em_ops),
    }
    return {k: (*measure.bound_ms(b, ops, dt), b)
            for k, (b, ops) in work.items()}


def cases(rsh: str, aln: str, large: bool) -> dict:
    """{case: (host problem or batched inputs, R, dtype)}."""
    x = smoke_sample(rsh, aln)
    b = batched_sample(rsh, aln)[3]
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
    out["oversized module R=1 float64"] = (oversized_problem(), 1,
                                           torch.float64)
    if large:  # the sweep's largest R 1 problem, from its seed
        rng = np.random.default_rng(SIZES[-1] + 1)
        out[f"sweep E={SIZES[-1]} R=1 float64"] = (
            random_problem(rng, SIZES[-1]), 1, torch.float64)
    return out


def side_inputs(msolver, mmesh, case, dev):
    """One side's (problem on the card, theta [R, T]) of a case."""
    host, R, dt = case
    if isinstance(host, solver.SolverProblem):
        p = msolver.problem_to_device(host, dev, dt)
        th = (solver.read_attribution_start(host)[None] if R == 1 else
              solver.restart_inits(host, R, 0, np.float64))
        return p, torch.as_tensor(th).to(dev, dt)
    sp = mmesh.shard_problem(host.problem, host.R,
                             mmesh.make_mesh(device=dev), dtype=np.float64,
                             eumaps_per_sample=host.E,
                             denom_per_sample=host.denom)
    return sp, sp.theta0


def cycle_inputs(p, th) -> dict:
    """The inputs of a block's end after one cycle from ``th`` off
    clusters, made by this checkout: gain, cand, t2 and their
    intensities, and s_prev (th's intensities); one row's gain set to
    NaN and, at R > 2, one to -1, so that rows take t2.  Also the
    extrapolation's inputs: theta, t1 and the row sums of r * r and
    v * v."""
    th = th.contiguous()
    gain, cand, t2, s_t2, s_cand = solver._squarem_cycle_launches(
        p, th, intensities=True)
    gain = gain.clone()
    gain[0] = np.nan
    if gain.shape[0] > 2:
        gain[2] = -1.0
    groups = (p.by_cid, p.by_tid, p.reads, p.inv_denom)
    t1 = ss.em_step(th, *groups)
    _, r_sq, v_sq = ss.em_step_cycle(t1, th, *groups)
    return {"gain": gain, "cand": cand, "t2": t2, "s_t2": s_t2,
            "s_cand": s_cand, "s_prev": ss.sum_groups(th, p.by_cid),
            "theta": th, "t1": t1,
            "rs": torch.sum(r_sq, dim=1, keepdim=True),
            "vs": torch.sum(v_sq, dim=1, keepdim=True)}


def cycle_calls(mcc, v: dict) -> dict:
    """{name: call()} of a side's ``cycle_extrap`` and ``cycle_select``
    (``mcc``, its ``kernels.csr_cycle``) on the inputs ``v``."""
    return {"cycle_extrap": lambda: mcc.cycle_extrap(
                v["theta"], v["t1"], v["t2"], v["rs"], v["vs"]),
            "cycle_select": lambda: mcc.cycle_select(v["gain"], v["cand"],
                                                     v["t2"])}


def where_call(v: dict):
    """The one PyTorch call that computes ``cycle_select``."""
    return lambda: torch.where((v["gain"] >= 0)[:, None], v["cand"],
                               v["t2"])


def side_calls(msolver, mcc, p, th, v: dict, parent: bool) -> dict:
    """{measurement: call()} of one side (``parent``: the parent's
    kernels, else this checkout's, with ``torch.where`` beside them)."""
    g = p.by_cid
    rd, eu = p.reads, p.eumaps

    def cycles():
        return msolver._squarem_cycles(p, th, 8, None)
    library = {} if parent else {"torch.where": where_call(v)}
    return {"block_end": lambda: mcc.block_end(
                v["gain"], v["cand"], v["t2"], v["s_t2"], v["s_cand"],
                v["s_prev"], rd, eu),
            "pair_gain": lambda: mcc.pair_gain(g, rd, eu, v["t2"],
                                               v["cand"]),
            "pair_gain_intensities": lambda: mcc.pair_gain(
                g, rd, eu, v["t2"], v["cand"], intensities=True),
            **cycle_calls(mcc, v), **library, "eight_cycles": cycles}


def _bits(t) -> np.ndarray:
    a = np.ascontiguousarray(t.detach().cpu().numpy())
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


def _equal(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(
        np.array_equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _time(name: str, fn) -> dict:
    """Device ms (a CUDA graph's replays for the eight cycles, else
    ``measure.device_ms_cold``: each call from a cold L2) and host ms a
    call."""
    if name.startswith("eight_cycles"):
        return {"ms": graph_ms(fn), "host_ms": measure.host_ms(fn, 5)}
    host = measure.host_ms(fn, 50)
    return {"ms": measure.device_ms_cold(fn, host_per_call_ms=host),
            "host_ms": host}


SOLVES = 3


def solve_ms(msolver, p, th) -> dict:
    """``SOLVES`` whole solves by the side's own dispatch, after a warm
    one.  Each solve's wall ms split in three: its first block (the
    loop's eager warm-up, timed around the side's ``loop._CudaGraph.
    warm_up`` to a synchronize), the graph's capture (``loop.LAST.
    capture_s``) and the replays (the rest: ms per replayed block, the
    no-op blocks after the stop counted).  Returns (theta, logL) and the
    blocks of the last solve, each part's median and every solve's."""
    graph_cls = msolver.loop._CudaGraph
    warm_up = graph_cls.warm_up
    firsts = []

    def timed_warm_up(self, block):
        t0 = time.perf_counter()
        warm_up(self, block)
        torch.cuda.synchronize()
        firsts.append(time.perf_counter() - t0)

    def run():
        out = msolver.em_solve(p, th, 1e-9, 8, 200000)
        torch.cuda.synchronize()
        return out
    run()
    splits = []
    graph_cls.warm_up = timed_warm_up
    try:
        for _ in range(SOLVES):
            t0 = time.perf_counter()
            theta, ll, it = run()
            wall = time.perf_counter() - t0
            st = msolver.loop.LAST
            replay = wall - firsts[-1] - st.capture_s
            splits.append({
                "ms": wall * 1e3, "ms_per_block": wall * 1e3 / it,
                "first_block_ms": firsts[-1] * 1e3,
                "capture_ms": st.capture_s * 1e3,
                "replay_ms_per_block": replay * 1e3 / max(
                    st.blocks_run - 1, 1),
                "blocks_run": st.blocks_run})
    finally:
        graph_cls.warm_up = warm_up
    med = {k: statistics.median(x[k] for x in splits) for k in splits[0]}
    return {"out": (theta, ll), "blocks": it, "median": med,
            "runs": splits}


def run(dev: torch.device, all_cases: dict, parent: Optional[str] = None,
        log=print) -> dict:
    """Every case: each side's calls timed in turns (both sides' outputs
    bit-equal first), the kernels' bounds, and on the oversized problem
    both sides' whole solve.  Returns {case: what it measured}."""
    sides = {"change": (solver, mesh, csr_cycle, False)}
    if parent:
        psolver, pmesh, pcc = load_parent(parent, "model.solver",
                                          "parallel.mesh",
                                          "kernels.csr_cycle")
        sides["parent"] = (psolver, pmesh, pcc, True)
    order = ORDER if parent else ("change",)
    result = {}
    for name, case in all_cases.items():
        inputs = {who: side_inputs(s[0], s[1], case, dev)
                  for who, s in sides.items()}
        p, th = inputs["change"]
        v = cycle_inputs(p, th)
        calls = {who: side_calls(s[0], s[2], *inputs[who], v, s[3])
                 for who, s in sides.items()}
        outs = {who: {k: fn() for k, fn in c.items()}
                for who, c in calls.items()}
        torch.cuda.synchronize()
        if not _equal(outs["change"]["torch.where"],
                      outs["change"]["cycle_select"]):
            raise AssertionError(f"{name}: cycle_select differs from "
                                 f"torch.where")
        if parent:
            for k in outs["parent"]:
                if not _equal(outs["parent"][k], outs["change"][k]):
                    raise AssertionError(f"{name} {k}: parent and change "
                                         f"differ")
        runs = {who: {k: [] for k in calls[who]} for who in calls}
        for who in order:
            for k, fn in calls[who].items():
                runs[who][k].append(_time(k, fn))
        med = {who: {k: {m: statistics.median(r[m] for r in v_)
                         for m in ("ms", "host_ms")}
                     for k, v_ in r_who.items()}
               for who, r_who in runs.items()}
        R = th.shape[0]
        bounds = kernel_bounds(p, R)
        entry = {"rows": R, "edges": int(p.by_cid.idx.shape[0]),
                 "segments": p.by_cid.n_groups,
                 "transcripts": p.by_tid.n_groups, "median": med,
                 "runs": runs, "bounds": {k: bounds[k] for k in (
                     "pair_gain", "pair_gain intensities", "block_end",
                     "cycle_extrap", "cycle_select")}}
        if name.startswith("oversized"):
            if solver.cycle_plan(p, R) is not None:
                raise AssertionError("the oversized problem found a tile "
                                     "plan")
            solves = {}
            for who in (ORDER if parent else ("change", "change")):
                got = solve_ms(sides[who][0], *inputs[who])
                solves.setdefault(who, []).append(got)
            first = solves["change"][0]
            if any(x["blocks"] != first["blocks"]
                   or not _equal(x["out"], first["out"])
                   for ss_ in solves.values() for x in ss_):
                raise AssertionError(f"{name}: the solves differ")
            entry["solve"] = {
                who: {"blocks": ss_[0]["blocks"],
                      "median": {k: statistics.median(
                          x["median"][k] for x in ss_)
                          for k in ss_[0]["median"]},
                      "turns": [x["median"] for x in ss_]}
                for who, ss_ in solves.items()}
        result[name] = entry
        log(f"[cycle_ab] {name} (E={entry['edges']}, R={R}): " + "; ".join(
            f"{k} " + ", ".join(f"{who} {med[who][k]['ms']:.5f} ms"
                                for who in med if k in med[who])
            for k in med["change"])
            + "; bounds " + ", ".join(f"{k} {b[0]:.5f} ms"
                                      for k, b in entry["bounds"].items())
            + (f"; solve {entry['solve']}" if "solve" in entry else ""))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--large", action="store_true",
                    help=f"also the sweep's {SIZES[-1]}-edge problem")
    cache = os.path.join("bench_cache", "torch_smoke")
    ap.add_argument("--rsh", default=os.path.join(cache, "smoke.rsh"))
    ap.add_argument("--aln", default=os.path.join(cache, "smoke.bowtieout"))
    ap.add_argument("--out", default=os.path.join("bench_cache",
                                                  "cycle_ab.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cycle_ab: needs a CUDA device")
    dev = torch.device("cuda")
    result = {"card": card(), "order": ORDER if args.parent else ["change"],
              "cases": run(dev, cases(args.rsh, args.aln, args.large),
                           args.parent)}
    write_result(result, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
