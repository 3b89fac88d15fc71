"""The convergence loops of a parent checkout against this one's, on the
card, in one process, and this one's at several ``CHECK_EVERY`` values:

    python3 -m emsar_tpu_torch.bench.loop_ab PARENT_DIR [--rsh R] [--aln A]
        [--out bench_cache/loop_ab.json]

PARENT_DIR is the root of another checkout of this repository (for
example ``git archive`` of the parent commit unpacked into a directory
that ``.gitignore`` lists); its ``emsar_tpu_torch`` is loaded under the
name ``parent_port``.  The problems are the smoke fixture's
(``chip_smoke.py`` makes it under ``bench_cache/torch_smoke/``), float64:
the CSR solve of ``--solver_mode csr`` (R = 1, from the read-attribution
start) and, for each dense size class of the default partition, the
torch.bmm loop (``_solve_loop``), the kernel path (``_dense_solve_pallas``)
and the restart rounds (R = 3 from ``_make_rounds_dense``'s draws), each
with the default epsilons and 8 cycles a block.  Each side builds its own
device inputs from the same host arrays.

In turns (parent, change, change, parent): each solve's wall ms, synced,
after a warm solve (the change's includes its capture), and its blocks.
Both sides must give the same blocks and theta bits; the script raises
otherwise.  Then the change alone at each ``CHECK_EVERY`` of ``--every``:
the solves' ms and the blocks they ran.  Prints one JSON object and
writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import numpy as np
import torch

from . import ORDER, load_parent, smoke_sample, write_result
from ..config import QuantConfig
from ..model import dense, loop, quantify, solver


def cases(mods, x, dev):
    """{case: solve()} of one side (``mods``: its solver and dense
    modules), each returning (theta, blocks)."""
    msolver, mdense = mods
    cfg = QuantConfig(verbose=0)
    eps, bi = cfg.epsilon, cfg.solver_block_iters
    problem = solver.build_problem(x.graph, x.modules, x.eumaps,
                                   x.read_count)
    p = msolver.problem_to_device(problem, dev, torch.float64)
    th0 = torch.as_tensor(solver.read_attribution_start(problem))[None].to(
        dev)
    out = {"csr": lambda: msolver.em_solve(p, th0, eps, bi, 200000)[::2]}
    part = dense.partition_modules(x.graph, x.modules, x.eumaps,
                                   x.read_count, dtype=np.float64)
    rng = np.random.default_rng(np.uint64(0x5EED_0001))
    n_extra = cfg.num_round - 1
    for batch in part.batches:
        cls = "x".join(map(str, batch.shape[1:]))
        padded = mdense.batch_to_device(dense._pad_b(batch)[0], dev,
                                        torch.float64)
        db = mdense.batch_to_device(batch, dev, torch.float64)
        rows = np.flatnonzero((batch.tid_map >= 0).sum(axis=1) >= 2)
        sub, nB = dense._pad_b(dense.subset_batch(batch, rows))
        inits = rng.uniform(0.0, 100.0, size=(n_extra, nB, sub.shape[2]))
        inits = np.where(sub.tid_map[None, :nB] >= 0, inits, 0.0)
        inits = np.pad(inits, ((0, 0), (0, sub.shape[0] - nB), (0, 0)))
        dr = mdense.batch_to_device(sub, dev, torch.float64)
        tr = torch.as_tensor(inits).to(dev)
        out[f"bmm {cls}"] = lambda d=padded: mdense._solve_loop(
            d, mdense._theta0(d)[None], eps, bi, 2048)
        out[f"kernel {cls}"] = lambda d=db: mdense._dense_solve_pallas(
            d, eps, bi, 2048)
        out[f"restarts {cls}"] = lambda d=dr, t=tr: mdense._solve_loop(
            d, t, quantify._restart_eps(cfg), bi, 2048)
    return out


def timed(fn):
    """(wall ms of ``fn()`` after a warm call, synced; its result)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    cache = os.path.join("bench_cache", "torch_smoke")
    ap.add_argument("--rsh", default=os.path.join(cache, "smoke.rsh"))
    ap.add_argument("--aln", default=os.path.join(cache, "smoke.bowtieout"))
    ap.add_argument("--every", default="1,2,4,8,16,32")
    ap.add_argument("--out", default=os.path.join("bench_cache",
                                                  "loop_ab.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("loop_ab: needs a CUDA device")
    dev = torch.device("cuda")
    x = smoke_sample(args.rsh, args.aln)
    fns = {"parent": cases(load_parent(args.parent, "model.solver",
                                       "model.dense"), x, dev),
           "change": cases((solver, dense), x, dev)}
    res = {who: {name: [] for name in fns[who]} for who in fns}
    blocks, theta = {}, {}
    for who in ORDER:
        for name, fn in fns[who].items():
            ms, (th, it) = timed(fn)
            res[who][name].append(ms)
            blocks.setdefault(name, {})[who] = it
            theta.setdefault(name, {})[who] = th.cpu().numpy().view(np.uint64)
    for name in blocks:
        if blocks[name]["parent"] != blocks[name]["change"] or \
                not np.array_equal(theta[name]["parent"],
                                   theta[name]["change"]):
            raise AssertionError(f"{name}: parent and change differ")
    sweep = {}
    for k in (int(v) for v in args.every.split(",")):
        loop.CHECK_EVERY = k
        sweep[k] = {}
        for name, fn in fns["change"].items():
            ms, _ = timed(fn)
            sweep[k][name] = {"ms": ms, "blocks_run": loop.LAST.blocks_run,
                              "capture_ms": loop.LAST.capture_s * 1e3}
        sweep[k]["total_ms"] = sum(v["ms"] for v in sweep[k].values())
    median = {who: {name: statistics.median(v) for name, v in r.items()}
              for who, r in res.items()}
    for who in median:
        median[who]["total_ms"] = sum(median[who].values())
    write_result({"card": torch.cuda.get_device_name(0), "order": ORDER,
                  "blocks": {n: b["change"] for n, b in blocks.items()},
                  "median_ms": median, "runs_ms": res,
                  "check_every": sweep}, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
