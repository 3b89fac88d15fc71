"""Worlds of processes for the port's multi-process CPU tests
(``tests/test_torch_mesh.py``, ``tests/test_torch_dist.py``): ``run_world``
runs a function in every rank of a gloo world, and the functions below
are what the ranks run.  Imports nothing of JAX: the ranks start from a
fresh interpreter (``spawn``) that imports only this module and the
port."""

from __future__ import annotations

import os
import socket
import time

import numpy as np
import torch

from emsar_tpu_torch.parallel import dist


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _enter(fn, rank: int, world: int, port: int, args) -> None:
    torch.set_num_threads(1)
    dist.init_distributed("127.0.0.1", port, world, rank)
    try:
        fn(rank, *args)
    finally:
        dist.shutdown()


def run_world(fn, world: int, *args, timeout: float = 120.0) -> None:
    """``fn(rank, *args)`` in each rank of a world of ``world`` processes
    joined in a gloo group; a world of one runs in this process, with no
    group.  Raises when a rank fails or outlives ``timeout`` seconds."""
    if world == 1:
        fn(0, *args)
        return
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_enter, args=(fn, r, world, port, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    if alive or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"world of {world}: exit codes "
                             f"{[p.exitcode for p in procs]} "
                             f"({len(alive)} killed at the timeout)")


def mesh_solves(rank: int, dp: int, cases: dict, out_dir: str,
                block_iters: int = 32) -> None:
    """Each case (problem, reads [S, C], layout) solved twice on the
    world's (dp, tp) mesh at epsilon 1e-12 with ``block_iters`` cycles a
    block, after one SQUAREM cycle from the warm start; every rank saves
    (theta, logL, blocks) of both runs and the cycle's theta to
    ``out_dir/rank{rank}.npz``."""
    from emsar_tpu_torch.parallel import mesh as tmesh
    mesh = tmesh.make_mesh(dp, device=torch.device("cpu"))
    res = {}
    for name, (problem, reads, layout) in cases.items():
        sp = tmesh.shard_problem(problem, reads, mesh, dtype=np.float64,
                                 shard_by=layout)
        res[f"{name}/cycle"] = tmesh.gather_theta(
            sp, tmesh._squarem_cycle(sp, sp.theta0))
        for run in ("first", "again"):
            theta, ll, it = tmesh.solve_sharded(sp, epsilon=1e-12,
                                                block_iters=block_iters)
            res[f"{name}/{run}/theta"] = theta
            res[f"{name}/{run}/ll"] = np.float64(ll)
            res[f"{name}/{run}/it"] = np.int64(it)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


def card_checks(rank: int, out_dir: str) -> None:
    """``make_mesh``'s one-card-a-rank test in a world of two: both ranks
    on card 0 (refused), then each on a card of its own; every rank saves
    what it saw to ``out_dir/rank{rank}.npz``."""
    from emsar_tpu_torch.parallel import mesh as tmesh
    try:
        tmesh._one_card_a_rank(torch.device("cuda", 0), 2)
        shared = "accepted"
    except RuntimeError as e:
        shared = str(e)
    tmesh._one_card_a_rank(torch.device("cuda", rank), 2)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), shared=shared)


def allreduce_counts(rank: int, out_dir: str) -> None:
    """Rank r's SampleCounts hold (r + 1) * 2^53 + r in every entry; the
    merged counts, exact int64 sums, go to ``out_dir/rank{rank}.npz``
    with each rank's share of a list of 5 items."""
    from emsar_tpu_torch.ingest.collapse import SampleCounts
    v = (rank + 1) * 2**53 + rank
    c = dist.allreduce_counts(SampleCounts(
        single_counts=np.full(7, v, dtype=np.int64),
        multi_counts=np.full(3, v, dtype=np.int64),
        fraglength_counts=np.full(5, v, dtype=np.int64),
        total_read_count=v))
    dist.barrier()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             single=c.single_counts, multi=c.multi_counts,
             fl=c.fraglength_counts, total=np.int64(c.total_read_count),
             share=np.array(dist.shard_list(list("abcde"))),
             world=np.int64(dist.process_count()))
