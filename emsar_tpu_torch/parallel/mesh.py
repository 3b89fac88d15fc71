"""Sharded multisample EM over a (dp, tp) arrangement of processes.

The port of ``emsar_tpu/parallel/mesh.py``.  The world of
``torch.distributed`` processes (``parallel/dist.py``; one process when
it was never initialized) is arranged as ``dp`` (samples, data parallel)
x ``tp`` (likelihood edges, model parallel), rank = d * tp + t, as
``jax.sharding.Mesh`` reshapes its devices.  Each rank holds only its own
shard:

* its dp slice of the samples (reads, EUMAps, 1 / denom and theta rows;
  the sample axis padded to a multiple of dp with empty samples);
* its tp slice of the edges, grouped by cid and by tid
  (``kernels.segment_sum.EdgeGroups``) so that its local segment sums run
  the port's kernel.  Layout ``'edges'``: a balanced split of the edge
  list padded with mult-0 edges, theta [S_local, T] replicated within tp.
  Layout ``'transcript'``: the edges of its block of transcripts, with
  block-local tids, theta and 1 / denom [S_local, Tp / tp].

``psum`` over an axis becomes ``all_reduce(SUM)`` on that axis's process
group: gloo for CPU tensors, NCCL for CUDA tensors (one card a rank,
``cuda:LOCAL_RANK``).  With tp == 1 a SQUAREM cycle is the CSR solver's
(``model/solver.py::_squarem_block``: on thread-block clusters below its
size crossover, else the fused ``em_step`` and the ``kernels.csr_cycle``
kernels) with per-sample reads, EUMAps and 1 / denom, and a block's
intensities and gain those of its ``csr_cycle.block_end``; with tp > 1
the partial segment sums (``sum_groups``) are all-reduced before the
ratio ('edges': both sums, 'transcript': the by-cid sum only), and the
cycle's vector work runs as torch ops between the all-reduces.  An
all-reduce of float partials sums in another order than one process, so
results over tp > 1 agree with the single-process solve to solver
tolerance, not bit for bit; a run at the same world size repeats its
bits.

The solve keeps the JAX semantics: the read-attribution warm start per
sample, one block before the loop, one stop test for the whole problem
(the block gain summed over every sample, all-reduced over dp, against
``epsilon`` and ``max_blocks``), the SQUAREM step-length norms all-reduced
over tp in the transcript layout, a logL summed over every sample, and
theta [S, T] gathered to every rank.  The loop is ``model/loop.py``'s
``while_loop`` (JAX's ``lax.while_loop``): a CUDA graph read once per
``loop.CHECK_EVERY`` blocks in a world of one; a mesh of several
processes reads the all-reduced gain after every block.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..kernels.csr_cluster import TilePlan
from ..kernels.segment_sum import EdgeGroups, sum_groups
from ..model import loop, solver
from ..model.solver import (SolverProblem, gain_of, group_edges,
                            inverse_denom, loglik_of,
                            read_attribution_starts, torch_dtype)
from . import dist as dist_mod


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (dp, tp) arrangement of the world and the
    process groups of its two axes (None for an axis of size 1)."""

    dp: int
    tp: int
    dp_index: int
    tp_index: int
    dp_group: Optional[dist.ProcessGroup]
    tp_group: Optional[dist.ProcessGroup]
    device: torch.device


def make_mesh(dp: int = 1, device: Optional[torch.device] = None) -> Mesh:
    """The world as (dp, tp = world / dp), on ``device`` (default this
    process's device: ``cuda:LOCAL_RANK`` unless ``EMSAR_TORCH_DEVICE``
    says cpu).  Every rank must call it with the same ``dp``: it creates
    the axes' process groups (NCCL for a CUDA device, else gloo).  A CUDA
    mesh of several processes needs a card for each: two ranks on one
    card raise."""
    if device is None:
        device = dist_mod.rank_device(resolve_device())
    world = dist_mod.process_count()
    rank = dist_mod.process_index()
    if dp < 1 or world % dp != 0:
        raise ValueError(f"world of {world} not divisible by dp {dp}")
    tp = world // dp
    if device.type == "cuda" and world > 1:
        _one_card_a_rank(device, world)
    backend = "nccl" if device.type == "cuda" else "gloo"
    groups = {"dp": None, "tp": None}
    # every rank creates every group, in the same order
    for axis, n_groups, members in (
            ("tp", dp, lambda i: [i * tp + t for t in range(tp)]),
            ("dp", tp, lambda i: [d * tp + i for d in range(dp)])):
        if len(members(0)) == 1:
            continue
        for i in range(n_groups):
            g = dist.new_group(members(i), backend=backend)
            if rank in members(i):
                groups[axis] = g
    return Mesh(dp=dp, tp=tp, dp_index=rank // tp, tp_index=rank % tp,
                dp_group=groups["dp"], tp_group=groups["tp"], device=device)


def _one_card_a_rank(device: torch.device, world: int) -> None:
    """Raise unless every rank's ``device`` is a card of its own (NCCL
    refuses a group with two ranks on one card)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    cards = [None] * world
    dist.all_gather_object(cards, (socket.gethostname(), index))
    if len(set(cards)) < world:
        raise RuntimeError(
            f"a CUDA mesh needs one card a process, but the {world} ranks "
            f"are on (host, card) {cards}: set LOCAL_RANK to a card of "
            f"its own for each process")


def _psum(t: torch.Tensor, group: Optional[dist.ProcessGroup]
          ) -> torch.Tensor:
    """``t`` summed in place over ``group`` (nothing for an axis of one)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def _gather(t: torch.Tensor, group: Optional[dist.ProcessGroup], n: int,
            dim: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group`` concatenated along ``dim``."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


@dataclasses.dataclass
class ShardedProblem:
    """One rank's shard of a multisample problem (see the module note).

    ``by_cid`` / ``by_tid``: the local edges grouped by cid (idx: global
    tid in the 'edges' layout, block-local in 'transcript') and by
    (block-local) tid (idx: cid).  Per-sample rows [S_local, ...] in the
    solve dtype on the mesh's device."""

    n_transcripts: int
    n_samples: int
    by_cid: EdgeGroups
    by_tid: EdgeGroups
    eumaps: torch.Tensor  # [S_local, C]
    reads: torch.Tensor  # [S_local, C]
    inv_denom: torch.Tensor  # [S_local, T] | [S_local, Tp / tp]
    theta0: torch.Tensor  # the read-attribution start, like inv_denom
    mesh: Mesh
    layout: str = "edges"
    skip_unread: bool = False  # the gain's form (solver.gain_of)


def shard_problem(problem: SolverProblem, reads_per_sample: np.ndarray,
                  mesh: Mesh, dtype=np.float32, shard_by: str = "edges",
                  eumaps_per_sample: Optional[np.ndarray] = None,
                  denom_per_sample: Optional[np.ndarray] = None,
                  skip_unread: bool = False) -> ShardedProblem:
    """This rank's shard of ``problem`` with ``reads_per_sample`` [S, C]
    (one row per sample) on ``mesh.device`` in ``dtype``.

    ``eumaps_per_sample`` / ``denom_per_sample``: per-sample EUMAps [S, C]
    and denominators [S, T] (multisample batches weight EUMA by each
    sample's fragment-length distribution); default the shared values of
    ``problem``.  ``shard_by``: 'edges' or 'transcript' (module note).
    ``skip_unread``: the gain's form (``model/solver.py::gain_of``)."""
    if shard_by not in ("edges", "transcript"):
        raise ValueError(f"unknown shard_by {shard_by!r}")
    dp, tp = mesh.dp, mesh.tp
    S = reads_per_sample.shape[0]
    Sp = -(-S // dp) * dp
    Sl = Sp // dp
    T = problem.n_transcripts
    C = len(problem.eumaps)
    if eumaps_per_sample is None:
        eumaps_per_sample = np.broadcast_to(problem.eumaps, (S, C))
    if denom_per_sample is None:
        denom_per_sample = np.broadcast_to(problem.denom, (S, T))
    th0 = read_attribution_starts(
        problem, np.asarray(reads_per_sample, dtype=np.float64),
        denom_per_sample)
    tdt = torch_dtype(dtype)
    dev = mesh.device
    rows = slice(mesh.dp_index * Sl, (mesh.dp_index + 1) * Sl)
    transcript = shard_by == "transcript"
    blk = -(-T // tp) if transcript else T
    ncol = blk * tp if transcript else T
    cols = (slice(mesh.tp_index * blk, (mesh.tp_index + 1) * blk)
            if transcript else slice(None))

    def local(a, width, cut=slice(None)):
        """This rank's rows (and columns) of [S, width] ``a``, padded to
        [Sp, ncol or width] with zeros, on the device in the solve dtype."""
        out = np.zeros((Sp, width), dtype=dtype)
        out[:S, :a.shape[1]] = a
        return torch.as_tensor(out[rows, cut]).to(dev).contiguous()

    cid = problem.edge_cid.astype(np.int64)
    tid = problem.edge_tid.astype(np.int64)
    mult = problem.edge_mult.astype(dtype)
    if transcript:
        mine = tid // blk == mesh.tp_index
        cid, tid, mult = (cid[mine], tid[mine] - mesh.tp_index * blk,
                          mult[mine])
    else:
        E = len(cid)
        Ep = -(-E // tp) * tp
        part = slice(mesh.tp_index * (Ep // tp),
                     (mesh.tp_index + 1) * (Ep // tp))
        # padding edges (cid 0, tid 0, mult 0) add exact zeros
        cid, tid, mult = (np.concatenate([a, np.zeros(Ep - E, a.dtype)])[part]
                          for a in (cid, tid, mult))
    return ShardedProblem(
        n_transcripts=T, n_samples=S,
        by_cid=group_edges(cid, tid, mult, C, blk, dev, tdt),
        by_tid=group_edges(tid, cid, mult, blk, C, dev, tdt),
        eumaps=local(eumaps_per_sample, C), reads=local(reads_per_sample, C),
        inv_denom=inverse_denom(local(denom_per_sample, ncol, cols)),
        theta0=local(th0, ncol, cols), mesh=mesh, layout=shard_by,
        skip_unread=skip_unread)


def _intensities(sp: ShardedProblem, th: torch.Tensor) -> torch.Tensor:
    """s [S_local, C] = segment sums of mult * theta over every edge."""
    return _psum(sum_groups(th, sp.by_cid), sp.mesh.tp_group)


def _em_iter(sp: ShardedProblem, th: torch.Tensor) -> torch.Tensor:
    """One EM step of every local sample, its partial sums all-reduced over
    tp (> 1; at tp == 1 the cycle is the CSR solver's)."""
    s = _intensities(sp, th)
    pos = s > 0
    ratio = torch.where(pos, sp.reads / torch.where(pos, s, 1.0), 0.0)
    num = sum_groups(ratio, sp.by_tid)
    if sp.layout == "edges":
        num = _psum(num, sp.mesh.tp_group)
    return th * num * sp.inv_denom


def _row_norm(sp: ShardedProblem, v: torch.Tensor) -> torch.Tensor:
    """[S_local, 1] Euclidean norm of each row over the whole T axis."""
    sq = torch.sum(v * v, dim=1, keepdim=True)
    if sp.layout == "transcript":
        sq = _psum(sq, sp.mesh.tp_group)
    return torch.sqrt(sq)


def _squarem_cycle(sp: ShardedProblem, th: torch.Tensor) -> torch.Tensor:
    """One stabilized SQUAREM cycle per local sample: at tp == 1
    ``model/solver.py::_squarem_cycle`` itself, else its torch body with
    the all-reduces between the pieces."""
    if sp.mesh.tp == 1:
        return solver._squarem_cycle(sp, th)
    return _cycle_tp(sp, th)


def _cycle_tp(sp: ShardedProblem, th: torch.Tensor) -> torch.Tensor:
    """One cycle of ``_squarem_cycle`` at tp > 1."""
    t1 = _em_iter(sp, th)
    t2 = _em_iter(sp, t1)
    r = t1 - th
    v = t2 - t1 - r
    rn, vn = _row_norm(sp, r), _row_norm(sp, v)
    alpha = torch.where(vn > 0, -rn / torch.where(vn > 0, vn, 1.0), -1.0)
    alpha = torch.clamp(alpha, max=-1.0)
    extrap = th - 2.0 * alpha * r + (alpha * alpha) * v
    cand = _em_iter(sp, torch.where(extrap > 0, extrap, t2))
    better = gain_of(sp.reads, sp.eumaps, _intensities(sp, t2),
                     _intensities(sp, cand), sp.skip_unread) >= 0
    return torch.where(better[:, None], cand, t2)


def _cycles(sp: ShardedProblem, th: torch.Tensor, block_iters: int,
            plan: Optional[TilePlan] = None,
            s_prev: Optional[torch.Tensor] = None):
    """``block_iters`` cycles: (theta, its intensities, their gain per
    sample over ``s_prev``, None without it).  At tp == 1 ``model/
    solver.py::_squarem_block`` (on clusters by ``plan`` when one is
    given), whose ``block_end`` picks the intensities from the last
    cycle's; at tp > 1 the intensities all-reduced after the cycles."""
    if sp.mesh.tp == 1:
        th, s, terms = solver._squarem_block(sp, th, block_iters, plan,
                                             s_prev)
        return th, s, None if terms is None else torch.sum(terms, dim=-1)
    for _ in range(block_iters):
        th = _cycle_tp(sp, th)
    s = _intensities(sp, th)
    return th, s, (None if s_prev is None
                   else gain_of(sp.reads, sp.eumaps, s_prev, s,
                                sp.skip_unread))


def _block(sp: ShardedProblem, th: torch.Tensor, block_iters: int,
           plan: Optional[TilePlan] = None):
    """``block_iters`` cycles: (theta, intensities, logL per sample)."""
    th, s, _ = _cycles(sp, th, block_iters, plan)
    return th, s, loglik_of(sp.reads, sp.eumaps, s)


def _block_after(sp: ShardedProblem, th: torch.Tensor, s_prev: torch.Tensor,
                 block_iters: int, plan: Optional[TilePlan] = None):
    """``block_iters`` cycles after a block that ended at intensities
    ``s_prev``: (theta, intensities, logL per sample, gain per sample over
    s_prev)."""
    th, s, gain = _cycles(sp, th, block_iters, plan, s_prev)
    return th, s, loglik_of(sp.reads, sp.eumaps, s), gain


def solve_sharded(sp: ShardedProblem, epsilon: float = 1e-6,
                  max_blocks: int = 4096, block_iters: int = 32, *,
                  plain: bool = False, clusters: Optional[bool] = None
                  ) -> Tuple[np.ndarray, float, int]:
    """The sharded EM solve: one block from the warm start, then blocks
    while the gain of the last one, summed over every sample, is at least
    ``epsilon`` and fewer than ``max_blocks`` ran.  Returns (theta [S, T]
    float array on every rank, logL summed over the samples, n_blocks).

    The loop blocks run in ``model/loop.py``'s ``while_loop`` with one
    stop flag for the batch (a CUDA graph on the card) when the mesh has
    no process groups; a mesh of several processes reads the all-reduced
    gain after every block (``plain``), as every rank must take the same
    collectives.  ``clusters`` forces the path of the cycles at tp == 1
    (``model/solver.py::_squarem_cycles``)."""
    m = sp.mesh
    plan = (solver.cycle_plan(sp, sp.theta0.shape[0], clusters)
            if m.tp == 1 else None)
    th, s, ll = _block(sp, sp.theta0, block_iters, plan)
    th = th.clone()  # the state is updated in place; theta0 stays
    dev = th.device
    # JAX's first cond, the initial gain being +inf
    active = torch.tensor(max_blocks > 0, device=dev)
    last = torch.zeros_like(active, dtype=th.dtype)
    it = torch.zeros((), dtype=torch.int64, device=dev)

    def block():
        th_new, s_new, ll_new, gain = _block_after(sp, th, s, block_iters,
                                                   plan)
        g = _psum(gain.sum().reshape(1), m.dp_group)
        loop.advance(active, it, ((th, th_new), (s, s_new), (ll, ll_new)))
        loop.keep_gain(last, g[0], active)
        active.logical_and_((g[0] >= epsilon) & (it < max_blocks))

    collective = m.dp_group is not None or m.tp_group is not None
    loop.while_loop(block, active, plain=plain or collective)
    ll_tot = float(_psum(ll.sum().reshape(1), m.dp_group))
    return gather_theta(sp, th), ll_tot, loop.finish(
        it, last, lambda n: n >= max_blocks)


def gather_theta(sp: ShardedProblem, th: torch.Tensor) -> np.ndarray:
    """Every rank's theta rows and columns as one [S, T] array, on every
    rank."""
    m = sp.mesh
    if sp.layout == "transcript":
        th = _gather(th, m.tp_group, m.tp, 1)
    th = _gather(th, m.dp_group, m.dp, 0)
    return th[:sp.n_samples, :sp.n_transcripts].cpu().numpy()
