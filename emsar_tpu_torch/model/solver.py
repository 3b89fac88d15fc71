"""CSR EM solver for the per-module Poisson likelihood, in PyTorch.

The port of ``emsar_tpu/model/solver.py``.  Per module the reference
maximizes F = sum_cid R_cid * log(lambda_cid) - lambda_cid with
lambda_cid = EUMAps_cid * sum_{tid in CT[cid]} FPKM_tid by multiplicative
EM fixed-point updates on the identical objective:

    s_c     = sum_t m_ct * theta_t          (segment intensity)
    theta_t <- theta_t * (sum_c m_ct R_c / s_c) / (sum_c m_ct E_c)

accelerated by stabilized SQUAREM cycles, over ALL modules jointly as one
global (cid, tid, multiplicity) edge list.  Every segment sum goes through
``kernels.segment_sum`` over the edges grouped by cid (CSR) and by tid
(CSC): an EM step is ``em_step`` (two launches on the card), an intensity
``sum_groups``.  The summation order is fixed, so a solve gives the same
bits on every run (``index_add_`` on CUDA sums with float atomics), and
the card gives the CPU's bits.  The rest of a SQUAREM cycle (step length,
extrapolation, the accept test's intensities and gain) is
``kernels.csr_cycle``: a cycle is twelve launches on the card, with the
torch body's bits.  Below a size crossover
(``CLUSTER_MAX_EDGES``) a cycle is five launches instead
(``kernels.csr_cluster``: each row's modules packed into tiles, a
thread-block cluster a tile, its passes split by hardware cluster
barriers), with the same bits; its tile plan is made once per
edge structure (``cycle_plan``'s cache: the restart loops of every sample
of a ``-M --batch_samples`` run share one).  A block ends with one
``csr_cycle.block_end`` on either path: the accept, and its intensities
picked from those the last cycle summed, with no pass over the edges.

The convergence loop is ``model/loop.py``'s ``while_loop`` (JAX's
``lax.while_loop``): blocks of ``block_iters`` cycles replayed from a CUDA
graph on the card, the stop flag read once per ``loop.CHECK_EVERY``
blocks.  Restart rounds, vmapped in the JAX package, ride a leading
``[R, ntid]`` axis with a per-round convergence mask, so every round stops
exactly where it would stop alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.csr_cluster import (Source, TilePlan, em_pair, extrap_gain,
                                   plan_for)
from ..kernels.csr_cycle import (block_end, cycle_extrap, cycle_select,
                                 gain_terms, pair_gain)
from ..kernels.segment_sum import (EdgeGroups, em_step, em_step_cycle,
                                   prepare, sum_groups)
from . import loop
from .modules import ModuleDecomposition, SegmentGraph

# The CSR cycle runs on thread-block clusters (``kernels.csr_cluster``: five
# launches a cycle) while a row's problem has at most this many edges and a
# tile plan fits, as twelve launches above.  The largest problem of
# ``bench/cluster_sweep.py``'s sweep (R 1, float64) at which the clusters
# were faster; no larger one was measured.
CLUSTER_MAX_EDGES = 11_520_000
# ``cycle_plan``'s cache of tile plans: at most PLAN_CACHE plans and
# PLAN_CACHE_BYTES of their tensors (``TilePlan.nbytes``: the tiled
# groupings, the blocks' images and the problem's groupings they were
# made for, ~80 B an edge in float64; on the card for a card plan), or
# the newest plan alone when it is larger (a problem of ~13 M edges);
# PLANS_MADE counts the plans made (``plan_for`` calls)
PLAN_CACHE = 4
PLAN_CACHE_BYTES = 1 << 30
PLANS_MADE = 0
_PLANS: list = []  # [(rows, by_cid, by_tid, plan, bytes)], newest last


@dataclasses.dataclass
class SolverProblem:
    """Flat edge-list formulation of the global likelihood.

    Edges connect active segments (EUMAps > 0, sid != -1) to transcripts
    with integer multiplicities.  ``eumaps``/``reads`` are per active
    segment; ``denom`` is sum_c m_ct E_c per transcript.
    """

    n_transcripts: int
    edge_cid: np.ndarray  # int32 [E] (active-segment local index)
    edge_tid: np.ndarray  # int32 [E]
    edge_mult: np.ndarray  # float [E]
    eumaps: np.ndarray  # float [C_active]
    reads: np.ndarray  # float [C_active]
    denom: np.ndarray  # float [ntid]


@dataclasses.dataclass
class DeviceProblem:
    """A SolverProblem's arrays on a torch device in the solve dtype, its
    edges grouped by cid (``by_cid``) and by tid (``by_tid``)."""

    n_segments: int
    by_cid: EdgeGroups
    by_tid: EdgeGroups
    eumaps: torch.Tensor  # [C]
    reads: torch.Tensor  # [C]
    inv_denom: torch.Tensor  # [ntid], 0 where denom == 0


def build_problem(graph: SegmentGraph, modules: ModuleDecomposition,
                  eumaps: np.ndarray, read_count: np.ndarray,
                  dtype=np.float64) -> SolverProblem:
    """Compress the CSR graph to the active edge list with multiplicities."""
    ntid = graph.n_transcripts
    active = (modules.cs >= 0) & (eumaps > 0)
    act_cids = np.flatnonzero(active)
    n_active = len(act_cids)
    # local renumbering of active cids
    local = np.full(graph.n_cid, -1, dtype=np.int64)
    local[act_cids] = np.arange(n_active)

    off = graph.ct_offsets
    sizes = np.diff(off)
    # expand active cids' tid lists
    rep = np.repeat(active, sizes)
    flat_cid = np.repeat(np.arange(graph.n_cid, dtype=np.int64), sizes)[rep]
    flat_tid = graph.ct_tids[rep].astype(np.int64)
    # merge duplicates into multiplicities
    key = flat_cid * ntid + flat_tid
    uniq, inv, mult = np.unique(key, return_inverse=True, return_counts=True)
    e_cid = local[(uniq // ntid)].astype(np.int32)
    e_tid = (uniq % ntid).astype(np.int32)
    e_mult = mult.astype(dtype)

    E = eumaps[act_cids].astype(dtype)
    R = read_count[act_cids].astype(dtype)
    denom = np.zeros(ntid, dtype=dtype)
    np.add.at(denom, e_tid, e_mult * E[e_cid])
    return SolverProblem(n_transcripts=ntid, edge_cid=e_cid, edge_tid=e_tid,
                         edge_mult=e_mult, eumaps=E, reads=R, denom=denom)


def group_edges(seg: np.ndarray, other: np.ndarray, mult: np.ndarray,
                n_seg: int, n_other: int, device: torch.device,
                dtype: torch.dtype) -> EdgeGroups:
    """Edges grouped by ``seg`` (a stable sort: each group keeps the edges'
    order), with their ``other`` endpoint in ``[0, n_other)`` and weight
    ``mult``, on ``device`` in ``dtype`` and checked for the kernel
    (``kernels.segment_sum.prepare``)."""
    seg = np.asarray(seg, dtype=np.int64)
    order = np.argsort(seg, kind="stable")
    offsets = np.zeros(n_seg + 1, dtype=np.int64)
    np.cumsum(np.bincount(seg, minlength=n_seg), out=offsets[1:])
    return prepare(
        torch.as_tensor(offsets).to(device),
        torch.as_tensor(np.asarray(other, dtype=np.int64)[order]).to(device),
        torch.as_tensor(np.asarray(mult)[order]).to(device=device,
                                                    dtype=dtype), n_other)


def problem_to_device(problem: SolverProblem, device: torch.device,
                      dtype: torch.dtype) -> DeviceProblem:
    """Move a SolverProblem to ``device`` in ``dtype``, with the edges
    grouped by cid and by tid (``kernels.segment_sum.EdgeGroups``, checked
    here once for every launch of the solve).  Both groupings are stable
    sorts of the edge list, so each segment keeps the edges' own order
    (``build_problem`` emits edges sorted by (cid, tid): the cid grouping
    is then the identity)."""
    cid, tid, mult = problem.edge_cid, problem.edge_tid, problem.edge_mult

    def f(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    n_seg = len(problem.eumaps)
    ntid = problem.n_transcripts
    return DeviceProblem(
        n_segments=n_seg,
        by_cid=group_edges(cid, tid, mult, n_seg, ntid, device, dtype),
        by_tid=group_edges(tid, cid, mult, ntid, n_seg, device, dtype),
        eumaps=f(problem.eumaps), reads=f(problem.reads),
        inv_denom=inverse_denom(f(problem.denom)))


def inverse_denom(denom: torch.Tensor) -> torch.Tensor:
    """1 / denom where denom > 0, else 0."""
    pos = denom > 0
    return torch.where(pos, 1.0 / torch.where(pos, denom, 1.0), 0.0)


def _segment_sum(g: EdgeGroups, x: torch.Tensor) -> torch.Tensor:
    return sum_groups(x.contiguous(), g)


def _intensities(p: DeviceProblem, theta: torch.Tensor) -> torch.Tensor:
    """s [R, C] = segment sums of mult * theta[:, tid] over edges."""
    return _segment_sum(p.by_cid, theta)


def _em_iter(p: DeviceProblem, theta: torch.Tensor) -> torch.Tensor:
    """One EM step (``kernels.segment_sum.em_step``; on the CPU its plain
    torch body)."""
    return em_step(theta.contiguous(), p.by_cid, p.by_tid, p.reads,
                   p.inv_denom)


def gain_of(reads: torch.Tensor, eumaps: torch.Tensor, s_old: torch.Tensor,
            s_new: torch.Tensor) -> torch.Tensor:
    """logL(s_new) - logL(s_old) summed over the last (segment) axis,
    termwise from the intensity deltas (resolves tiny gains even in
    float32).  A read-bearing segment whose intensity collapses to 0 is a
    likelihood collapse (-1e30), the reverse +1e30.  Shared by the CSR and
    the dense solvers (the CSR cycle computes the terms in
    ``kernels.csr_cycle``'s kernels on the card)."""
    return torch.sum(gain_terms(reads, eumaps, s_old, s_new), dim=-1)


def loglik_of(reads: torch.Tensor, eumaps: torch.Tensor, s: torch.Tensor
              ) -> torch.Tensor:
    """logL of intensities ``s`` summed over the last (segment) axis; a
    read-bearing segment of zero intensity counts -1e30."""
    lam = eumaps * s
    pos = lam > 0
    safe = torch.where(pos, lam, 1.0)
    dead = (reads > 0).to(s.dtype) * -1e30
    return torch.sum(torch.where(pos, reads * torch.log(safe) - lam, dead),
                     dim=-1)


def clusters_for(p) -> bool:
    """Whether the CSR cycles of ``p`` (a DeviceProblem or anything with
    its edge groupings) run on thread-block clusters: at most
    ``CLUSTER_MAX_EDGES`` edges a row."""
    return p.by_cid.idx.shape[0] <= CLUSTER_MAX_EDGES


def _squarem_cycle_launches(p: DeviceProblem, src: Source,
                            intensities: bool = False) -> tuple:
    """One stabilized SQUAREM cycle as launches on the card, from ``src``:
    theta [R, T], or the previous cycle's (gain [R], cand, t2), whose
    accept (``cycle_select``) is this cycle's theta.  Three EM steps (the
    second also writing r * r and v * v), the two step-length row sums,
    the extrapolation, the gain terms of cand over t2 and their row sum:
    twelve launches with the accept.  Returns (gain, cand, t2), and with
    ``intensities`` (t2's intensities, cand's) too."""
    theta = src if isinstance(src, torch.Tensor) else cycle_select(*src)
    t1 = _em_iter(p, theta)
    t2, r_sq, v_sq = em_step_cycle(t1, theta, p.by_cid, p.by_tid, p.reads,
                                   p.inv_denom)
    x = cycle_extrap(theta, t1, t2, torch.sum(r_sq, dim=1, keepdim=True),
                     torch.sum(v_sq, dim=1, keepdim=True))
    cand = _em_iter(p, x)  # stabilization
    gain = pair_gain(p.by_cid, p.reads, p.eumaps, t2, cand,
                     intensities=intensities)
    terms, s_pair = (gain[0], gain[1:]) if intensities else (gain, ())
    return (torch.sum(terms, dim=-1), cand, t2, *s_pair)


def _same_groups(a: EdgeGroups, b: EdgeGroups) -> bool:
    """Whether two edge groupings hold the same edges (content, not
    identity: on one device, in one dtype, equal tensors)."""
    return a is b or (
        a.n_x == b.n_x and a.mult.dtype == b.mult.dtype
        and a.mult.device == b.mult.device
        and a.offsets.shape == b.offsets.shape
        and a.idx.shape == b.idx.shape and torch.equal(a.offsets, b.offsets)
        and torch.equal(a.idx, b.idx) and torch.equal(a.mult, b.mult))


def _cached_plan(p, rows: int) -> Optional[TilePlan]:
    """``plan_for``'s plan of ``rows`` rows of ``p``'s edges, from the
    cache when a plan of the same edge groupings (by content), rows, dtype
    and device is there; else made (``PLANS_MADE``) and kept, the oldest
    plans dropped while the cache holds more than ``PLAN_CACHE`` of them
    or ``PLAN_CACHE_BYTES`` (the newest always kept)."""
    global PLANS_MADE
    for i, (r, by_cid, by_tid, plan, _) in enumerate(_PLANS):
        if (r == rows and _same_groups(by_cid, p.by_cid)
                and _same_groups(by_tid, p.by_tid)):
            _PLANS.append(_PLANS.pop(i))
            return plan
    plan = plan_for(p.by_cid, p.by_tid, rows)
    PLANS_MADE += 1
    size = plan.nbytes() if plan is not None else 0
    _PLANS.append((rows, p.by_cid, p.by_tid, plan, size))
    while len(_PLANS) > 1 and (len(_PLANS) > PLAN_CACHE or sum(
            e[-1] for e in _PLANS) > PLAN_CACHE_BYTES):
        _PLANS.pop(0)
    return plan


def clear_plans() -> None:
    """Empty ``cycle_plan``'s cache."""
    _PLANS.clear()


def cycle_plan(p, rows: int, clusters: Optional[bool] = None
               ) -> Optional[TilePlan]:
    """The tile plan of the cycles of ``rows`` rows of ``p`` on clusters
    (``kernels.csr_cluster.plan_for``, made once per edge structure: see
    ``_cached_plan``), or None for twelve launches a cycle: by default on
    clusters when ``clusters_for(p)`` and a plan fits; ``clusters`` forces
    the path (True raises when no plan fits)."""
    if clusters is False or (clusters is None and not clusters_for(p)):
        return None
    plan = _cached_plan(p, rows)
    if plan is None and clusters:
        raise ValueError("no cluster plan fits this problem: a module's "
                         "share overflows a block's shared memory")
    return plan


def _squarem_block(p: DeviceProblem, theta: torch.Tensor, n: int,
                   plan: Optional[TilePlan],
                   s_prev: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """``n`` stabilized SQUAREM cycles (Varadhan & Roland 2008) per row:
    the extrapolation falls back to the double-EM value whenever it loses
    likelihood, so convergence stays monotone.  ``p`` is a DeviceProblem
    or anything with its edge groupings and reads, eumaps and inv_denom of
    one row or one per row of theta (the batched solve's ShardedProblem).
    Returns (theta, its intensities [R, C], their gain terms over
    ``s_prev`` or None without it): the block's end, ``block_end``.

    On clusters by ``plan`` (``cycle_plan``) a cycle is ``em_pair``
    (taking the previous cycle's accept as its theta), the two step-length
    row sums, ``extrap_gain`` and the gain's row sum: five launches; with
    no plan twelve launches a cycle (``_squarem_cycle_launches``).  The last
    cycle also writes the intensities of t2 and cand, from which
    ``block_end`` picks the accepted row's.  Both give the same bits."""
    src = theta.contiguous()
    for i in range(n):
        last = i == n - 1
        if plan is None:
            out = _squarem_cycle_launches(p, src, intensities=last)
        else:
            th, t1, t2, r_sq, v_sq = em_pair(src, plan, p.reads, p.inv_denom)
            cand, terms, *s_pair = extrap_gain(
                th, t1, t2, torch.sum(r_sq, dim=1, keepdim=True),
                torch.sum(v_sq, dim=1, keepdim=True), plan, p.reads,
                p.eumaps, p.inv_denom, intensities=last)
            out = (torch.sum(terms, dim=-1), cand, t2, *s_pair)
        src = out[:3]
    return block_end(*out, s_prev, p.reads, p.eumaps)


def _squarem_cycles(p: DeviceProblem, theta: torch.Tensor, n: int,
                    plan: Optional[TilePlan]) -> torch.Tensor:
    """The theta of ``_squarem_block``'s ``n`` cycles."""
    return _squarem_block(p, theta, n, plan)[0]


def _squarem_cycle(p: DeviceProblem, theta: torch.Tensor, *,
                   clusters: Optional[bool] = None) -> torch.Tensor:
    """One cycle of ``_squarem_cycles``, its plan made here."""
    return _squarem_cycles(p, theta, 1,
                           cycle_plan(p, theta.shape[0], clusters))


def em_solve(p: DeviceProblem, theta0: torch.Tensor, epsilon: float,
             block_iters: int, max_iters: int, *, plain: bool = False,
             clusters: Optional[bool] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """SQUAREM EM from ``theta0`` [R, ntid] until each row's likelihood
    gain over a block drops below ``epsilon`` or the iteration cap is hit
    (the JAX loop's cond, ``it * block_iters * 3 < max_iters``).  Returns
    (theta [R, ntid], logL [R], n_blocks of the longest row).

    The blocks run in ``loop.while_loop`` (a CUDA graph on the card);
    ``plain=True`` reads the stop flag after every block instead.
    ``clusters`` forces the cycles' path (``cycle_plan``)."""
    theta = theta0.clone()
    plan = cycle_plan(p, theta.shape[0], clusters)
    s_prev = _intensities(p, theta)
    active = torch.ones(theta.shape[0], dtype=torch.bool,
                        device=theta.device)
    it = torch.zeros((), dtype=torch.int64, device=theta.device)

    def block():
        th, s_new, terms = _squarem_block(p, theta, block_iters, plan,
                                          s_prev)
        gain = torch.sum(terms, dim=-1)
        # rows that already stopped keep their state (vmap'd while_loop)
        loop.advance(active, it, ((theta, th), (s_prev, s_new)))
        active.logical_and_((gain >= epsilon)
                            & (it * (block_iters * 3) < max_iters))

    loop.while_loop(block, active, plain=plain)
    return theta, loglik_of(p.reads, p.eumaps, s_prev), int(it)


def polish_host_f64(problem: SolverProblem, theta: np.ndarray,
                    epsilon: float = 1e-9, max_cycles: int = 200,
                    native: Optional[bool] = None
                    ) -> Tuple[np.ndarray, int]:
    """Short float64 SQUAREM polish on the host; returns (theta, the cycles
    it ran, the last one that met ``epsilon`` included).

    Closes the float32 convergence floor and the dense/CSR seams; starts at
    the device solution so only a handful of cycles run.  Runs in the C++
    library (csrc/solver.cc, a copy of the JAX package's) when available;
    ``native=False`` forces the NumPy path."""
    if native is not False:
        try:
            from ..ingest import native as native_mod
            th = np.ascontiguousarray(theta, dtype=np.float64).copy()
            denom = problem.denom.astype(np.float64)
            inv_denom = np.where(denom > 0, 1.0 /
                                 np.where(denom > 0, denom, 1.0), 0.0)
            cycles = native_mod.polish_squarem(
                problem.edge_cid, problem.edge_tid, problem.edge_mult,
                problem.eumaps, problem.reads, inv_denom, th,
                epsilon, max_cycles)
            return th, cycles
        except RuntimeError:
            if native:
                raise

    e_cid = problem.edge_cid.astype(np.int64)
    e_tid = problem.edge_tid.astype(np.int64)
    mult = problem.edge_mult.astype(np.float64)
    E = problem.eumaps.astype(np.float64)
    R = problem.reads.astype(np.float64)
    denom = problem.denom.astype(np.float64)
    n_seg = len(E)
    ntid = problem.n_transcripts
    inv_denom = np.where(denom > 0, 1.0 / np.where(denom > 0, denom, 1.0), 0.0)

    def em(th):
        s = np.bincount(e_cid, weights=mult * th[e_tid], minlength=n_seg)
        ratio = np.where(s > 0, R / np.where(s > 0, s, 1.0), 0.0)
        num = np.bincount(e_tid, weights=mult * ratio[e_cid], minlength=ntid)
        return th * num * inv_denom

    def gain(s_old, s_new):
        both = (s_old > 0) & (s_new > 0)
        ratio = np.log1p(np.where(both, (s_new - s_old) /
                                  np.where(both, s_old, 1.0), 0.0))
        died = (s_old > 0) & (s_new <= 0) & (R > 0)
        born = (s_old <= 0) & (s_new > 0) & (R > 0)
        term = np.where(both, R * ratio,
                        np.where(died, -1e30, np.where(born, 1e30, 0.0)))
        return float(np.sum(term - E * (s_new - s_old)))

    def intens(th):
        return np.bincount(e_cid, weights=mult * th[e_tid], minlength=n_seg)

    th = theta.astype(np.float64)
    s_prev = intens(th)
    for cycle in range(max_cycles):
        t1 = em(th)
        t2 = em(t1)
        r = t1 - th
        v = t2 - t1 - r
        vn = float(np.sqrt(np.sum(v * v)))
        alpha = -float(np.sqrt(np.sum(r * r))) / vn if vn > 0 else -1.0
        alpha = min(alpha, -1.0)
        extrap = th - 2.0 * alpha * r + alpha * alpha * v
        cand = em(np.where(extrap > 0, extrap, t2))
        th = cand if gain(intens(t2), intens(cand)) >= 0 else t2
        s_new = intens(th)
        if gain(s_prev, s_new) < epsilon:
            return th, cycle + 1
        s_prev = s_new
    return th, max_cycles


def torch_dtype(dtype) -> torch.dtype:
    """The torch solve dtype of a NumPy float dtype (float32 or float64)."""
    return torch.float32 if np.dtype(dtype) == np.float32 else torch.float64


def restart_inits(problem: SolverProblem, n_rounds: int, seed: int,
                  dtype) -> np.ndarray:
    """The restart rounds' starts [n_rounds, ntid] in ``dtype``: the JAX
    package's NumPy draws, uniform(0, 100), 0 where the denominator is."""
    rng = np.random.default_rng(np.uint64(0x5EED_0000) + np.uint64(seed))
    inits = rng.uniform(0.0, 100.0, size=(n_rounds, problem.n_transcripts))
    return np.where(problem.denom[None, :] > 0, inits, 0.0).astype(dtype)


def solve_restart_rounds(problem: SolverProblem, n_rounds: int,
                         device: torch.device, epsilon: float = 1e-9,
                         max_iters: int = 200000, block_iters: int = 8,
                         dtype=np.float32, seed: int = 0,
                         polish: bool = True) -> np.ndarray:
    """``n_rounds`` EM solves from independent uniform(0,100) inits, as one
    batched device solve over a leading rounds axis.

    Gives ``-n``/sd.of.FPKM its reference semantics (the reference re-runs
    the MLE NUM_ROUND times from fresh inits, src/emsar_functions.c:3077-
    3080).  The inits are the JAX package's NumPy draws (same seed), so the
    two packages restart from identical points.  Returns theta
    [n_rounds, ntid] (float64)."""
    ntid = problem.n_transcripts
    n_seg = len(problem.eumaps)
    inits = restart_inits(problem, n_rounds, seed, dtype)
    if n_seg == 0 or n_rounds == 0:
        return np.zeros((n_rounds, ntid), dtype=np.float64)
    if np.dtype(dtype) == np.float32:
        epsilon = max(epsilon, 1e-5)

    tdt = torch_dtype(dtype)
    p = problem_to_device(problem, device, tdt)
    theta, _, _ = em_solve(p, torch.as_tensor(inits).to(device, tdt),
                           epsilon, block_iters, max_iters)
    theta = theta.cpu().numpy().astype(np.float64)
    if polish and np.dtype(dtype) == np.float32:
        for r in range(n_rounds):
            theta[r] = polish_host_f64(problem, theta[r],
                                       epsilon=1e-9, max_cycles=200)[0]
    return theta


def read_attribution_starts(problem: SolverProblem, reads: np.ndarray,
                            denom: np.ndarray) -> np.ndarray:
    """The solve's default start of each sample (float64 [S, ntid]) from
    its reads [S, C] and denominators [S, ntid]: every segment's reads
    granted fully to each member transcript (upper-bound scale), over the
    denominator (0 where it is 0)."""
    S, T = reads.shape[0], problem.n_transcripts
    rows = np.repeat(np.arange(S, dtype=np.int64) * T, len(problem.edge_tid))
    num0 = np.bincount(  # sums each transcript's edges in edge order
        rows + np.tile(problem.edge_tid.astype(np.int64), S),
        weights=(problem.edge_mult[None, :]
                 * reads[:, problem.edge_cid]).ravel(),
        minlength=S * T).reshape(S, T)
    th0 = num0 / np.where(denom > 0, denom, 1.0)
    return np.where(denom > 0, th0, 0.0)


def read_attribution_start(problem: SolverProblem) -> np.ndarray:
    """The solve's default start (float64 [ntid])."""
    return read_attribution_starts(problem, problem.reads[None],
                                   problem.denom[None])[0]


def solve(problem: SolverProblem, device: torch.device,
          epsilon: float = 1e-9, max_iters: int = 200000,
          block_iters: int = 8, dtype=None,
          theta0: Optional[np.ndarray] = None
          ) -> Tuple[np.ndarray, float, int]:
    """Solve the global EM problem; returns (fpkm [ntid], logL, n_blocks)."""
    ntid = problem.n_transcripts
    n_seg = len(problem.eumaps)
    if dtype is None:
        dtype = problem.eumaps.dtype
    if n_seg == 0:
        return np.zeros(ntid, dtype=dtype), 0.0, 0
    if np.dtype(dtype) == np.float32:
        # float32 cannot resolve likelihood gains below its noise floor
        epsilon = max(epsilon, 1e-5)
    if theta0 is None:
        theta0 = read_attribution_start(problem)
    theta0 = np.where(problem.denom > 0, theta0, 0.0).astype(dtype)

    tdt = torch_dtype(dtype)
    p = problem_to_device(problem, device, tdt)
    theta, ll, it = em_solve(p, torch.as_tensor(theta0)[None, :].to(device),
                             epsilon, block_iters, max_iters)
    return theta[0].cpu().numpy(), float(ll[0]), it
