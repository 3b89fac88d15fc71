"""CSR EM solver for the per-module Poisson likelihood, in PyTorch.

The port of ``emsar_tpu/model/solver.py``.  Per module the reference
maximizes F = sum_cid R_cid * log(lambda_cid) - lambda_cid with
lambda_cid = EUMAps_cid * sum_{tid in CT[cid]} FPKM_tid by multiplicative
EM fixed-point updates on the identical objective:

    s_c     = sum_t m_ct * theta_t          (segment intensity)
    theta_t <- theta_t * (sum_c m_ct R_c / s_c) / (sum_c m_ct E_c)

accelerated by stabilized SQUAREM cycles, over ALL modules jointly as one
global (cid, tid, multiplicity) edge list.  Both segment sums of an EM
step go through ``kernels.segment_sum`` over the edges grouped by cid
(CSR) and by tid (CSC): a fixed summation order, so a solve gives the same
bits on every run (``index_add_`` on CUDA sums with float atomics).

The loop runs on the host one block of ``block_iters`` cycles at a time and
syncs once per block to test convergence (JAX's ``lax.while_loop`` keeps it
on the device; moving it there is queued).  Restart rounds, vmapped in the
JAX package, ride a leading ``[R, ntid]`` axis with a per-round convergence
mask, so every round stops exactly where it would stop alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from emsar_tpu.model.modules import ModuleDecomposition, SegmentGraph

from ..kernels.segment_sum import segment_sum


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
class EdgeGroups:
    """The edges grouped by one endpoint, for ``kernels.segment_sum``:
    the CSR ``offsets`` of the groups, the other endpoint ``idx`` and the
    multiplicity ``mult``, both in grouped order."""

    offsets: torch.Tensor  # int64 [n_seg + 1]
    idx: torch.Tensor  # int64 [E]
    mult: torch.Tensor  # [E]


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


def problem_to_device(problem: SolverProblem, device: torch.device,
                      dtype: torch.dtype) -> DeviceProblem:
    """Move a SolverProblem to ``device`` in ``dtype`` (indices int64),
    with the edges grouped by cid and by tid.  Both groupings are stable
    sorts of the edge list, so each segment keeps the edges' own order
    (``build_problem`` emits edges sorted by (cid, tid): the cid grouping
    is then the identity)."""
    cid = np.asarray(problem.edge_cid, dtype=np.int64)
    tid = np.asarray(problem.edge_tid, dtype=np.int64)
    mult = np.asarray(problem.edge_mult)

    def f(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    def i(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64)).to(device)

    def groups(seg, other, n_seg):
        order = np.argsort(seg, kind="stable")
        offsets = np.zeros(n_seg + 1, dtype=np.int64)
        np.cumsum(np.bincount(seg, minlength=n_seg), out=offsets[1:])
        return EdgeGroups(offsets=i(offsets),
                          idx=i(other[order]), mult=f(mult[order]))

    n_seg = len(problem.eumaps)
    denom = f(problem.denom)
    pos = denom > 0
    inv_denom = torch.where(pos, 1.0 / torch.where(pos, denom, 1.0), 0.0)
    return DeviceProblem(
        n_segments=n_seg, by_cid=groups(cid, tid, n_seg),
        by_tid=groups(tid, cid, problem.n_transcripts),
        eumaps=f(problem.eumaps), reads=f(problem.reads),
        inv_denom=inv_denom)


def _segment_sum(g: EdgeGroups, x: torch.Tensor) -> torch.Tensor:
    return segment_sum(x.contiguous(), g.mult, g.idx, g.offsets)


def _intensities(p: DeviceProblem, theta: torch.Tensor) -> torch.Tensor:
    """s [R, C] = segment sums of mult * theta[:, tid] over edges."""
    return _segment_sum(p.by_cid, theta)


def _em_iter(p: DeviceProblem, theta: torch.Tensor) -> torch.Tensor:
    s = _intensities(p, theta)
    pos = s > 0
    ratio = torch.where(pos, p.reads / torch.where(pos, s, 1.0), 0.0)
    num = _segment_sum(p.by_tid, ratio)
    return theta * num * p.inv_denom


def gain_of(reads: torch.Tensor, eumaps: torch.Tensor, s_old: torch.Tensor,
            s_new: torch.Tensor) -> torch.Tensor:
    """logL(s_new) - logL(s_old) summed over the last (segment) axis,
    termwise from the intensity deltas (resolves tiny gains even in
    float32).  A read-bearing segment whose intensity collapses to 0 is a
    likelihood collapse (-1e30), the reverse +1e30.  Shared by the CSR and
    the dense solvers."""
    both = (s_old > 0) & (s_new > 0)
    safe_old = torch.where(both, s_old, 1.0)
    ratio = torch.log1p(torch.where(both, (s_new - s_old) / safe_old, 0.0))
    died = (s_old > 0) & (s_new <= 0) & (reads > 0)
    born = (s_old <= 0) & (s_new > 0) & (reads > 0)
    # died and born exclude each other: the nested where of the JAX code
    term = torch.where(both, reads * ratio,
                       (born.to(s_new.dtype) - died.to(s_new.dtype)) * 1e30)
    return torch.sum(term - eumaps * (s_new - s_old), dim=-1)


def _loglik_of(p: DeviceProblem, s: torch.Tensor) -> torch.Tensor:
    lam = p.eumaps * s
    pos = lam > 0
    safe = torch.where(pos, lam, 1.0)
    dead = (p.reads > 0).to(s.dtype) * -1e30
    return torch.sum(torch.where(pos, p.reads * torch.log(safe) - lam, dead),
                     dim=-1)


def _squarem_cycle(p: DeviceProblem, theta: torch.Tensor) -> torch.Tensor:
    """One stabilized SQUAREM cycle (Varadhan & Roland 2008) per row: the
    extrapolation falls back to the double-EM value whenever it loses
    likelihood, so convergence stays monotone."""
    t1 = _em_iter(p, theta)
    t2 = _em_iter(p, t1)
    r = t1 - theta
    v = t2 - t1 - r
    rnorm = torch.sqrt(torch.sum(r * r, dim=1, keepdim=True))
    vnorm = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
    alpha = torch.where(vnorm > 0, -rnorm / torch.where(vnorm > 0, vnorm, 1.0),
                        -1.0)
    alpha = torch.clamp(alpha, max=-1.0)  # never shorter than a plain step
    # zero-crossing coordinates fall back to the plain double-EM value: an
    # exact 0 is an absorbing boundary for multiplicative EM and can freeze
    # a suboptimal KKT point
    extrap = theta - 2.0 * alpha * r + (alpha * alpha) * v
    cand = _em_iter(p, torch.where(extrap > 0, extrap, t2))  # stabilization
    better = gain_of(p.reads, p.eumaps, _intensities(p, t2),
                      _intensities(p, cand)) >= 0
    return torch.where(better[:, None], cand, t2)


def em_solve(p: DeviceProblem, theta0: torch.Tensor, epsilon: float,
             block_iters: int, max_iters: int
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """SQUAREM EM from ``theta0`` [R, ntid] until each row's likelihood
    gain over a block drops below ``epsilon`` or the iteration cap is hit
    (the JAX loop's cond, ``it * block_iters * 3 < max_iters``).  Returns
    (theta [R, ntid], logL [R], n_blocks of the longest row).

    The host reads one flag per block (``.item()``), the only sync."""
    theta = theta0
    s_prev = _intensities(p, theta)
    active = torch.ones(theta.shape[0], dtype=torch.bool,
                        device=theta.device)
    it = 0
    while True:
        th = theta
        for _ in range(block_iters):
            th = _squarem_cycle(p, th)
        s_new = _intensities(p, th)
        gain = gain_of(p.reads, p.eumaps, s_prev, s_new)
        # rows that already stopped keep their state (vmap'd while_loop)
        theta = torch.where(active[:, None], th, theta)
        s_prev = torch.where(active[:, None], s_new, s_prev)
        it += 1
        active = active & (gain >= epsilon)
        if not (it * block_iters * 3 < max_iters and bool(active.any())):
            break
    return theta, _loglik_of(p, s_prev), it


def polish_host_f64(problem: SolverProblem, theta: np.ndarray,
                    epsilon: float = 1e-9, max_cycles: int = 200,
                    native: Optional[bool] = None) -> np.ndarray:
    """Short float64 SQUAREM polish on the host.

    Closes the float32 convergence floor and the dense/CSR seams; starts at
    the device solution so only a handful of cycles run.  Runs in the C++
    extension (csrc/solver.cc, shared with the JAX package) when available;
    ``native=False`` forces the NumPy path."""
    if native is not False:
        try:
            from emsar_tpu.ingest import native as native_mod
            th = np.ascontiguousarray(theta, dtype=np.float64).copy()
            denom = problem.denom.astype(np.float64)
            inv_denom = np.where(denom > 0, 1.0 /
                                 np.where(denom > 0, denom, 1.0), 0.0)
            native_mod.polish_squarem(
                problem.edge_cid, problem.edge_tid, problem.edge_mult,
                problem.eumaps, problem.reads, inv_denom, th,
                epsilon, max_cycles)
            return th
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
    for _ in range(max_cycles):
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
            break
        s_prev = s_new
    return th


def torch_dtype(dtype) -> torch.dtype:
    """The torch solve dtype of a NumPy float dtype (float32 or float64)."""
    return torch.float32 if np.dtype(dtype) == np.float32 else torch.float64


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
    rng = np.random.default_rng(np.uint64(0x5EED_0000) + np.uint64(seed))
    inits = rng.uniform(0.0, 100.0, size=(n_rounds, ntid))
    inits = np.where(problem.denom[None, :] > 0, inits, 0.0).astype(dtype)
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
                                       epsilon=1e-9, max_cycles=200)
    return theta


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
        # read-attribution start: every segment's reads granted fully to
        # each member transcript (upper-bound scale)
        num0 = np.zeros(ntid, dtype=np.float64)
        np.add.at(num0, problem.edge_tid,
                  problem.edge_mult * problem.reads[problem.edge_cid])
        theta0 = num0 / np.where(problem.denom > 0, problem.denom, 1.0)
    theta0 = np.where(problem.denom > 0, theta0, 0.0).astype(dtype)

    tdt = torch_dtype(dtype)
    p = problem_to_device(problem, device, tdt)
    theta, ll, it = em_solve(p, torch.as_tensor(theta0)[None, :].to(device),
                             epsilon, block_iters, max_iters)
    return theta[0].cpu().numpy(), float(ll[0]), it
