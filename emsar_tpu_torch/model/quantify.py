"""Quantification orchestration: index + signature counts -> FPKM/TPM.

The port of ``emsar_tpu/model/quantify.py``, mirroring the reference
per-sample pipeline (src/emsar_main.c:380-488): fragment-length weighting,
module decomposition with the EUMAcut loop, EUMAps construction, the EM
likelihood maximization on the torch device, and iEUMA / inferred read
counts.  Restart inits are drawn from the JAX package's NumPy generators
and seeds, so sd.of.FPKM agrees between the two packages.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import QuantConfig
from ..ingest.collapse import SampleCounts
from ..io.rsh import RshIndex
from ..utils.timing import note, phase, span
from . import loop
from .modules import (ModuleDecomposition, SegmentGraph, build_segment_graph,
                      decompose_modules)
from .solver import (SolverProblem, build_problem, polish_device,
                     polish_host_f64, problem_to_device, solve,
                     solve_restart_rounds)


@dataclasses.dataclass
class QuantResult:
    fpkm: np.ndarray  # [ntid] the ML estimate
    fpkm_rounds: np.ndarray  # [num_round, ntid]; round 0 is ``fpkm``
    ieuma: np.ndarray  # [ntid]
    adj_euma: np.ndarray  # [n_cid]
    wf: np.ndarray  # [nFraglen]
    graph: SegmentGraph
    modules: ModuleDecomposition
    total_read_count: int
    loglik: float


def _resolve_dtype(cfg: QuantConfig):
    """'auto' = float64 on every device: the H100 has native f64 (the JAX
    package's f32 + polish default exists for the TPU).  ``float32`` stays
    selectable."""
    if cfg.solver_dtype == "float32":
        return np.float32
    return np.float64


def _gain(cfg) -> str:
    """The solves' gain, ``cfg.solver_gain``; a configuration without that
    field (the JAX package's) takes the port's default."""
    gain = getattr(cfg, "solver_gain", QuantConfig.solver_gain)
    if gain not in ("repaired", "jax"):
        raise ValueError(f"unknown solver_gain {gain!r}")
    return gain


def _skip_unread(cfg) -> bool:
    """Whether the solves leave the read term of segments without reads
    out of their gain (``solver.gain_of``)."""
    return _gain(cfg) == "repaired"


def compute_wf(index: RshIndex, fraglength_counts: np.ndarray) -> np.ndarray:
    """Empirical fragment-length sampling probability (reference:
    transfer_fraglendist_to_Wf, src/emsar_functions.c:2503-2513)."""
    nfl = index.n_fraglen
    idx = np.arange(index.fraglen_min, index.fraglen_min + nfl)
    wf = fraglength_counts[idx].astype(np.float64)
    s = wf.sum()
    return wf / s if s > 0 else wf * np.nan


_MODULES_LOCK = threading.Lock()


def index_modules(index: RshIndex) -> Optional[ModuleDecomposition]:
    """The index-only module decomposition, cached on the index object.

    At EUMAcut == 0 every segment is active regardless of the sample's
    fragment-length weights (propagate_2 src/emsar_functions.c:2242), so
    the decomposition depends only on the index.  Returns None when a
    component exceeds MAX_NTID_PER_SID (quantify_sample then runs the
    EUMAcut loop).  Idempotent and thread-safe: the CLI calls it on a
    worker thread while the alignment file streams."""
    cached = getattr(index, "_modules_cache", None)
    if cached is not None:
        return cached[0]
    with _MODULES_LOCK:
        cached = getattr(index, "_modules_cache", None)
        if cached is not None:
            return cached[0]
        ncid = index.n_cid
        graph0 = build_segment_graph(index, np.ones(ncid),
                                     np.zeros(ncid, dtype=np.int64))
        mods = decompose_modules(graph0, fail_on_oversize=True)
        index._modules_cache = (mods,)
    return mods


@dataclasses.dataclass
class SampleInputs:
    """The host-side likelihood inputs of one sample."""

    wf: np.ndarray  # [nFraglen] fragment-length sampling probability
    adj_euma: np.ndarray  # [n_cid]
    read_count: np.ndarray  # [n_cid]
    eumaps: np.ndarray  # [n_cid] EUMAps (reference construct_EUMAps)
    graph: SegmentGraph
    modules: ModuleDecomposition


def prepare_sample(index: RshIndex, counts: SampleCounts,
                   cfg: QuantConfig) -> SampleInputs:
    """Fragment-length weighting, module decomposition and EUMAps."""
    with phase("fragment-length weighting", cfg.verbose):
        wf = compute_wf(index, counts.fraglength_counts)
        # adjEUMA = EUMA @ Wf in f64 (the one-shot exactness-sensitive matvec)
        adj_single = index.single_euma.astype(np.float64) @ wf
        adj_multi = index.multi_euma.astype(np.float64) @ wf
        adj_euma = np.concatenate([adj_single, adj_multi])

    read_count = counts.readcount_per_cid()

    with phase("module decomposition", cfg.verbose):
        graph = build_segment_graph(index, adj_euma, read_count)
        modules = index_modules(index)
        if modules is None:
            modules = decompose_modules(graph, verbose=cfg.verbose)

    # EUMAps (reference construct_EUMAps :3148-3154)
    eumaps = adj_euma / 1e3 * (counts.total_read_count / 1e6) \
        * (10.0 ** cfg.delta)
    return SampleInputs(wf=wf, adj_euma=adj_euma, read_count=read_count,
                        eumaps=eumaps, graph=graph, modules=modules)


def quantify_sample(index: RshIndex, counts: SampleCounts, cfg: QuantConfig,
                    device: torch.device) -> QuantResult:
    x = prepare_sample(index, counts, cfg)
    graph, modules, eumaps = x.graph, x.modules, x.eumaps

    with phase("EM solve", cfg.verbose):
        dtype = _resolve_dtype(cfg)
        with span("solve: problem", cfg.verbose):
            # the problem keeps f64 masters; solve() casts to the device
            # dtype
            problem = build_problem(graph, modules, eumaps, x.read_count,
                                    dtype=np.float64)
            note(edges=len(problem.edge_cid),
                 transcripts=problem.n_transcripts)
        part = None
        if cfg.solver_mode == "auto":
            fpkm, _, part = _solve_auto(graph, modules, eumaps,
                                        x.read_count, problem, cfg, dtype,
                                        device)
            ll = float("nan")
        else:
            with span("solve: csr", cfg.verbose):
                fpkm, ll, blocks = solve(
                    problem, device, epsilon=cfg.epsilon,
                    max_iters=cfg.max_niter_mle,
                    block_iters=cfg.solver_block_iters, dtype=dtype,
                    skip_unread=_skip_unread(cfg))
                note(edges=len(problem.edge_cid), blocks=blocks,
                     stop=_stop(blocks), gain=_gain(cfg))
            fpkm = fpkm.astype(np.float64)
        if dtype == np.float32 or cfg.solver_mode == "auto":
            # close the float32 convergence floor / dense-CSR seams with a
            # short f64 SQUAREM polish (on the card, or C++ on the host)
            fpkm = _polish(problem, fpkm, cfg, device=device)
        if not np.isfinite(ll):
            with span("solve: loglik", cfg.verbose):
                ll = _host_loglik(problem, fpkm)

    with phase("iEUMA", cfg.verbose):
        # iEUMA[tid] = sum over ALL cids containing tid (with multiplicity),
        # regardless of module exclusion (reference compute_iEUMA :3218)
        ieuma = np.zeros(index.n_transcripts, dtype=np.float64)
        sizes = np.diff(graph.ct_offsets)
        np.add.at(ieuma, graph.ct_tids, np.repeat(x.adj_euma, sizes))

    fpkm_rounds = _make_rounds(problem, fpkm, cfg, dtype, device, part=part,
                               graph=graph, modules=modules, eumaps=eumaps,
                               read_count=x.read_count)
    return QuantResult(fpkm=fpkm, fpkm_rounds=fpkm_rounds, ieuma=ieuma,
                       adj_euma=x.adj_euma, wf=x.wf, graph=graph,
                       modules=modules,
                       total_read_count=counts.total_read_count,
                       loglik=ll)


def _stop(blocks: int) -> str:
    """The stop reason of the solve that just ran ``blocks`` blocks
    (``loop.LAST``; none ran: an empty problem, converged)."""
    return loop.LAST.stop if blocks else "converged"


def _polish(problem: SolverProblem, theta: np.ndarray, cfg: QuantConfig,
            max_cycles: int = 200,
            device: Optional[torch.device] = None) -> np.ndarray:
    """The f64 SQUAREM polish as the span "solve: polish": its cycles,
    whether it met epsilon or ran to ``max_cycles``, and its gain
    (``_gain``).  On a CUDA ``device`` it runs on the card
    (``solver.polish_device``: the problem uploaded once, theta read back
    once; the span adds the device, ``loop.LAST``'s ``graph`` and
    ``capture_s``, and the problem's shape and cluster kernel launches,
    ``_cluster_work``), elsewhere on the host (``polish_host_f64``, C++),
    as does a problem without segments."""
    epsilon = max(cfg.epsilon, 1e-9)
    skip = _skip_unread(cfg)
    with span("solve: polish", cfg.verbose):
        if (device is not None and device.type == "cuda"
                and len(problem.eumaps)):
            p = problem_to_device(problem, device, torch.float64, skip)
            launches = _cluster_launches()
            th, cycles = polish_device(
                p, torch.as_tensor(theta, dtype=torch.float64).to(device),
                epsilon, max_cycles)
            theta = th.cpu().numpy()
            extra = dict(device=str(device), graph=loop.LAST.graph,
                         capture_s=loop.LAST.capture_s,
                         **_cluster_work(problem, 1, 1, launches))
        else:
            theta, cycles = polish_host_f64(problem, theta, epsilon=epsilon,
                                            max_cycles=max_cycles,
                                            skip_unread=skip)
            extra = {}
        note(cycles=cycles, stop="cap" if cycles >= max_cycles else "eps",
             gain=_gain(cfg), **extra)
    return theta


def _restart_eps(cfg: QuantConfig) -> float:
    """Restart-round epsilon: the sd column reports manifold spread
    (O(1-100) FPKM), far above convergence error, so the default epsilon
    is loosened to 1e-3 (validated in the JAX package, quantify.py
    ``_restart_eps``); an explicit -e overrides it."""
    default_eps = type(cfg).__dataclass_fields__["epsilon"].default
    return 1e-3 if cfg.epsilon == default_eps else cfg.epsilon


def _make_rounds(problem, fpkm: np.ndarray, cfg: QuantConfig, dtype,
                 device: torch.device, part=None, graph=None, modules=None,
                 eumaps=None, read_count=None) -> np.ndarray:
    """[num_round, ntid] FPKM rounds: round 0 is the deterministic solve,
    rounds 1..n-1 are random-restart solves whose spread across the flat
    maximizer manifold populates sd.of.FPKM (reference NUM_ROUND loop,
    src/emsar_main.c:441-450).  Only multi-transcript modules restart
    (single-transcript ones have a unique maximizer); when the main solve
    ran dense batches (``part``), restarts ride the same batches."""
    if cfg.num_round <= 1:
        return fpkm[None, :].copy()
    if part is not None:
        return _make_rounds_dense(problem, fpkm, cfg, dtype, device, part,
                                  graph, modules, eumaps, read_count)
    with phase("restart rounds", cfg.verbose):
        extra = _csr_restarts(problem, fpkm, cfg, dtype, device)
        if extra is None:
            return np.broadcast_to(fpkm,
                                   (cfg.num_round, len(fpkm))).copy()
    return np.concatenate([fpkm[None, :], extra], axis=0)


def restart_problem(problem: SolverProblem
                    ) -> Optional[Tuple[SolverProblem, np.ndarray]]:
    """The CSR restart rounds' problem: ``problem`` restricted to the
    transcripts in multi-transcript modules (and the segments of their
    edges), with the mask of those transcripts; None when nothing is
    multi-transcript."""
    ntid = problem.n_transcripts
    e_cid = problem.edge_cid
    seg_deg = np.zeros(len(problem.eumaps), dtype=np.int64)
    np.add.at(seg_deg, e_cid, 1)
    multi_tid = np.zeros(ntid, dtype=bool)
    multi_tid[problem.edge_tid[seg_deg[e_cid] >= 2]] = True
    keep = multi_tid[problem.edge_tid]
    if not keep.any():
        return None
    # compact the segment axis to segments with a kept edge
    seg_used = np.zeros(len(problem.eumaps), dtype=bool)
    seg_used[problem.edge_cid[keep]] = True
    new_cid = (np.cumsum(seg_used) - 1).astype(np.int32)
    sub = SolverProblem(
        n_transcripts=ntid, edge_cid=new_cid[problem.edge_cid[keep]],
        edge_tid=problem.edge_tid[keep],
        edge_mult=problem.edge_mult[keep],
        eumaps=problem.eumaps[seg_used], reads=problem.reads[seg_used],
        denom=np.where(multi_tid, problem.denom, 0.0))
    return sub, multi_tid


def _csr_restarts(problem, fpkm: np.ndarray, cfg: QuantConfig, dtype,
                  device: torch.device) -> Optional[np.ndarray]:
    """Restart rounds on the CSR edge list, restricted to transcripts in
    multi-transcript modules; [num_round-1, ntid] with round-0 values
    elsewhere, or None when nothing is multi-transcript.  The restricted
    problem's shape and cluster kernel launches go to the innermost open
    span (``_cluster_work``)."""
    restricted = restart_problem(problem)
    if restricted is None:
        return None
    sub, multi_tid = restricted
    launches = _cluster_launches()
    extra = solve_restart_rounds(
        sub, cfg.num_round - 1, device, epsilon=_restart_eps(cfg),
        max_iters=cfg.max_niter_mle, block_iters=cfg.solver_block_iters,
        dtype=dtype, seed=cfg.rng_seed if cfg.rng_seed is not None else 0,
        polish=False, skip_unread=_skip_unread(cfg))
    note(**_cluster_work(sub, cfg.num_round - 1, 1, launches))
    return np.where(multi_tid[None, :] & (problem.denom > 0)[None, :],
                    extra, fpkm[None, :])


def _make_rounds_dense(problem, fpkm: np.ndarray, cfg: QuantConfig, dtype,
                       device: torch.device, part, graph, modules, eumaps,
                       read_count) -> np.ndarray:
    """Restart rounds riding the dense batches of the main solve: module
    rows with >= 2 distinct transcripts are re-solved from uniform(0,100)
    inits over a leading rounds axis with M shared, on the hand kernel
    where the class takes it on the card (``dense.kernel_route``); modules
    the main solve left to the CSR path restart there."""
    from .dense import kernel_route, solve_dense_restarts, subset_batch

    ntid = problem.n_transcripts
    n_extra = cfg.num_round - 1
    rounds = np.broadcast_to(fpkm, (n_extra, ntid)).copy()
    restart_eps = _restart_eps(cfg)
    seed = cfg.rng_seed if cfg.rng_seed is not None else 0
    rng = np.random.default_rng(np.uint64(0x5EED_0001) + np.uint64(seed))
    with phase("restart rounds", cfg.verbose):
        if len(part.csr_sids):
            keep_seg = np.isin(modules.cs, part.csr_sids)
            modules_csr = dataclasses.replace(
                modules, cs=np.where(keep_seg, modules.cs, -1))
            csr_problem = build_problem(graph, modules_csr, eumaps,
                                        read_count, dtype=np.float64)
            extra = _csr_restarts(csr_problem, fpkm, cfg, dtype, device)
            if extra is not None:
                touched = np.zeros(ntid, dtype=bool)
                touched[csr_problem.edge_tid] = True
                rounds[:, touched] = extra[:, touched]
        for batch in part.batches:
            multi_rows = np.flatnonzero(
                (batch.tid_map >= 0).sum(axis=1) >= 2)
            if not len(multi_rows):
                continue
            sub = subset_batch(batch, multi_rows)
            nB, _, T = sub.shape
            inits = rng.uniform(0.0, 100.0, size=(n_extra, nB, T))
            inits = np.where(sub.tid_map[None, :, :] >= 0, inits, 0.0)
            eps = (max(restart_eps, 1e-5)
                   if np.dtype(sub.eumaps.dtype) == np.float32
                   else restart_eps)
            theta = solve_dense_restarts(
                sub, inits, eps, device, block_iters=cfg.solver_block_iters,
                skip_unread=_skip_unread(cfg),
                use_pallas=kernel_route(sub, device))
            mask = sub.tid_map >= 0
            rounds[:, sub.tid_map[mask]] = theta[:, mask]
    return np.concatenate([fpkm[None, :], rounds], axis=0)


def _cluster_launches() -> int:
    """The launches of the two cluster kernels so far (their wrappers'
    counters, which count a replayed graph's launches too)."""
    from ..kernels import csr_cluster
    return csr_cluster.EM_PAIR_LAUNCHES + csr_cluster.EXTRAP_GAIN_LAUNCHES


def _cluster_work(problem: SolverProblem, rows: int, operand_rows: int,
                  since: int) -> dict:
    """A span's attributes for the cluster kernels' work of the solve it
    holds: the problem's ``edges``, ``segments`` and ``transcripts``, the
    ``rows`` solved together, the rows of their reads, EUMAps and 1 /
    denom (``operand_rows``: 1 where the rows share them), and
    ``cluster_launches``, those of ``cluster_em_pair`` and
    ``cluster_extrap_gain`` since the count ``since``
    (``_cluster_launches``)."""
    return dict(edges=len(problem.edge_cid), segments=len(problem.eumaps),
                transcripts=problem.n_transcripts, rows=rows,
                operand_rows=operand_rows,
                cluster_launches=_cluster_launches() - since)


def _host_loglik(problem, theta: np.ndarray) -> float:
    s = np.zeros(len(problem.eumaps))
    np.add.at(s, problem.edge_cid,
              problem.edge_mult * theta[problem.edge_tid])
    lam = problem.eumaps * s
    m = lam > 0
    ll = float(np.sum(problem.reads[m] * np.log(lam[m]) - lam[m]))
    if ((~m) & (problem.reads > 0)).any():
        ll = -1e30
    return ll


def _solve_auto(graph, modules, eumaps, read_count, problem, cfg, dtype,
                device: torch.device):
    """Dense batched solve for small modules + CSR for the rest; returns
    (fpkm, the blocks of every loop, the partition).  A dense batch runs on
    the hand kernel with --solver_pallas, and on a CUDA device where its
    class is one of ``dense.KERNEL_CLASSES``; else on torch.bmm.  Each
    step is a span (``solve: partition``, a ``solve: dense batch`` a size
    class with its route, ``solve: csr``) with its blocks and stop
    reason."""
    from .dense import kernel_route, partition_modules, solve_dense_batch

    with span("solve: partition", cfg.verbose):
        part = partition_modules(graph, modules, eumaps, read_count,
                                 dtype=dtype)
        note(batches=len(part.batches), csr_modules=len(part.csr_sids))
    eps = max(cfg.epsilon, 1e-5) if dtype == np.float32 else cfg.epsilon
    fpkm = np.zeros(graph.n_transcripts, dtype=np.float64)
    blocks_total = 0
    for batch in part.batches:
        with span("solve: dense batch", cfg.verbose):
            kernel = cfg.solver_pallas or kernel_route(batch, device)
            theta, blocks = solve_dense_batch(
                batch, eps, device, block_iters=cfg.solver_block_iters,
                use_pallas=kernel, skip_unread=_skip_unread(cfg))
            note(shape="x".join(map(str, batch.shape)), blocks=blocks,
                 stop=loop.LAST.stop, graph=loop.LAST.graph,
                 capture_s=loop.LAST.capture_s, gain=_gain(cfg),
                 route="kernel" if kernel else "bmm")
            blocks_total += blocks
            mask = batch.tid_map >= 0
            fpkm[batch.tid_map[mask]] = theta[mask].astype(np.float64)
    if len(part.csr_sids):
        with span("solve: csr", cfg.verbose):
            keep = np.isin(modules.cs, part.csr_sids)
            modules_csr = dataclasses.replace(
                modules, cs=np.where(keep, modules.cs, -1))
            csr_problem = build_problem(graph, modules_csr, eumaps,
                                        read_count, dtype=np.float64)
            theta, _, blocks = solve(csr_problem, device,
                                     epsilon=cfg.epsilon,
                                     max_iters=cfg.max_niter_mle,
                                     block_iters=cfg.solver_block_iters,
                                     dtype=dtype,
                                     skip_unread=_skip_unread(cfg))
            note(edges=len(csr_problem.edge_cid), blocks=blocks,
                 stop=_stop(blocks), gain=_gain(cfg))
            blocks_total += blocks
            touched = np.zeros(graph.n_transcripts, dtype=bool)
            touched[csr_problem.edge_tid] = True
            fpkm[touched] = theta.astype(np.float64)[touched]
    return fpkm, blocks_total, part


@dataclasses.dataclass
class BatchedInputs:
    """The likelihood inputs of a multisample batch: one edge list over
    the active cids (in a module) and per-sample EUMAps ``E`` [S, C],
    reads ``R`` [S, C] (0 where E is 0: the reference skips such segments)
    and denominators [S, T]."""

    problem: SolverProblem  # the edges, with sample 0's E, R and denom
    E: np.ndarray
    R: np.ndarray
    denom: np.ndarray
    graph: SegmentGraph
    modules: ModuleDecomposition
    wfs: list
    adjs: list
    rcs: list


def batched_inputs(index: RshIndex, counts_list, cfg: QuantConfig
                   ) -> Optional[BatchedInputs]:
    """Per-sample fragment-length weights and adjusted EUMA, one module
    decomposition and the batch's matrices; None when EUMAcut
    re-clustering triggers (the module structure then depends on each
    sample's EUMA)."""
    ntid = index.n_transcripts
    S = len(counts_list)
    wfs, adjs, rcs = [], [], []
    for counts in counts_list:
        wf = compute_wf(index, counts.fraglength_counts)
        adj = np.concatenate([index.single_euma.astype(np.float64) @ wf,
                              index.multi_euma.astype(np.float64) @ wf])
        wfs.append(wf)
        adjs.append(adj)
        rcs.append(counts.readcount_per_cid())

    graph = build_segment_graph(index, adjs[0], rcs[0])
    modules = decompose_modules(graph, verbose=cfg.verbose)
    if modules.euma_cut != 0.0:
        return None

    # active cids: in a module (a sample's E == 0 segments get 0 reads)
    active = modules.cs >= 0
    act_cids = np.flatnonzero(active)
    local = np.full(graph.n_cid, -1, dtype=np.int64)
    local[act_cids] = np.arange(len(act_cids))
    sizes = np.diff(graph.ct_offsets)
    rep = np.repeat(active, sizes)
    flat_cid = np.repeat(np.arange(graph.n_cid, dtype=np.int64), sizes)[rep]
    flat_tid = graph.ct_tids[rep].astype(np.int64)
    uniq, mult = np.unique(flat_cid * ntid + flat_tid, return_counts=True)
    e_cid = local[uniq // ntid].astype(np.int32)
    e_tid = (uniq % ntid).astype(np.int32)
    e_mult = mult.astype(np.float64)

    scale = (10.0 ** cfg.delta) / 1e9
    E = np.stack([adjs[s][act_cids] * (counts_list[s].total_read_count
                                       * scale) for s in range(S)])
    R = np.stack([rcs[s][act_cids].astype(np.float64) for s in range(S)])
    R = np.where(E > 0, R, 0.0)
    denom = np.zeros((S, ntid))
    for s in range(S):
        np.add.at(denom[s], e_tid, e_mult * E[s, e_cid])
    problem = SolverProblem(n_transcripts=ntid, edge_cid=e_cid,
                            edge_tid=e_tid, edge_mult=e_mult, eumaps=E[0],
                            reads=R[0], denom=denom[0])
    return BatchedInputs(problem=problem, E=E, R=R, denom=denom, graph=graph,
                         modules=modules, wfs=wfs, adjs=adjs, rcs=rcs)


def quantify_samples_batched(index: RshIndex, counts_list, cfg: QuantConfig,
                             device: torch.device):
    """Batched multisample quantification (the port of the JAX package's):
    one sharded solve on ``device`` over the likelihood edges, split
    across every process (tp; ``parallel.mesh``), with
    per-sample EUMAps from per-sample fragment-length weights.  Returns a
    QuantResult per sample, or None when EUMAcut re-clustering triggers
    (the caller then loops over the samples).  Results match the
    per-sample path at solver tolerance; each result's ``loglik`` is the
    batch's total, as in the JAX package."""
    from ..parallel.mesh import make_mesh, shard_problem, solve_sharded

    S = len(counts_list)
    with span("solve: batched inputs", cfg.verbose):
        b = batched_inputs(index, counts_list, cfg)
        note(samples=S)
    if b is None:
        return None
    ntid = index.n_transcripts
    dtype = _resolve_dtype(cfg)
    with span("solve: sharded loop", cfg.verbose):
        sp = shard_problem(b.problem, b.R, make_mesh(device=device),
                           dtype=dtype, eumaps_per_sample=b.E,
                           denom_per_sample=b.denom,
                           skip_unread=_skip_unread(cfg))
        launches = _cluster_launches()
        theta, ll, blocks = solve_sharded(
            sp, epsilon=max(cfg.epsilon, 1e-5) if dtype == np.float32
            else cfg.epsilon, block_iters=cfg.solver_block_iters)
        note(samples=S, blocks=blocks, stop=loop.LAST.stop,
             gain=_gain(cfg), **_cluster_work(b.problem, S, S, launches))
    theta = theta.astype(np.float64)

    results = []
    graph = b.graph
    ct_rep = np.repeat(np.arange(graph.n_cid), np.diff(graph.ct_offsets))
    for s, counts in enumerate(counts_list):
        fpkm = theta[s]
        ps = dataclasses.replace(b.problem, eumaps=b.E[s], reads=b.R[s],
                                 denom=b.denom[s])
        if dtype == np.float32:
            fpkm = _polish(ps, fpkm, cfg, device=device)
        ieuma = np.zeros(ntid)
        np.add.at(ieuma, graph.ct_tids, b.adjs[s][ct_rep])
        fpkm_rounds = _make_rounds(ps, fpkm, cfg, dtype, device)
        results.append(QuantResult(
            fpkm=fpkm, fpkm_rounds=fpkm_rounds, ieuma=ieuma,
            adj_euma=b.adjs[s], wf=b.wfs[s],
            graph=dataclasses.replace(graph, adj_euma=b.adjs[s],
                                      read_count=b.rcs[s]),
            modules=b.modules, total_read_count=counts.total_read_count,
            loglik=float(ll)))
    return results
