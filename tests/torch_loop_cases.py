"""The convergence loops' test cases, shared by ``tests/test_torch_loop.py``
(the CPU, against the JAX package) and ``tests/test_torch_loop_cuda.py``
(the card, which has no JAX): random modules as a dense batch and as one
CSR problem, each loop's inputs for three stops (convergence between two
reads of the stop flag, a NaN block gain, the block cap), and the
parent's loops as they were, with one host read of the flag per block;
the CSR loops' cycle and gain as the torch body they were before the
cycle's kernels (``kernels/csr_cycle.py``), which
``tests/test_torch_csr_cycle.py`` holds the kernels' path to as well."""

import numpy as np
import torch

from emsar_tpu_torch.kernels import squarem
from emsar_tpu_torch.model import dense as tdense
from emsar_tpu_torch.model import loop
from emsar_tpu_torch.model import solver as tsolver
from emsar_tpu_torch.parallel import mesh as tmesh

B, C, T = 8, 8, 4  # modules of one batch, segments and transcripts each
BLOCK_ITERS = 2
CAP_BLOCKS = 4
EPSILON = 1e-9
LOOPS = ["csr", "dense", "restarts", "kernel", "sharded"]
CASES = ["stop", "nan", "cap"]
# Seeds of the random modules, chosen so that each loop stops between two
# reads of the flag, at the JAX loop's block: "stop" converges (no
# zero-read segment, so no NaN gain) and "cap" stops the same inputs at
# CAP_BLOCKS.  "nan" stops on a NaN block gain: in the dense loops from
# the modules' own zero-read segments; the CSR loops' global step length
# keeps those from collapsing, and restart rounds from random starts
# collapse at bit-sensitive blocks, so theirs is ``_nan_module``'s.
STOP_SEED = 27
NAN_SEEDS = {"csr": 4, "dense": 1, "restarts": 0, "kernel": 0,
             "sharded": 4}
NAN_EUMAP = {"csr": 1e4, "sharded": 1e4, "restarts": 1e3}


def _modules(seed, zero_share):
    """B random modules of C segments x T transcripts as a DenseBatch:
    EUMAps over five decades, Poisson reads, ``zero_share`` of the
    segments without reads (where an intensity can collapse and the block
    gain turn NaN)."""
    rng = np.random.default_rng(seed)
    m = (rng.random((B, C, T)) < 0.5).astype(np.float64)
    for b in range(B):
        m[b, np.arange(C), rng.integers(0, T, C)] = 1
        m[b, rng.integers(0, C, T), np.arange(T)] = 1
    eumaps = 10.0 ** rng.uniform(-1, 4, (B, C))
    reads = rng.poisson(rng.uniform(0, 50, (B, C))).astype(np.float64)
    reads[rng.random((B, C)) < zero_share] = 0
    return _batch(m, eumaps, reads)


def _batch(m, eumaps, reads):
    b_, c_, t_ = np.nonzero(m)
    return tdense.DenseBatch(
        shape=(B, C, T), flat_idx=((b_ * C + c_) * T + t_).astype(np.int32),
        eumaps=eumaps, reads=reads,
        tid_map=np.arange(B * T, dtype=np.int32).reshape(B, T),
        sids=np.arange(B, dtype=np.int64))


def _nan_module(batch, k):
    """``batch`` with its last module made of segments {t0, t1} (100
    reads) and {t1} (no reads, EUMAp ``k`` times the first's): t1
    collapses, and once nothing slows it (the other modules' SQUAREM
    steps in the CSR loops, t0's growth from a tiny start in restart
    rounds), {t1}'s intensity falls by more than 1e16 in a block and its
    gain term is 0 * log1p(-1) = NaN."""
    m = np.zeros(B * C * T)
    np.add.at(m, batch.flat_idx, 1.0)
    m = m.reshape(B, C, T)
    eumaps, reads = batch.eumaps.copy(), batch.reads.copy()
    m[-1], eumaps[-1], reads[-1] = 0.0, 0.0, 0.0
    m[-1, 0, :2] = m[-1, 1, 1] = 1.0
    eumaps[-1, :2] = 1.0, k
    reads[-1, 0] = 100.0
    return _batch(m, eumaps, reads)


def _csr_fields(batch):
    """The batch's modules as one CSR problem (SolverProblem fields):
    segment b * C + c, transcript b * T + t, edges sorted by (cid, tid),
    segments without edges left out."""
    flat = np.sort(batch.flat_idx.astype(np.int64))
    seg, tid = flat // T, (flat // (C * T)) * T + flat % T
    keep = np.unique(seg)
    cid = np.searchsorted(keep, seg)
    mult = np.ones(len(flat))
    eumaps, reads = batch.eumaps.ravel()[keep], batch.reads.ravel()[keep]
    denom = np.zeros(B * T)
    np.add.at(denom, tid, mult * eumaps[cid])
    return dict(n_transcripts=B * T, edge_cid=cid.astype(np.int32),
                edge_tid=tid.astype(np.int32), edge_mult=mult,
                eumaps=eumaps, reads=reads, denom=denom)


def _inits(rng, shape, denom):
    return np.where(denom > 0, rng.uniform(0.0, 100.0, shape), 0.0)


def _cap(case):
    return CAP_BLOCKS if case == "cap" else 2048


# ---- the CSR cycle and gain as torch ops (EM steps and intensities by
# the segment-sum kernels), as they were before kernels/csr_cycle.py -------


def torch_body_gain_of(reads, eumaps, s_old, s_new):
    both = (s_old > 0) & (s_new > 0)
    safe_old = torch.where(both, s_old, 1.0)
    ratio = torch.log1p(torch.where(both, (s_new - s_old) / safe_old, 0.0))
    died = (s_old > 0) & (s_new <= 0) & (reads > 0)
    born = (s_old <= 0) & (s_new > 0) & (reads > 0)
    # died and born exclude each other: the nested where of the JAX code
    term = torch.where(both, reads * ratio,
                       (born.to(s_new.dtype) - died.to(s_new.dtype)) * 1e30)
    return torch.sum(term - eumaps * (s_new - s_old), dim=-1)


def torch_body_cycle(p, theta):
    """One SQUAREM cycle; ``p`` a DeviceProblem or a ShardedProblem of one
    process (reads, eumaps, inv_denom a row each)."""
    t1 = tsolver._em_iter(p, theta)
    t2 = tsolver._em_iter(p, t1)
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
    cand = tsolver._em_iter(p, torch.where(extrap > 0, extrap, t2))
    better = torch_body_gain_of(p.reads, p.eumaps,
                                tsolver._intensities(p, t2),
                                tsolver._intensities(p, cand)) >= 0
    return torch.where(better[:, None], cand, t2)


def gain_branch_cases(dtype, device=torch.device("cpu")):
    """(s_old, s_new, reads, eumaps) [2, 12] through every branch of the
    gain term: both positive (read-bearing and read-less), died and born
    with and without reads, both zero, an intensity unchanged; row 0 also
    NaN intensities and read-less segments whose intensity falls by more
    than 1e16 (0 * log1p(-1): NaN terms), row 1 none of those (a finite
    gain, in float32 too)."""
    nan = np.nan
    rows = (
        [[2.0, 3.0, 1.0, 0.0, 1.0, 0.0, nan, 2.0, 5.0, 5.0, 7.0, 1.0],
         [1e6, 0.5, 3.0, 0.0, 2.0, 2.0, 1.0, 2.0, 1.0, 3.0, 0.0, 1e-30]],
        [[2.5, 3.0, 0.0, 1.0, 0.0, 2.0, 1.0, nan, 5e-17, 4.0, 7.0, 0.5],
         [2e5, 0.0, 0.0, 2.0, 0.01, 1.0, 0.5, 2.0, 0.25, 3.5, 0.0, 1e-29]],
        [[1.0, 0.0, 3.0, 2.0, 0.0, 0.0, 2.0, 1.0, 0.0, 4.0, 0.0, 5.0],
         [0.0, 3.0, 1.0, 1.0, 0.0, 3.0, 1.0, 0.0, 0.0, 2.0, 1.0, 4.0]],
        np.linspace(0.5, 2.0, 24).reshape(2, 12))
    return [torch.as_tensor(np.asarray(a, dtype=np.float64)).to(device, dtype)
            for a in rows]


def _torch_body_block(sp, th, block_iters):
    for _ in range(block_iters):
        th = torch_body_cycle(sp, th)
    s = tsolver._intensities(sp, th)
    return th, s, tsolver.loglik_of(sp.reads, sp.eumaps, s)


# ---- the parent's loops, as they were: one host read per block ---------


def parent_em_solve(p, theta0, epsilon, block_iters, max_iters):
    theta = theta0
    s_prev = tsolver._intensities(p, theta)
    active = torch.ones(theta.shape[0], dtype=torch.bool,
                        device=theta.device)
    it = 0
    while True:
        th = theta
        for _ in range(block_iters):
            th = torch_body_cycle(p, th)
        s_new = tsolver._intensities(p, th)
        gain = torch_body_gain_of(p.reads, p.eumaps, s_prev, s_new)
        theta = torch.where(active[:, None], th, theta)
        s_prev = torch.where(active[:, None], s_new, s_prev)
        it += 1
        active = active & (gain >= epsilon)
        if not (it * block_iters * 3 < max_iters and bool(active.any())):
            break
    return theta, tsolver.loglik_of(p.reads, p.eumaps, s_prev), it, gain


def _parent_solve_loop(db, theta0, epsilon, block_iters, max_blocks):
    th = theta0
    s_prev = tdense._mt(db.m, th)
    active = torch.ones(th.shape[0], dtype=torch.bool, device=th.device)
    it = 0
    while True:
        new = th
        for _ in range(block_iters):
            new = tdense._cycle(db, new)
        s_new = tdense._mt(db.m, new)
        gain = torch.amax(tsolver.gain_of(db.reads, db.eumaps, s_prev,
                                          s_new), dim=-1)
        th = torch.where(active[:, None, None], new, th)
        s_prev = torch.where(active[:, None, None], s_new, s_prev)
        it += 1
        active = active & (gain >= epsilon)
        if not (it < max_blocks and bool(active.any())):
            break
    return th, it, gain


def _parent_pallas(db, epsilon, block_iters, max_blocks):
    th = tdense._theta0(db)
    s_prev = tdense._mt(db.m, th)
    it = 0
    while True:
        th = squarem.squarem_block(db.m, db.eumaps, db.reads, db.inv_denom,
                                   th, block_iters)
        s_new = tdense._mt(db.m, th)
        gain = torch.max(tsolver.gain_of(db.reads, db.eumaps, s_prev, s_new))
        s_prev = s_new
        it += 1
        if not (gain.item() >= epsilon and it < max_blocks):
            break
    return th, it, gain


def parent_sharded(sp, epsilon, max_blocks, block_iters):
    """The sharded solve of a world of one."""
    th, s, ll = _torch_body_block(sp, sp.theta0, block_iters)
    gain, it = float("inf"), 0
    while gain >= epsilon and it < max_blocks:
        th_new, s_new, ll_new = _torch_body_block(sp, th, block_iters)
        gain = float(torch_body_gain_of(sp.reads, sp.eumaps, s, s_new).sum())
        th, s, ll = th_new, s_new, ll_new
        it += 1
    return th, float(ll.sum()), it, torch.tensor(gain)


# ---- each loop: its inputs, the port (new or parent), JAX ---------------


class Case:
    """One loop on one case's inputs (NumPy, from the case's seed), on
    ``device``."""

    def __init__(self, name, case, device=torch.device("cpu")):
        self.name, self.case, self.device = name, case, device
        if case != "nan":
            self.batch = _modules(STOP_SEED, 0.0)
        else:
            self.batch = _modules(NAN_SEEDS[name],
                                  0.4 if name in ("dense", "kernel") else 0)
            if name in NAN_EUMAP:
                self.batch = _nan_module(self.batch, NAN_EUMAP[name])
        self.fields = _csr_fields(self.batch)
        self.cap = _cap(case)
        rng = np.random.default_rng(17)
        if name == "csr":
            problem = tsolver.SolverProblem(**self.fields)
            start = tsolver.read_attribution_start(problem)
            self.theta0 = np.concatenate(
                [start[None], _inits(rng, (2, B * T), problem.denom)])
        elif name == "restarts":
            self.theta0 = _inits(rng, (3, B, T), 1.0)
            if case == "nan":  # t1 at its level without t0, t0 tiny
                self.theta0[:, -1] = 0.0
                self.theta0[:, -1, 1] = 100.0 / (1.0 + NAN_EUMAP[name])
                self.theta0[:, -1, 0] = [1e-20, 1e-40, 1e-60]
        elif name == "sharded":
            reads = self.fields["reads"]
            self.reads = np.stack([reads, np.where(
                reads > 0, rng.poisson(reads + 0.5), 0.0)])

    def _device(self):
        if self.name == "csr":
            return tsolver.problem_to_device(
                tsolver.SolverProblem(**self.fields), self.device,
                torch.float64)
        if self.name == "sharded":
            return tmesh.shard_problem(
                tsolver.SolverProblem(**self.fields), self.reads,
                tmesh.make_mesh(device=self.device), dtype=np.float64)
        return tdense.batch_to_device(self.batch, self.device, torch.float64)

    def port(self, parent=False, plain=False):
        """(theta, logL or None, blocks, the last block's gain or None)."""
        d = self._device()
        bi, cap = BLOCK_ITERS, self.cap
        if self.name == "csr":
            th0 = torch.as_tensor(self.theta0).to(self.device)
            if parent:
                th, ll, it, g = parent_em_solve(d, th0, EPSILON, bi,
                                                 cap * bi * 3)
                return th, ll, it, g
            th, ll, it = tsolver.em_solve(d, th0, EPSILON, bi, cap * bi * 3,
                                          plain=plain)
            return th, ll, it, None
        if self.name in ("dense", "restarts"):
            th0 = (tdense._theta0(d)[None] if self.name == "dense"
                   else torch.as_tensor(self.theta0).to(self.device))
            if parent:
                th, it, g = _parent_solve_loop(d, th0, EPSILON, bi, cap)
                return th, None, it, g
            th, it = tdense._solve_loop(d, th0, EPSILON, bi, cap,
                                        plain=plain)
            return th, None, it, None
        if self.name == "kernel":
            if parent:
                th, it, g = _parent_pallas(d, EPSILON, bi, cap)
                return th, None, it, g
            th, it = tdense._dense_solve_pallas(d, EPSILON, bi, cap,
                                                plain=plain)
            return th, None, it, None
        if parent:
            return parent_sharded(d, EPSILON, cap, bi)
        th, ll, it = tmesh.solve_sharded(d, EPSILON, cap, bi, plain=plain)
        return torch.as_tensor(th), ll, it, None


def bits(x):
    """The float64 bit patterns of ``x`` (NaN compares equal to itself)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    a = np.ascontiguousarray(np.asarray(x, dtype=np.float64))
    return a.view(np.uint64)


def same_bits(a, b):
    """Two (theta, logL or None, blocks, ...) results are the same bits."""
    (th_a, ll_a, it_a), (th_b, ll_b, it_b) = a[:3], b[:3]
    assert it_a == it_b
    np.testing.assert_array_equal(bits(th_a), bits(th_b))
    if ll_a is not None:
        np.testing.assert_array_equal(bits(ll_a), bits(ll_b))


# ---- the f64 polish on the device (``solver.polish_device``) against the
# host's C++ polish (``solver.polish_host_f64``) --------------------------

POLISH_CASES = ["gene_family", "stop", "one_cycle", "nan_gain"]
POLISH_CAPS = [200, 2]
POLISH_EPSILON = 1e-9
# the read-less segment's EUMAp in the NaN-gain case: from the
# read-attribution start its transcript falls by ~1e30 a cycle, so the
# stop gain is NaN in cycles 1 and 3-6 (``_nan_module``)
NAN_GAIN_EUMAP = 1e10


def gene_family_problem(n_genes=25, seed=0, readlen=20, reads_per_euma=1.5,
                        **shape):
    """The likelihood problem (float64) of a gene-family transcriptome
    indexed by the port's NumPy builder, with Poisson read counts
    (``tests/test_dense_solver.py::_problem``'s recipe; ``shape`` goes to
    ``sim.gene_family_transcriptome``): (problem, graph, modules, eumaps,
    read counts)."""
    from emsar_tpu_torch.config import BuildConfig
    from emsar_tpu_torch.index.build import build_se_index
    from emsar_tpu_torch.io.fasta import build_transcriptome
    from emsar_tpu_torch.model.modules import (build_segment_graph,
                                               decompose_modules)
    from emsar_tpu_torch.sim import gene_family_transcriptome

    rng = np.random.default_rng(seed)
    names, seqs, _ = gene_family_transcriptome(rng, n_genes, **shape)
    idx = build_se_index(build_transcriptome(names, seqs), readlen, readlen,
                         BuildConfig(verbose=0), backend="numpy")
    adj = np.concatenate([idx.single_euma[:, 0],
                          idx.multi_euma[:, 0]]).astype(np.float64)
    rc = rng.poisson(adj * reads_per_euma).astype(np.int64)
    graph = build_segment_graph(idx, adj, rc)
    modules = decompose_modules(graph)
    eumaps = adj / 1e3 * (max(int(rc.sum()), 1) / 1e6)
    problem = tsolver.build_problem(graph, modules, eumaps, rc)
    return problem, graph, modules, eumaps, rc


def polish_case(case, device=torch.device("cpu")):
    """(SolverProblem, float64 start [T]) of a polish case: ``gene_family``
    from its float32 solve on ``device``; ``stop`` (``Case("dense",
    "stop")``'s modules) from the read-attribution start; ``one_cycle``
    from those modules' polished theta, which meets epsilon in its first
    cycle; ``nan_gain`` the same modules with ``_nan_module``'s last, its
    read-less segment's EUMAp ``NAN_GAIN_EUMAP``, from the
    read-attribution start: NaN stop gains, on which the polish runs on."""
    if case == "gene_family":
        problem = gene_family_problem(n_exons=6, min_exon=40,
                                      max_exon=150)[0]
        theta, _, _ = tsolver.solve(problem, device, dtype=np.float32)
        return problem, theta.astype(np.float64)
    batch = _modules(STOP_SEED, 0.0)
    if case == "nan_gain":
        batch = _nan_module(batch, NAN_GAIN_EUMAP)
    problem = tsolver.SolverProblem(**_csr_fields(batch))
    theta = tsolver.read_attribution_start(problem)
    if case == "one_cycle":
        theta = tsolver.polish_host_f64(problem, theta, POLISH_EPSILON)[0]
    return problem, theta


def first_stop_gain(problem, theta, device=torch.device("cpu")):
    """The stop gain of the polish's first cycle from ``theta``."""
    p = tsolver.problem_to_device(problem, device, torch.float64)
    th = torch.as_tensor(theta, dtype=torch.float64).to(device)[None]
    s = tsolver._intensities(p, th)
    return float(tsolver._squarem_block(p, th, 1, None, s)[2].sum())


def check_polish(problem, theta, max_cycles, device=torch.device("cpu")):
    """``polish_device`` on ``device`` against ``polish_host_f64`` (C++)
    from ``theta``: the same cycles and stop, logL within rel 1e-10,
    segment intensities within rtol 1e-7 (theta itself is not compared:
    it is not identifiable inside collinear isoform groups).  Returns the
    cycles."""
    want, cycles = tsolver.polish_host_f64(problem, theta, POLISH_EPSILON,
                                           max_cycles, native=True)
    p = tsolver.problem_to_device(problem, device, torch.float64)
    got, got_cycles = tsolver.polish_device(
        p, torch.as_tensor(theta, dtype=torch.float64).to(device),
        POLISH_EPSILON, max_cycles)
    assert got.shape == (problem.n_transcripts,)
    assert got.dtype == torch.float64 and got.device.type == device.type
    assert got_cycles == cycles
    assert loop.LAST.stop == ("cap" if cycles >= max_cycles
                              else "converged")
    s_want, s_got = (tsolver._intensities(
        p, torch.as_tensor(th, dtype=torch.float64).to(device)[None])[0]
        for th in (want, got))
    ll_want, ll_got = (float(tsolver.loglik_of(p.reads, p.eumaps, s))
                       for s in (s_want, s_got))
    assert abs(ll_got - ll_want) <= 1e-10 * abs(ll_want), (ll_got, ll_want)
    torch.testing.assert_close(s_got, s_want, rtol=1e-7, atol=1e-12)
    return cycles
