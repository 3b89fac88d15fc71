"""The CSR SQUAREM cycle's kernels (``kernels/csr_cycle.py``,
``segment_sum.em_step_cycle``) on the CPU, where the wrappers run their
plain versions: the rebuilt ``solver._squarem_cycle``, the launch path's
block of cycles, ``em_solve``
and ``mesh.solve_sharded`` (tp 1) give the bits of the torch body they
replaced (``tests/torch_loop_cases.py``: the cycle and gain as they were)
at R 1, R 3 (one shared row of reads) and R 16 (per-sample reads, EUMAps
and denominators), float32 and float64; the pieces on the gain's every
branch (NaN, died, born, the collapse of a read-less segment), on
``vnorm == 0`` and on a NaN step length; ``block_end`` against the pass
over the edges it replaced; ``em_solve`` on each path within rel 1e-9 of
``emsar_tpu``'s ``_em_solve`` logL on the same inputs.  The kernels
themselves run in ``tests/test_torch_cuda_emulated.py`` and, on the
card, ``tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from emsar_tpu.model import solver as jsolver
from emsar_tpu_torch.kernels import csr_cycle
from emsar_tpu_torch.kernels import segment_sum as ss
from emsar_tpu_torch.model import solver as tsolver
from emsar_tpu_torch.parallel import mesh as tmesh
from tests.test_torch_kernels_cuda import _random_problem
from torch_loop_cases import (BLOCK_ITERS, EPSILON, Case,
                              gain_branch_cases, parent_em_solve,
                              parent_sharded, torch_body_cycle,
                              torch_body_gain_of)

CPU = torch.device("cpu")
DTYPES = [torch.float32, torch.float64]
DT_IDS = ["f32", "f64"]
torch.set_num_threads(1)


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64)).view(
        np.uint64)


def _assert_bits(a, b):
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _problem(seed):
    """40 transcripts over 60 segments, read-less segments and zero
    denominators among them."""
    return _random_problem(np.random.default_rng(seed), 60, 40, 220)


def _per_sample(problem, S, seed):
    """(reads, eumaps, denominators) of S samples of ``problem``."""
    rng = np.random.default_rng(seed)
    C = len(problem.eumaps)
    reads = np.where(problem.reads > 0,
                     rng.poisson(problem.reads + 0.5, (S, C)), 0.0)
    eumaps = problem.eumaps * rng.uniform(0.8, 1.25, (S, C))
    denom = np.zeros((S, problem.n_transcripts))
    for s in range(S):
        np.add.at(denom[s], problem.edge_tid,
                  problem.edge_mult * eumaps[s, problem.edge_cid])
    return reads, eumaps, denom


def _rows(problem, R, seed, dtype):
    """theta [R, ntid]: the read-attribution start, then uniform(0, 100)
    draws, zero where the denominator is."""
    rng = np.random.default_rng(seed)
    th = np.concatenate([tsolver.read_attribution_start(problem)[None],
                         rng.uniform(0, 100, (R - 1, problem.n_transcripts))])
    return torch.as_tensor(np.where(problem.denom > 0, th, 0.0)).to(dtype)


def _sharded(problem, S, dtype, seed=3):
    reads, eumaps, denom = _per_sample(problem, S, seed)
    return tmesh.shard_problem(problem, reads, tmesh.make_mesh(device=CPU),
                               dtype=np.float32 if dtype == torch.float32
                               else np.float64, eumaps_per_sample=eumaps,
                               denom_per_sample=denom)


@pytest.mark.parametrize("R", [1, 3, 16])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_cycle_is_the_torch_body(dtype, R):
    """Twelve cycles in a row give the torch body's bits after each: R 1
    and 3 share one row of reads (the CSR solve, its restart rounds), R 16
    is the batched solve's ShardedProblem with a row each."""
    problem = _problem(R)
    if R == 16:
        p = _sharded(problem, R, dtype)
        th = p.theta0
        assert p.reads.shape == (R, len(problem.eumaps))
    else:
        p = tsolver.problem_to_device(problem, CPU, dtype)
        th = _rows(problem, R, R, dtype)
    want = th
    for _ in range(12):
        want = torch_body_cycle(p, want)
        th = (tmesh._squarem_cycle(p, th) if R == 16
              else tsolver._squarem_cycle(p, th))
        _assert_bits(th, want)
    assert not torch.equal(want, p.theta0 if R == 16 else _rows(
        problem, R, R, dtype))


@pytest.mark.parametrize("case", ["stop", "nan"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_em_solve_is_the_torch_body(dtype, case):
    """em_solve on three rows (the read-attribution start and two random
    ones) gives the torch body's loop's theta, logL and blocks; in "nan"
    one module's read-less segment collapses and the block gain turns NaN
    (0 * log1p(-1)), which stops the solve where the body's stops."""
    c = Case("csr", case)
    p = tsolver.problem_to_device(tsolver.SolverProblem(**c.fields), CPU,
                                  dtype)
    th0 = torch.as_tensor(c.theta0).to(dtype)
    eps = 1e-5 if dtype == torch.float32 else EPSILON
    max_iters = 2048 * BLOCK_ITERS * 3
    th_w, ll_w, it_w, gain = parent_em_solve(p, th0, eps, BLOCK_ITERS,
                                             max_iters)
    if case == "nan" and dtype == torch.float64:
        assert bool(torch.isnan(gain).any()), gain
    th, ll, it = tsolver.em_solve(p, th0, eps, BLOCK_ITERS, max_iters)
    assert it == it_w >= 1
    _assert_bits(th, th_w)
    _assert_bits(ll, ll_w)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_restart_shape_em_solve_is_the_torch_body(dtype):
    """The restart rounds' shape: R 3 from independent draws on one
    shared row of reads, to the end."""
    problem = _problem(7)
    p = tsolver.problem_to_device(problem, CPU, dtype)
    rng = np.random.default_rng(0x5EED_0000)
    inits = np.where(problem.denom > 0, rng.uniform(0, 100, (3, 40)), 0.0)
    th0 = torch.as_tensor(inits).to(dtype)
    eps = 1e-5 if dtype == torch.float32 else 1e-9
    th_w, ll_w, it_w, _ = parent_em_solve(p, th0, eps, 8, 200000)
    th, ll, it = tsolver.em_solve(p, th0, eps, 8, 200000)
    assert it == it_w > 1
    _assert_bits(th, th_w)
    _assert_bits(ll, ll_w)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_solve_sharded_is_the_torch_body(dtype):
    """The batched solve of 16 samples (tp 1, a world of one): theta, logL
    and blocks of the torch body's loop."""
    sp = _sharded(_problem(16), 16, dtype)
    th_w, ll_w, it_w, _ = parent_sharded(sp, 1e-9, 64, BLOCK_ITERS)
    th, ll, it = tmesh.solve_sharded(sp, 1e-9, 64, BLOCK_ITERS)
    assert it == it_w > 0
    _assert_bits(th, th_w.numpy()[:16])
    _assert_bits(ll, ll_w)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_row"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_gain_pieces_on_every_branch(dtype, shared):
    """pair_gain and block_end on one-edge segments (intensities =
    thetas) over every branch of the term: summed, the torch body's gain
    bit for bit, NaN included; pair_gain's intensities are the thetas;
    block_end's theta and intensities are the accepted row's, cand's at a
    gain >= 0 and t2's at a NaN gain; model/solver.py::gain_of is
    unchanged."""
    s_old, s_new, reads, eumaps = gain_branch_cases(dtype)
    if shared:
        reads, eumaps = reads[1], eumaps[1]
    n = s_old.shape[1]
    g = ss.prepare(torch.arange(n + 1), torch.arange(n),
                   torch.ones(n, dtype=dtype), n)
    want = torch_body_gain_of(reads, eumaps, s_old, s_new)
    assert bool(torch.isnan(want[0])) and bool(torch.isfinite(want[1]))
    terms = csr_cycle.gain_terms(reads, eumaps, s_old, s_new)
    assert torch.isnan(terms).sum() >= 3 and (terms.abs() == 1e30).any()
    got = csr_cycle.pair_gain(g, reads, eumaps, s_old, s_new)
    _assert_bits(got, terms)
    _assert_bits(torch.sum(got, dim=-1), want)
    got, s_o, s_n = csr_cycle.pair_gain(g, reads, eumaps, s_old, s_new,
                                        intensities=True)
    _assert_bits(got, terms)
    _assert_bits(s_o, s_old)
    _assert_bits(s_n, s_new)
    other = s_new.flip(-1)
    rows = s_new.shape[0]
    for value, (cand, t2) in ((0.0, (s_new, other)),
                              (np.nan, (other, s_new))):
        gain = torch.full((rows,), value, dtype=dtype)
        th, s, got = csr_cycle.block_end(gain, cand, t2, t2, cand, s_old,
                                         reads, eumaps)
        assert th.shape == s.shape == (rows, n)
        _assert_bits(th, s_new)
        _assert_bits(s, s_new)
        _assert_bits(got, terms)
        _assert_bits(torch.sum(got, dim=-1), want)
    _assert_bits(tsolver.gain_of(reads, eumaps, s_old, s_new), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_extrap_on_zero_vnorm_and_nan_alpha(dtype):
    """cycle_extrap against the body's lines where vnorm is 0 (alpha -1),
    rnorm is NaN (alpha NaN, kept by the clamp), both are inf (inf / inf:
    NaN), and the step is exactly -1; and em_step_cycle's squares are
    the body's r * r and v * v."""
    problem = _problem(4)
    p = tsolver.problem_to_device(problem, CPU, dtype)
    theta = _rows(problem, 5, 4, dtype)
    theta[1] = 0.0
    t1 = tsolver._em_iter(p, theta)
    t2, r_sq, v_sq = ss.em_step_cycle(t1, theta, p.by_cid, p.by_tid,
                                      p.reads, p.inv_denom)
    r = t1 - theta
    v = t2 - t1 - r
    _assert_bits(t2, tsolver._em_iter(p, t1))
    _assert_bits(r_sq, r * r)
    _assert_bits(v_sq, v * v)
    rs = torch.sum(r * r, dim=1, keepdim=True)
    vs = torch.sum(v * v, dim=1, keepdim=True)
    assert vs[1, 0] == 0
    rs[2, 0], rs[3, 0], vs[3, 0] = np.nan, np.inf, np.inf
    rs[4, 0] = vs[4, 0]
    got = csr_cycle.cycle_extrap(theta, t1, t2, rs, vs)
    rnorm, vnorm = torch.sqrt(rs), torch.sqrt(vs)
    alpha = torch.clamp(torch.where(
        vnorm > 0, -rnorm / torch.where(vnorm > 0, vnorm, 1.0), -1.0),
        max=-1.0)
    assert alpha[1, 0] == -1 and alpha[4, 0] == -1
    assert torch.isnan(alpha[2:4]).all()
    extrap = theta - 2.0 * alpha * r + (alpha * alpha) * v
    _assert_bits(got, torch.where(extrap > 0, extrap, t2))
    gain = torch.tensor([np.nan, -0.0, 0.0, -1e-30, 2.0], dtype=dtype)
    _assert_bits(csr_cycle.cycle_select(gain, t1, t2),
                 torch.where((gain >= 0)[:, None], t1, t2))


@pytest.mark.parametrize("seed", [1, 2])
def test_em_solve_matches_jax(seed):
    """em_solve's logL within rel 1e-9 of emsar_tpu's ``_em_solve`` from
    the same start, float64."""
    problem = _problem(seed + 20)
    th0 = tsolver.read_attribution_start(problem)
    p = tsolver.problem_to_device(problem, CPU, torch.float64)
    _, ll, it = tsolver.em_solve(p, torch.as_tensor(th0)[None], 1e-12, 8,
                                 200000)
    _, j_ll, j_it = jsolver._em_solve(
        problem.edge_cid, problem.edge_tid, problem.edge_mult,
        problem.eumaps, problem.reads, problem.denom, th0,
        n_transcripts=problem.n_transcripts,
        n_segments=len(problem.eumaps), block_iters=8, max_iters=200000,
        epsilon=1e-12)
    assert it > 1 and int(j_it) > 1
    assert abs(float(ll[0]) - float(j_ll)) <= 1e-9 * abs(float(j_ll))


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a card is refused, a card
    tensor is never computed by a plain version (no fallback), and
    em_step_cycle refuses a theta of another dtype or device than t1's."""
    meta = torch.empty((2, 5), device="meta")
    g = ss.prepare(torch.arange(6), torch.arange(5), torch.ones(5), 5)
    with pytest.raises(ValueError, match="device"):
        csr_cycle.cycle_extrap(meta, meta, meta, meta[:, :1], meta[:, :1])
    with pytest.raises(ValueError, match="device"):
        csr_cycle.cycle_select(meta[:, 0], meta, meta)
    with pytest.raises(ValueError, match="device"):
        csr_cycle.pair_gain(g, meta[0], meta[0], meta, meta)
    with pytest.raises(ValueError, match="device"):
        csr_cycle.block_end(meta[:, 0], meta, meta, meta, meta, meta,
                            meta[0], meta[0])
    with pytest.raises(ValueError, match="device"):
        ss.em_step_cycle(meta, meta, g, g, meta[0], meta[0])
    t1 = torch.ones((2, 5), dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        ss.em_step_cycle(t1, t1.float(), g, g, t1[0], t1[0])
    with pytest.raises(ValueError, match="on meta"):
        ss.em_step_cycle(t1, meta.double(), g, g, t1[0], t1[0])


def _old_block_gain(g, reads, eumaps, s_old, theta):
    """The block's pass over the edges before block_end: theta's
    intensities (its segment sums in edge order) and their gain terms."""
    s_new = ss.segment_sum_ref(theta, g.mult, g.idx, g.offsets)
    return s_new, csr_cycle.gain_terms(reads, eumaps, s_old, s_new)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_row"])
@pytest.mark.parametrize("R", [1, 3, 16])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_block_end_is_the_pass_it_replaced(dtype, R, shared):
    """block_end_ref (and block_end on the CPU) from a cycle's gain, cand,
    t2 and their intensities: the bits of cycle_select_ref and then the
    old block pass (the accepted theta's intensities summed over the edges
    and their gain terms over s_prev), on a random problem whose rows
    take cand (gain >= 0, -0.0 included) or t2 (gain < 0 or NaN), with
    zero thetas, zero-read segments, died and born segments and a NaN
    row."""
    problem = _problem(30 + R)
    p = tsolver.problem_to_device(problem, CPU, dtype)
    g = p.by_cid
    rng = np.random.default_rng(R)
    T, C = problem.n_transcripts, len(problem.eumaps)

    def theta():
        th = rng.uniform(0, 10, (R, T))
        th[rng.random((R, T)) < 0.3] = 0.0
        return torch.as_tensor(th).to(dtype)
    cand, t2, prev = theta(), theta(), theta()
    cand[0, :3] = np.nan
    reads, eumaps = p.reads, p.eumaps
    if not shared:
        reads, eumaps, _ = (torch.as_tensor(a).to(dtype)
                            for a in _per_sample(problem, R, R))
    assert (reads == 0).any()
    s_t2, s_cand, s_prev = (ss.segment_sum_ref(x, g.mult, g.idx, g.offsets)
                            for x in (t2, cand, prev))
    gain = torch.as_tensor(np.resize([np.nan, -0.0, 2.0, -1e-30, 0.0], R)
                           ).to(dtype)
    th, s, terms = csr_cycle.block_end_ref(gain, cand, t2, s_t2, s_cand,
                                           s_prev, reads, eumaps)
    want_th = csr_cycle.cycle_select_ref(gain, cand, t2)
    want_s, want_terms = _old_block_gain(g, reads, eumaps, s_prev, want_th)
    _assert_bits(th, want_th)
    _assert_bits(s, want_s)
    _assert_bits(terms, want_terms)
    died = (s_prev > 0) & (s <= 0) & (reads > 0)
    born = (s_prev <= 0) & (s > 0) & (reads > 0)
    assert bool(died.any()) and bool(born.any())
    got = csr_cycle.block_end(gain, cand, t2, s_t2, s_cand, s_prev, reads,
                              eumaps)
    for a, b in zip(got, (th, s, terms)):
        _assert_bits(a, b)
    th, s, none = csr_cycle.block_end(gain, cand, t2, s_t2, s_cand, None,
                                      reads, eumaps)
    assert none is None
    _assert_bits(s, want_s)
    assert terms.shape == (R, C)


@pytest.mark.parametrize("R", [1, 3, 16])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_launch_cycles_are_the_torch_body(dtype, R):
    """Eight cycles off clusters (twelve launches a cycle) as one block,
    ended by block_end: theta the torch body's after eight cycles, its
    intensities those of theta, and the block's gain terms over s_prev
    the body's."""
    problem = _problem(40 + R)
    if R == 16:
        p = _sharded(problem, R, dtype)
        th = p.theta0
    else:
        p = tsolver.problem_to_device(problem, CPU, dtype)
        th = _rows(problem, R, R, dtype)
    want = th
    for _ in range(8):
        want = torch_body_cycle(p, want)
    s_prev = tsolver._intensities(p, th)
    got, s, terms = tsolver._squarem_block(p, th, 8, None, s_prev)
    _assert_bits(got, want)
    s_want = tsolver._intensities(p, want)
    _assert_bits(s, s_want)
    _assert_bits(torch.sum(terms, dim=-1),
                 torch_body_gain_of(p.reads, p.eumaps, s_prev, s_want))


@pytest.mark.parametrize("path", ["clusters", "launches"])
@pytest.mark.parametrize("seed", [1, 2])
def test_em_solve_paths_match_jax(seed, path):
    """em_solve on clusters and on twelve launches a cycle: the same bits
    on each path, logL within rel 1e-9 of emsar_tpu's ``_em_solve`` from
    the same start (float64), and the same block count (no NaN gain stops
    either)."""
    problem = _problem(seed + 20)
    th0 = tsolver.read_attribution_start(problem)
    p = tsolver.problem_to_device(problem, CPU, torch.float64)
    th, ll, it = tsolver.em_solve(p, torch.as_tensor(th0)[None], 1e-12, 8,
                                  200000, clusters=path == "clusters")
    th_c, ll_c, it_c = tsolver.em_solve(p, torch.as_tensor(th0)[None],
                                        1e-12, 8, 200000)
    assert it == it_c
    _assert_bits(th, th_c)
    _assert_bits(ll, ll_c)
    _, j_ll, j_it = jsolver._em_solve(
        problem.edge_cid, problem.edge_tid, problem.edge_mult,
        problem.eumaps, problem.reads, problem.denom, th0,
        n_transcripts=problem.n_transcripts,
        n_segments=len(problem.eumaps), block_iters=8, max_iters=200000,
        epsilon=1e-12)
    assert np.isfinite(float(j_ll)) and it > 1
    assert it == int(j_it)
    assert abs(float(ll[0]) - float(j_ll)) <= 1e-9 * abs(float(j_ll))
