"""The port's CSR solver against ``emsar_tpu.model.solver`` on identical
SolverProblems (float64): logL to rel 1e-10, segment intensities to rtol
1e-7, restart rounds from the same NumPy inits, and the shared C++
polish."""

import dataclasses

import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_problem
from emsar_tpu.model import solver as jsolver
from emsar_tpu_torch.model import solver as tsolver
from tests.test_dense_solver import _problem

CPU = torch.device("cpu")
# test workers share the machine's cores: one intra-op thread each keeps
# the many tiny torch ops of the EM loops from oversubscribing them
torch.set_num_threads(1)


def _as_f64(problem):
    return dataclasses.replace(
        problem, edge_mult=problem.edge_mult.astype(np.float64),
        eumaps=problem.eumaps.astype(np.float64),
        reads=problem.reads.astype(np.float64),
        denom=problem.denom.astype(np.float64))


def _gene_family_problem():
    graph, modules, eumaps, rc = _problem(seed=0)
    return jsolver.build_problem(graph, modules, eumaps, rc)


PROBLEMS = {"synthetic": lambda: _as_f64(_synthetic_problem()),
            "gene_family": _gene_family_problem}


def _intensity(problem, theta):
    s = np.zeros(len(problem.eumaps))
    np.add.at(s, problem.edge_cid, problem.edge_mult * theta[problem.edge_tid])
    return problem.eumaps * s


def _loglik(problem, theta):
    lam = _intensity(problem, theta)
    m = lam > 0
    return float(np.sum(problem.reads[m] * np.log(lam[m]) - lam[m]))


def test_build_problem_identical():
    graph, modules, eumaps, rc = _problem(seed=3)
    want = jsolver.build_problem(graph, modules, eumaps, rc)
    got = tsolver.build_problem(graph, modules, eumaps, rc)
    assert got.n_transcripts == want.n_transcripts
    for f in ("edge_cid", "edge_tid", "edge_mult", "eumaps", "reads",
              "denom"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_solve_matches_jax(name):
    problem = PROBLEMS[name]()
    th_w, ll_w, _ = jsolver.solve(problem, epsilon=1e-12)
    th_g, ll_g, blocks = tsolver.solve(problem, CPU, epsilon=1e-12)
    assert blocks > 0 and th_g.dtype == np.float64
    assert abs(ll_g - ll_w) <= 1e-10 * abs(ll_w), (ll_g, ll_w)
    np.testing.assert_allclose(_intensity(problem, th_g),
                               _intensity(problem, th_w),
                               rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_solve_restart_rounds_matches_jax(name):
    """Each round starts from the JAX package's NumPy draw (seed
    0x5EED_0000 + seed) and lands on the same intensities."""
    problem = PROBLEMS[name]()
    want = jsolver.solve_restart_rounds(problem, 3, epsilon=1e-12,
                                        dtype=np.float64, seed=5)
    got = tsolver.solve_restart_rounds(problem, 3, CPU, epsilon=1e-12,
                                       dtype=np.float64, seed=5)
    assert got.shape == want.shape == (3, problem.n_transcripts)
    for r in range(3):
        np.testing.assert_allclose(_intensity(problem, got[r]),
                                   _intensity(problem, want[r]),
                                   rtol=1e-7, atol=1e-12)


def test_rounds_axis_matches_single_solves():
    """The leading rounds axis freezes each round where it converged: the
    batched solve equals one solve per round."""
    problem = _gene_family_problem()
    rng = np.random.default_rng(11)
    inits = np.where(problem.denom > 0,
                     rng.uniform(0, 100, size=(3, problem.n_transcripts)),
                     0.0)
    p = tsolver.problem_to_device(problem, CPU, torch.float64)
    batched, ll, _ = tsolver.em_solve(p, torch.as_tensor(inits), 1e-9, 8,
                                      200000)
    for r in range(3):
        one, ll1, _ = tsolver.em_solve(p, torch.as_tensor(inits[r:r + 1]),
                                       1e-9, 8, 200000)
        torch.testing.assert_close(batched[r], one[0], rtol=1e-12,
                                   atol=1e-12)
        assert abs(float(ll[r]) - float(ll1[0])) <= 1e-12 * abs(float(ll1[0]))


def test_solve_float32_matches_jax():
    """float32 solve: epsilon floors at 1e-5 in both packages; logL agrees
    to the float32 convergence floor (rel 1e-6)."""
    problem = _gene_family_problem()
    th_w, _, _ = jsolver.solve(problem, dtype=np.float32)
    th_g, _, _ = tsolver.solve(problem, CPU, dtype=np.float32)
    assert th_g.dtype == np.float32
    ll_w = _loglik(problem, th_w.astype(np.float64))
    ll_g = _loglik(problem, th_g.astype(np.float64))
    assert abs(ll_g - ll_w) <= 1e-6 * abs(ll_w), (ll_g, ll_w)


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
def test_polish_matches_jax(native):
    problem = _gene_family_problem()
    theta, _, _ = jsolver.solve(problem, dtype=np.float32)
    want = jsolver.polish_host_f64(problem, theta, native=native)
    got, cycles = tsolver.polish_host_f64(problem, theta, native=native)
    np.testing.assert_array_equal(got, want)
    # the cycles run: the same count from both implementations, and a
    # polish capped one cycle short of it ends elsewhere
    other = tsolver.polish_host_f64(problem, theta, native=not native)
    assert other[1] == cycles >= 1
    if cycles > 1:
        short = tsolver.polish_host_f64(problem, theta, max_cycles=cycles - 1,
                                        native=native)
        assert short[1] == cycles - 1
        assert not np.array_equal(short[0], got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_sums_match_index_add(seed):
    """The CSR (by cid) and CSC (by tid) segment sums of the EM step equal
    ``index_add_`` over the edge list in its own order, bit for bit on the
    CPU, also when the edges do not come sorted by cid."""
    rng = np.random.default_rng(seed)
    n_seg, ntid, E = 300, 120, 2000
    cid = rng.integers(0, n_seg, E)
    if seed == 0:
        cid = np.sort(cid)
    problem = jsolver.SolverProblem(
        n_transcripts=ntid, edge_cid=cid.astype(np.int32),
        edge_tid=rng.integers(0, ntid, E).astype(np.int32),
        edge_mult=rng.integers(1, 3, E).astype(np.float64),
        eumaps=rng.uniform(0.1, 2, n_seg), reads=rng.poisson(5, n_seg) * 1.0,
        denom=rng.uniform(0.5, 3, ntid))
    p = tsolver.problem_to_device(problem, CPU, torch.float64)
    theta = torch.as_tensor(rng.uniform(0, 10, (2, ntid)))
    ratio = torch.as_tensor(rng.uniform(0, 10, (2, n_seg)))
    e_cid = torch.as_tensor(cid)
    e_tid = torch.as_tensor(problem.edge_tid.astype(np.int64))
    mult = torch.as_tensor(problem.edge_mult)
    s_want = theta.new_zeros((2, n_seg)).index_add_(
        1, e_cid, mult * theta[:, e_tid])
    n_want = theta.new_zeros((2, ntid)).index_add_(
        1, e_tid, mult * ratio[:, e_cid])
    assert torch.equal(tsolver._intensities(p, theta), s_want)
    assert torch.equal(tsolver._segment_sum(p.by_tid, ratio), n_want)
    assert p.by_cid.offsets[-1] == p.by_tid.offsets[-1] == E

