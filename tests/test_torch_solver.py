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
    got = tsolver.polish_host_f64(problem, theta, native=native)
    np.testing.assert_array_equal(got, want)
