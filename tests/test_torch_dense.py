"""The port's dense module solver and its SQUAREM block against the JAX
package: partition arrays identical, the kernel's plain version against
the Pallas kernel (interpret mode) for every size class and dtype, and the
dense solves on likelihood and segment intensities."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from emsar_tpu.model import dense as jdense
from emsar_tpu.model.solver import build_problem
from emsar_tpu_torch.kernels import squarem
from emsar_tpu_torch.kernels.check import (block_agreement, block_tol,
                                           random_modules)
from emsar_tpu_torch.model import dense as tdense
from tests.test_dense_solver import _problem

CPU = torch.device("cpu")
# test workers share the machine's cores: one intra-op thread each keeps
# the many tiny torch ops of the EM loops from oversubscribing them
torch.set_num_threads(1)


@pytest.mark.parametrize("n_iters", [1, 8], ids=["cycle", "block"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("C,T", jdense.SIZE_CLASSES,
                         ids=[f"{c}x{t}" for c, t in jdense.SIZE_CLASSES])
def test_squarem_block_ref_matches_pallas(C, T, dtype, n_iters):
    """One cycle and one 8-cycle block of the plain version against the
    Pallas kernel in interpret mode (tolerances: kernels/check.py)."""
    rng = np.random.default_rng(C * T)
    B = 16
    args = random_modules(rng, B, C, T, dtype)
    want = np.asarray(jdense._pallas_block(
        *(jnp.asarray(a) for a in args), n_iters=n_iters, tile_b=B))
    targs = [torch.as_tensor(a) for a in args]
    got = squarem.squarem_block_ref(*targs, n_iters)
    assert got.dtype == targs[0].dtype and torch.isfinite(got).all()
    err, _, n = block_agreement(got, torch.as_tensor(want), *targs, n_iters)
    assert n >= B // 2
    assert err <= block_tol(got.dtype, n_iters), err


def test_squarem_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    targs = [torch.as_tensor(a)
             for a in random_modules(rng, 4, 64, 16, np.float64)]
    before = squarem.LAUNCHES
    got = squarem.squarem_block(*targs, 8)
    assert squarem.LAUNCHES == before  # no kernel launch on the CPU
    torch.testing.assert_close(got, squarem.squarem_block_ref(*targs, 8),
                               rtol=0, atol=0)


@pytest.mark.parametrize("seed,gene_family", [(0, True), (4, False)])
def test_partition_modules_identical(seed, gene_family):
    graph, modules, eumaps, rc = _problem(seed=seed, gene_family=gene_family)
    for dtype in (np.float32, np.float64):
        want = jdense.partition_modules(graph, modules, eumaps, rc,
                                        dtype=dtype)
        got = tdense.partition_modules(graph, modules, eumaps, rc,
                                       dtype=dtype)
        np.testing.assert_array_equal(got.csr_sids, want.csr_sids)
        assert len(got.batches) == len(want.batches) > 0
        for g, w in zip(got.batches, want.batches):
            assert g.shape == w.shape
            for f in ("flat_idx", "eumaps", "reads", "tid_map", "sids"):
                a, b = getattr(g, f), getattr(w, f)
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)
        rows = np.array([0])
        sub_g = tdense.subset_batch(got.batches[0], rows)
        sub_w = jdense.subset_batch(want.batches[0], rows)
        np.testing.assert_array_equal(sub_g.flat_idx, sub_w.flat_idx)


def _intensity(problem, theta):
    s = np.zeros(len(problem.eumaps))
    np.add.at(s, problem.edge_cid, problem.edge_mult * theta[problem.edge_tid])
    return problem.eumaps * s


def _loglik(problem, theta):
    lam = _intensity(problem, theta)
    m = lam > 0
    assert not ((~m) & (problem.reads > 0)).any()
    return float(np.sum(problem.reads[m] * np.log(lam[m]) - lam[m]))


def _dense_fpkm(mod, part, ntid, **kw):
    fpkm = np.zeros(ntid)
    covered = np.zeros(ntid, dtype=bool)
    for batch in part.batches:
        theta, _ = mod.solve_dense_batch(batch, 1e-12, **kw)
        mask = batch.tid_map >= 0
        fpkm[batch.tid_map[mask]] = theta[mask]
        covered[batch.tid_map[mask]] = True
    return fpkm, covered


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["bmm", "kernel"])
def test_solve_dense_batch_matches_jax(use_pallas):
    """Same optimum as the JAX dense solve (float64, epsilon 1e-12): logL
    to rel 1e-10, segment intensities to rtol 1e-7 (theta itself is not
    identifiable inside collinear isoform groups)."""
    graph, modules, eumaps, rc = _problem(seed=1)
    problem = build_problem(graph, modules, eumaps, rc)
    part = tdense.partition_modules(graph, modules, eumaps, rc,
                                    dtype=np.float64)
    want, covered = _dense_fpkm(jdense, part, graph.n_transcripts,
                                use_pallas=use_pallas)
    got, _ = _dense_fpkm(tdense, part, graph.n_transcripts, device=CPU,
                         use_pallas=use_pallas)
    # compare on the dense-solved modules only (CSR covers the rest)
    sub = covered[problem.edge_tid]
    seg = np.zeros(len(problem.eumaps), dtype=bool)
    seg[problem.edge_cid[sub]] = True
    ll_w, ll_g = _loglik(problem, want), _loglik(problem, got)
    assert abs(ll_g - ll_w) <= 1e-10 * abs(ll_w), (ll_g, ll_w)
    np.testing.assert_allclose(_intensity(problem, got)[seg],
                               _intensity(problem, want)[seg],
                               rtol=1e-7, atol=1e-12)


def test_solve_dense_restarts_matches_jax():
    """Restart rounds from identical inits [R, B, T]: per-round segment
    intensities agree (float64, epsilon 1e-10)."""
    graph, modules, eumaps, rc = _problem(seed=2)
    part = tdense.partition_modules(graph, modules, eumaps, rc,
                                    dtype=np.float64)
    batch = part.batches[0]
    rows = np.flatnonzero((batch.tid_map >= 0).sum(axis=1) >= 2)
    sub = tdense.subset_batch(batch, rows)
    nB, _, T = sub.shape
    rng = np.random.default_rng(7)
    inits = rng.uniform(0.0, 100.0, size=(3, nB, T))
    inits = np.where(sub.tid_map[None] >= 0, inits, 0.0)
    want = jdense.solve_dense_restarts(sub, inits, 1e-10)
    got = tdense.solve_dense_restarts(sub, inits, 1e-10, CPU)
    assert got.shape == want.shape == (3, nB, T)
    m = sub.m
    lam_w = np.einsum("bct,rbt->rbc", m, want) * sub.eumaps
    lam_g = np.einsum("bct,rbt->rbc", m, got) * sub.eumaps
    np.testing.assert_allclose(lam_g, lam_w, rtol=1e-6, atol=1e-9)
