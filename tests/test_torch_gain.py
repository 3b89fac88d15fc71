"""The likelihood gain without the read term of segments that have no
reads (``QuantConfig.solver_gain`` 'repaired', the port's default) on the
CPU.  The JAX package's term ``reads * log1p((s_new - s_old) / s_old)`` is
0 * -inf = NaN where such a segment's intensity collapses, and a NaN gain
stops a solve early; ``tests/test_torch_loop.py``, ``test_torch_csr_cycle``
and ``test_torch_mesh`` hold that JAX-equal mode (``skip_unread`` False).
Here: every implementation's term is finite there (the plain version, the
dense kernel's plain version, the host polish in NumPy and in C++; the
CUDA sources in ``test_torch_cuda_emulated.py``), every loop stops on a
real gain on the inputs where the JAX-equal one stops on a NaN, no lower in
logL than it less rel 1e-9, and the quantifier's default reaches the
maximum where the JAX package's solve stops short: logL no lower than the
JAX package's less rel 1e-9, gene TPM within rel 1e-3 of max(TPM, 1), and
the batched multisample solve each sample's logL of the per-sample path at
solver tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

from emsar_tpu.config import BuildConfig
from emsar_tpu.config import QuantConfig as JaxQuantConfig
from emsar_tpu.index.build import build_se_index
from emsar_tpu.ingest.collapse import SampleCounts
from emsar_tpu.io.fasta import build_transcriptome
from emsar_tpu.model import quantify as jquant
from emsar_tpu.model import solver as jsolver
from emsar_tpu.sim import gene_family_transcriptome
from emsar_tpu_torch.config import QuantConfig
from emsar_tpu_torch.kernels import csr_cycle, squarem
from emsar_tpu_torch.model import dense as tdense
from emsar_tpu_torch.model import loop
from emsar_tpu_torch.model import quantify as tquant
from emsar_tpu_torch.model import solver as tsolver
from emsar_tpu_torch.utils import timing
from torch_loop_cases import (LOOPS, Case, _modules, _nan_module,
                              gain_branch_cases, polish_case)

CPU = torch.device("cpu")
torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_plain_gain_terms(dtype):
    """``gain_terms``: with ``skip_unread`` finite wherever the
    intensities are, -eumaps * (s_new - s_old) on every segment without
    reads, the JAX package's term on every segment with reads."""
    s_old, s_new, reads, eumaps = gain_branch_cases(dtype)
    jax = csr_cycle.gain_terms(reads, eumaps, s_old, s_new)
    got = csr_cycle.gain_terms(reads, eumaps, s_old, s_new, True)
    finite = ~(torch.isnan(s_old) | torch.isnan(s_new))
    assert torch.isnan(jax[finite & (reads == 0)]).any()
    assert torch.isfinite(got[finite]).all()
    unread = finite & (reads == 0)
    assert torch.equal(got[unread], (-(eumaps * (s_new - s_old)))[unread])
    assert torch.equal(got[reads > 0].nan_to_num(),
                       jax[reads > 0].nan_to_num())


def test_dense_kernel_plain_gain():
    """The dense kernel's plain version (``kernel5``'s accept gain) on a
    batch whose last module's read-less segment collapses: NaN in the
    JAX-equal mode, finite with ``skip_unread``."""
    batch = _nan_module(_modules(1, 0.0), 1e17)
    db = tdense.batch_to_device(batch, CPU, torch.float64)
    th = tdense._theta0(db)
    th[-1, :2] = torch.tensor([100.0, 1.0], dtype=torch.float64)
    args = (db.m, db.eumaps, db.reads, db.inv_denom, th)
    assert torch.isnan(squarem.squarem_cycle_ref(*args)[1][-1])
    assert torch.isfinite(squarem.squarem_cycle_ref(*args, True)[1]).all()


def _collapse_problem():
    """Segments {t0, t1} (100 reads) and {t1} (no reads, EUMAp 1e10), t0
    at its maximum and t1 at 1e-20: in the polish's first cycle the
    read-less segment falls by more than 1e16."""
    return tsolver.SolverProblem(
        n_transcripts=2, edge_cid=np.array([0, 0, 1], dtype=np.int32),
        edge_tid=np.array([0, 1, 1], dtype=np.int32),
        edge_mult=np.ones(3), eumaps=np.array([1.0, 1e10]),
        reads=np.array([100.0, 0.0]),
        denom=np.array([1.0, 1.0 + 1e10])), np.array([100.0, 1e-20])


@pytest.mark.parametrize("case", ["collapse", "nan_gain"])
def test_polish_gain(case):
    """The host polish's gain in NumPy and in C++ and the device polish's
    (CPU tensors) with ``skip_unread``: the same cycles and the same logL
    (rel 1e-10); on ``collapse`` one cycle, where the JAX-equal gain runs
    on through NaN until t1 underflows."""
    problem, theta = (_collapse_problem() if case == "collapse"
                      else polish_case("nan_gain"))
    eps = 1e-9
    jax_cycles = tsolver.polish_host_f64(problem, theta, eps, 200,
                                         native=True)[1]
    runs = [tsolver.polish_host_f64(problem, theta, eps, 200, native=n,
                                    skip_unread=True) for n in (True, False)]
    p = tsolver.problem_to_device(problem, CPU, torch.float64, True)
    th, cycles = tsolver.polish_device(
        p, torch.as_tensor(theta, dtype=torch.float64), eps, 200)
    runs.append((th.numpy(), cycles))
    assert len({c for _, c in runs}) == 1
    if case == "collapse":
        assert runs[0][1] == 1 and jax_cycles == 11
    lls = [float(tsolver.loglik_of(p.reads, p.eumaps, tsolver._intensities(
        p, torch.as_tensor(t)[None])[0])) for t, _ in runs]
    assert max(lls) - min(lls) <= 1e-10 * abs(lls[0]), lls


def _loglik(case, d, theta):
    """logL of a loop's theta, summed over its rows and modules."""
    th = torch.as_tensor(theta)
    if case.name in ("dense", "kernel", "restarts"):
        s = tdense._mt(d.m, th if th.dim() == 3 else th[None])
    else:
        s = tsolver._intensities(d, th.to(d.reads.dtype))
    return float(tsolver.loglik_of(d.reads, d.eumaps, s).sum())


@pytest.mark.parametrize("name", LOOPS)
def test_loops_stop_on_a_real_gain(name):
    """Each convergence loop on its NaN case (``torch_loop_cases``): the
    JAX-equal gain stops on NaN; with ``skip_unread`` the loop runs on to
    a real stop, its logL no lower than the NaN stop's less rel 1e-9: the
    gain below epsilon, or in the dense case the block cap, where one
    module's isoform approaches 0 as EM does, sublinearly (its block gain
    ~1e-7 at 2,048 blocks of 2 cycles)."""
    out = {}
    for skip in (False, True):
        case = Case(name, "nan")
        made = case._device
        case._device = lambda: dataclasses.replace(made(),
                                                   skip_unread=skip)
        th, _, _, _ = case.port()
        out[skip] = (loop.LAST.stop, _loglik(case, case._device(), th))
    real = "cap" if name == "dense" else "converged"
    assert out[False][0] == "nan" and out[True][0] == real, out
    assert out[True][1] - out[False][1] >= -1e-9 * abs(out[False][1]), out


def _study(n_samples, seed=3):
    """An ``emsar_tpu``-built index of 20 gene families and ``n_samples``
    Poisson count vectors, each with the unique segments of a random 30%
    of its transcripts left without reads: their transcripts fall towards
    0, the read-less segments' intensities collapse, and the JAX-equal
    dense solve stops on a NaN gain."""
    rng = np.random.default_rng(seed)
    names, seqs, _ = gene_family_transcriptome(rng, 20, n_exons=5,
                                               min_exon=40, max_exon=120)
    idx = build_se_index(build_transcriptome(names, seqs), 20, 20,
                         BuildConfig(verbose=0))
    counts = []
    for _ in range(n_samples):
        single = rng.poisson(idx.single_euma[:, 0] * 2.0)
        single[rng.random(len(single)) < 0.3] = 0
        counts.append(SampleCounts(
            single_counts=single,
            multi_counts=rng.poisson(idx.multi_euma[:, 0] * 2.0),
            fraglength_counts=np.bincount([20], minlength=401) * 1000,
            total_read_count=1000))
    return idx, counts


def _gene_tpm(idx, fpkm):
    genes = np.array([n.split("T")[0] for n in idx.names])
    _, inv = np.unique(genes, return_inverse=True)
    return np.bincount(inv, weights=fpkm / fpkm.sum() * 1e6)


@pytest.mark.parametrize("mode,pallas", [("auto", False), ("auto", True),
                                         ("csr", False)],
                         ids=["dense_bmm", "dense_kernel", "csr"])
def test_quantify_reaches_the_maximum(mode, pallas):
    """``quantify_sample``'s default gain on ``_study``: every loop stops
    on a real gain (the JAX-equal mode's dense loop on NaN and its polish
    at its 200-cycle cap), logL no lower than the JAX-equal mode's and the
    JAX package's less rel 1e-9, and logL (rel 1e-9) and gene TPM (rel
    1e-3 of max(TPM, 1)) those of the JAX package's maximum: its solution
    run on by its own f64 polish to a 1e-12 gain."""
    idx, (counts,) = _study(1)
    cfg = dict(verbose=0, solver_mode=mode, solver_pallas=pallas,
               rng_seed=2)
    got = {}
    for gain in ("jax", "repaired"):
        timing.reset_phases()
        got[gain] = tquant.quantify_sample(
            idx, counts, QuantConfig(**cfg, solver_gain=gain), CPU)
        stops = [s.attrs["stop"] for s in timing.spans()
                 if s.name in ("solve: dense batch", "solve: csr",
                               "solve: polish")]
        if gain == "repaired":
            assert set(stops) <= {"converged", "eps"}, stops
        elif mode == "auto":
            assert "nan" in stops and "cap" in stops, stops
    timing.reset_phases()
    want = jquant.quantify_sample(idx, counts, JaxQuantConfig(**cfg))
    x = tquant.prepare_sample(idx, counts, QuantConfig(**cfg))
    problem = tsolver.build_problem(x.graph, x.modules, x.eumaps,
                                    x.read_count)
    best = jsolver.polish_host_f64(problem, want.fpkm.copy(), 1e-12, 100000)
    ll, ll_jax, ll_want, ll_best = (tquant._host_loglik(problem, f) for f in (
        got["repaired"].fpkm, got["jax"].fpkm, want.fpkm, best))
    for other in (ll_jax, ll_want):
        assert ll - other >= -1e-9 * abs(other), (ll, other)
    assert abs(ll - ll_best) <= 1e-9 * abs(ll_best), (ll, ll_best)
    tg, tb = (_gene_tpm(idx, f) for f in (got["repaired"].fpkm, best))
    assert (np.abs(tg - tb) / np.maximum(tb, 1.0)).max() <= 1e-3


def test_batched_matches_the_loop_per_sample():
    """The batched multisample solve (``quantify_samples_batched``, the
    default gain) on 4 of ``_study``'s samples: each sample's logL that of
    its own ``quantify_sample`` at solver tolerance (rel 1e-9), and no
    NaN stop in its loop."""
    idx, counts = _study(4, seed=4)
    cfg = QuantConfig(verbose=0, min_fraglength=idx.min_fraglength,
                      max_fraglength=idx.max_fraglength)
    timing.reset_phases()
    got = tquant.quantify_samples_batched(idx, counts, cfg, CPU)
    stop, = (s.attrs["stop"] for s in timing.spans()
             if s.name == "solve: sharded loop")
    assert stop == "converged"
    for c, g in zip(counts, got):
        x = tquant.prepare_sample(idx, c, cfg)
        problem = tsolver.build_problem(x.graph, x.modules, x.eumaps,
                                        x.read_count)
        alone = tquant.quantify_sample(idx, c, cfg, CPU)
        ll_b, ll_a = (tquant._host_loglik(problem, r.fpkm)
                      for r in (g, alone))
        assert abs(ll_b - ll_a) <= 1e-9 * abs(ll_a), (ll_b, ll_a)
    timing.reset_phases()


@pytest.mark.parametrize("skip", [False, True], ids=["jax", "repaired"])
def test_restart_rounds_on_the_kernel(skip):
    """The dense restart rounds on the hand kernel (the card's route for
    the one-warp classes, ``dense.kernel_route``) against torch.bmm's
    ``_solve_loop`` from the same starts: the same blocks and stop, the
    rounds' intensities within rtol 1e-9."""
    case = Case("restarts", "stop")
    out = []
    for pallas in (False, True):
        th = tdense.solve_dense_restarts(case.batch, case.theta0, 1e-9, CPU,
                                         2, 2048, skip, pallas)
        out.append((th, loop.LAST.stop, loop.LAST.blocks_run))
    assert out[0][1:] == out[1][1:] and out[0][1] == "converged"
    db = tdense.batch_to_device(case.batch, CPU, torch.float64)
    s_bmm, s_kernel = (tdense._mt(db.m, torch.as_tensor(th))
                       for th, _, _ in out)
    torch.testing.assert_close(s_kernel, s_bmm, rtol=1e-9, atol=1e-12)


def test_kernel_route_by_shape():
    """The hand kernel is the card's route for the one-warp classes alone,
    and never the CPU's."""
    for (C, T) in tdense.SIZE_CLASSES:
        batch = dataclasses.replace(Case("dense", "stop").batch,
                                    shape=(8, C, T))
        assert not tdense.kernel_route(batch, CPU)
        assert tdense.kernel_route(batch, torch.device("cuda")) is \
            ((C, T) in ((32, 8), (64, 16)))
