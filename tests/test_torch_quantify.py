"""``quantify_sample`` of the port against the JAX package's, on an
``emsar_tpu``-built index with Poisson counts: logL, the total inferred
read count, segment intensities, and every restart round's intensities
(the inits are the same NumPy draws in both packages)."""

import numpy as np
import pytest
import torch

from emsar_tpu.config import BuildConfig, QuantConfig
from emsar_tpu.index.build import build_se_index
from emsar_tpu.ingest.collapse import SampleCounts
from emsar_tpu.io.fasta import build_transcriptome
from emsar_tpu.model import quantify as jquant
from emsar_tpu.model.solver import build_problem
from emsar_tpu.sim import gene_family_transcriptome
from emsar_tpu_torch.model import quantify as tquant

CPU = torch.device("cpu")
# test workers share the machine's cores: one intra-op thread each keeps
# the many tiny torch ops of the EM loops from oversubscribing them
torch.set_num_threads(1)


def _fixture(seed):
    rng = np.random.default_rng(seed)
    names, seqs, _ = gene_family_transcriptome(rng, 20, n_exons=5,
                                               min_exon=40, max_exon=120)
    tx = build_transcriptome(names, seqs)
    idx = build_se_index(tx, 20, 20, BuildConfig(verbose=0))
    counts = SampleCounts(
        single_counts=rng.poisson(idx.single_euma[:, 0] * 2.0),
        multi_counts=rng.poisson(idx.multi_euma[:, 0] * 2.0),
        fraglength_counts=np.bincount([20], minlength=401) * 1000,
        total_read_count=1000)
    return idx, counts


def _segment_intensity(result, theta):
    """E * (M theta) over every active segment of the result's graph."""
    eumaps = result.adj_euma / 1e3 * (result.total_read_count / 1e6)
    p = build_problem(result.graph, result.modules, eumaps,
                      result.graph.read_count)
    s = np.zeros(len(p.eumaps))
    np.add.at(s, p.edge_cid, p.edge_mult * theta[p.edge_tid])
    return p.eumaps * s


# the default epsilon stops the solve at a 1e-9 block gain; a segment with
# R reads then sits about sqrt(2e-9 / R) from its optimum intensity
INTENSITY_RTOL = 1e-5
# restart rounds stop at the restart epsilon (1e-3 likelihood gain per
# block), so two summation orders may stop a block apart; intensities then
# differ by at most what one block moves at that gain
RESTART_RTOL = 1e-4


@pytest.mark.parametrize("mode,pallas", [("auto", False), ("auto", True),
                                         ("csr", False)],
                         ids=["dense_bmm", "dense_kernel", "csr"])
def test_quantify_sample_matches_jax(mode, pallas):
    idx, counts = _fixture(3)
    cfg = dict(verbose=0, solver_mode=mode, rng_seed=2)
    want = jquant.quantify_sample(idx, counts,
                                  QuantConfig(**cfg, solver_pallas=False))
    got = tquant.quantify_sample(idx, counts,
                                 QuantConfig(**cfg, solver_pallas=pallas),
                                 CPU)
    assert abs(got.loglik - want.loglik) <= 1e-9 * abs(want.loglik)
    np.testing.assert_array_equal(got.ieuma, want.ieuma)
    np.testing.assert_array_equal(got.adj_euma, want.adj_euma)
    np.testing.assert_array_equal(got.modules.cs, want.modules.cs)
    irc_w = (want.ieuma / 1e3) * want.fpkm * (want.total_read_count / 1e6)
    irc_g = (got.ieuma / 1e3) * got.fpkm * (got.total_read_count / 1e6)
    np.testing.assert_allclose(irc_g.sum(), irc_w.sum(), rtol=1e-9)
    np.testing.assert_allclose(_segment_intensity(got, got.fpkm),
                               _segment_intensity(want, want.fpkm),
                               rtol=INTENSITY_RTOL, atol=1e-10)
    assert got.fpkm_rounds.shape == want.fpkm_rounds.shape == (4, len(irc_w))
    for r in range(1, 4):
        np.testing.assert_allclose(
            _segment_intensity(got, got.fpkm_rounds[r]),
            _segment_intensity(want, want.fpkm_rounds[r]),
            rtol=RESTART_RTOL, atol=1e-8)


def test_restart_rounds_spread_on_collinear_isoforms():
    """sd.of.FPKM comes from the restart spread: rounds differ from round 0
    somewhere (non-identifiable isoform splits), as in the JAX package."""
    idx, counts = _fixture(4)
    got = tquant.quantify_sample(idx, counts, QuantConfig(verbose=0), CPU)
    want = jquant.quantify_sample(idx, counts, QuantConfig(verbose=0))
    spread_g = np.abs(got.fpkm_rounds[1:] - got.fpkm_rounds[0]).max()
    spread_w = np.abs(want.fpkm_rounds[1:] - want.fpkm_rounds[0]).max()
    assert spread_w > 0
    np.testing.assert_allclose(spread_g, spread_w, rtol=1e-3)


def test_float32_solve_polishes_to_the_f64_optimum():
    idx, counts = _fixture(5)
    want = jquant.quantify_sample(idx, counts, QuantConfig(verbose=0))
    got = tquant.quantify_sample(
        idx, counts, QuantConfig(verbose=0, solver_dtype="float32"), CPU)
    assert abs(got.loglik - want.loglik) <= 1e-9 * abs(want.loglik)


def test_prepare_sample_gives_the_solved_problem():
    idx, counts = _fixture(6)
    cfg = QuantConfig(verbose=0)
    res = tquant.quantify_sample(idx, counts, cfg, CPU)
    x = tquant.prepare_sample(idx, counts, cfg)
    np.testing.assert_array_equal(x.adj_euma, res.adj_euma)
    problem = build_problem(x.graph, x.modules, x.eumaps, x.read_count)
    assert tquant._host_loglik(problem, res.fpkm) == pytest.approx(
        res.loglik, rel=1e-12)
