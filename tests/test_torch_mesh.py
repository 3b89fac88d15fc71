"""The port's sharded multisample EM (``emsar_tpu_torch/parallel/mesh.py``)
against the JAX package's on the CPU: the three scenarios of
``tests/test_mesh.py`` in both layouts, the port in gloo worlds of 1, 2
and 4 processes arranged as (dp, tp), the JAX package on the 8-device CPU
mesh of ``tests/conftest.py`` at the same (dp, tp).

Tolerances: theta within rtol 1e-8 / atol 1e-8 of the JAX single-device
solve and of its sharded solve, logL within rel 1e-9 (the partial sums of
tp > 1 are all-reduced in another order than one device sums them); the
multisample scenario at ``test_mesh.py``'s own (per-sample logL rel 1e-8,
intensities rtol 2e-3: quasi-flat directions of collinear isoforms).  A
second solve at the same world size repeats the bits, and every rank
holds the same theta."""

import numpy as np
import pytest
import torch

from emsar_tpu.model.solver import SolverProblem as JaxSolverProblem
from emsar_tpu.model.solver import solve as jax_solve
from emsar_tpu.parallel import mesh as jax_mesh
from emsar_tpu_torch.model.solver import SolverProblem, gain_of
from emsar_tpu_torch.parallel import mesh as tmesh
from tests.test_mesh import _toy_problem
from tests.torch_dist_workers import card_checks, mesh_solves, run_world

CPU = torch.device("cpu")
torch.set_num_threads(1)
CONFIGS = [(1, 1), (1, 2), (2, 1), (2, 2), (1, 4)]
LAYOUTS = ["edges", "transcript"]
SCENARIOS = ["single", "transcript", "multisample"]


def _scenario(name, dp):
    """(JAX SolverProblem, reads [S, C]) of one test_mesh.py scenario: the
    problem's own reads once per dp rank (seed 0 and seed 3), or four
    permutations of them (seed 1)."""
    seed = {"single": 0, "transcript": 3, "multisample": 1}[name]
    problem, _ = _toy_problem(seed=seed)
    if name == "multisample":
        rng = np.random.default_rng(2)
        return problem, np.stack([rng.permutation(problem.reads)
                                  for _ in range(4)])
    return problem, np.repeat(problem.reads[None, :].astype(np.float64), dp,
                              axis=0)


def _port_problem(problem):
    return SolverProblem(**{k: np.asarray(v) for k, v in
                            problem.__dict__.items()
                            if k != "n_transcripts"},
                         n_transcripts=problem.n_transcripts)


@pytest.fixture(scope="module", params=CONFIGS,
                ids=[f"dp{d}_tp{t}" for d, t in CONFIGS])
def world(request, tmp_path_factory):
    """((dp, tp), {case: (theta, ll, blocks) of each run, per rank}) of
    every scenario and layout, solved in one world of dp x tp processes."""
    dp, tp = request.param
    cases = {}
    for name in SCENARIOS:
        problem, reads = _scenario(name, dp)
        for layout in LAYOUTS:
            cases[f"{name}/{layout}"] = (_port_problem(problem), reads,
                                         layout)
    out = tmp_path_factory.mktemp(f"mesh_dp{dp}_tp{tp}")
    run_world(mesh_solves, dp * tp, dp, cases, str(out))
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(dp * tp)]
    return (dp, tp), ranks


@pytest.fixture(scope="module")
def jax_single():
    """{scenario: (theta per sample, logL per sample)} of the JAX package's
    single-device solve."""
    out = {}
    for name in SCENARIOS:
        problem, reads = _scenario(name, 1)
        if name != "multisample":
            fpkm, ll, _ = jax_solve(problem, epsilon=1e-12)
            out[name] = ([fpkm], [ll])
            continue
        fits = [jax_solve(type(problem)(**{**problem.__dict__,
                                          "reads": r}), epsilon=1e-12)
                for r in reads]
        out[name] = ([f[0] for f in fits], [f[1] for f in fits])
    return out


def _seg_intensity(problem, theta):
    s = np.zeros(len(problem.eumaps))
    np.add.at(s, problem.edge_cid, problem.edge_mult * theta[problem.edge_tid])
    return s


def _loglik(problem, theta, reads):
    lam = problem.eumaps * _seg_intensity(problem, theta)
    m = lam > 0
    assert not ((~m) & (reads > 0)).any()
    return float(np.sum(reads[m] * np.log(lam[m]) - lam[m]))


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_matches_jax(world, jax_single, layout, scenario):
    (dp, tp), ranks = world
    key = f"{scenario}/{layout}"
    theta = ranks[0][f"{key}/first/theta"]
    ll = float(ranks[0][f"{key}/first/ll"])
    problem, reads = _scenario(scenario, dp)
    S = reads.shape[0]
    assert theta.shape == (S, problem.n_transcripts)
    assert int(ranks[0][f"{key}/first/it"]) >= 1
    jmesh = jax_mesh.make_mesh(dp * tp, dp=dp)
    jsp = jax_mesh.shard_problem(problem, reads, jmesh, dtype=np.float64,
                                 shard_by=layout)
    j_theta, j_ll, _ = jax_mesh.solve_sharded(jsp, epsilon=1e-12)
    assert abs(ll - j_ll) <= 1e-9 * abs(j_ll), (ll, j_ll)
    fpkms, lls = jax_single[scenario]
    if scenario != "multisample":
        for s in range(S):
            np.testing.assert_allclose(theta[s], fpkms[0], rtol=1e-8,
                                       atol=1e-8)
            np.testing.assert_allclose(theta[s], j_theta[s], rtol=1e-8,
                                       atol=1e-8)
        assert abs(ll - lls[0] * S) <= 1e-9 * abs(lls[0]) * S
        return
    for s in range(S):
        ll_ref = _loglik(problem, fpkms[s], reads[s])
        for th in (theta[s], j_theta[s]):
            ll_sh = _loglik(problem, th, reads[s])
            assert abs(ll_sh - ll_ref) <= 1e-8 * abs(ll_ref), (ll_sh, ll_ref)
        np.testing.assert_allclose(_seg_intensity(problem, theta[s]),
                                   _seg_intensity(problem, fpkms[s]),
                                   rtol=2e-3, atol=1e-2)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_one_cycle_matches_one_process(world, layout):
    """One SQUAREM cycle from the warm start, the step length included
    (its norms span every rank's block of transcripts in the transcript
    layout), matches the cycle of one process to rel 1e-10: only the
    order of the all-reduced partial sums differs."""
    (dp, tp), ranks = world
    for name in SCENARIOS:
        problem, reads = _scenario(name, dp)
        sp = tmesh.shard_problem(_port_problem(problem), reads,
                                 tmesh.make_mesh(device=CPU),
                                 dtype=np.float64,
                                 shard_by=layout)
        want = tmesh.gather_theta(sp, tmesh._squarem_cycle(sp, sp.theta0))
        np.testing.assert_allclose(ranks[0][f"{name}/{layout}/cycle"], want,
                                   rtol=1e-10, atol=1e-12)


def test_same_world_same_bits(world):
    """A second solve at the same world size gives identical bits, and
    every rank returns the same theta, logL and block count."""
    (dp, tp), ranks = world
    for key in ranks[0]:
        if "/first/" not in key:
            assert all(np.array_equal(r[key], ranks[0][key]) for r in ranks)
            continue
        again = key.replace("/first/", "/again/")
        for r in ranks:
            assert np.array_equal(r[key], ranks[0][key]), key
            assert np.array_equal(r[again], ranks[0][key]), again


def _nan_gain_case():
    """(problem fields, reads [2, C]) of two samples whose batch stops on a
    NaN block gain.  Segments {t0, t1}, {t1}, {t2, t3}, {t3}; segment 1
    holds t1 alone at 1e6 times segment 0's EUMAp.  Sample 0 has reads on
    every segment; sample 1 none on segment 1, so its t1 falls ~1e6-fold
    an EM step, segment 1's intensity by more than 1e16 in a block, and
    that segment's gain term is reads * log1p(-1) = 0 * -inf = NaN."""
    cid = np.array([0, 0, 1, 2, 2, 3], np.int32)
    tid = np.array([0, 1, 1, 2, 3, 3], np.int32)
    mult = np.ones(6)
    eumaps = np.array([1.0, 1e6, 1.0, 0.5])
    denom = np.zeros(4)
    np.add.at(denom, tid, mult * eumaps[cid])
    reads = np.array([[100.0, 50.0, 30.0, 10.0], [100.0, 0.0, 30.0, 10.0]])
    return dict(n_transcripts=4, edge_cid=cid, edge_tid=tid, edge_mult=mult,
                eumaps=eumaps, reads=reads[0], denom=denom), reads


NAN_BLOCK_ITERS = 4  # sample 0 alone then needs a second loop block


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dp", [1, 2])
def test_nan_gain_stops_the_batch_as_in_jax(tmp_path, dp, layout):
    """One stop test for the whole batch (JAX's rule): a NaN block gain in
    one sample ends every sample's solve, in both packages at the same
    block, logL and theta; with dp = 2 the NaN reaches the other rank
    through the all-reduced gain.  Sample 0 alone runs on."""
    fields, reads = _nan_gain_case()
    problem = SolverProblem(**fields)
    sp = tmesh.shard_problem(problem, reads, tmesh.make_mesh(device=CPU),
                             dtype=np.float64, shard_by=layout)
    th, s, _ = tmesh._block(sp, sp.theta0, NAN_BLOCK_ITERS)
    _, s_next, _ = tmesh._block(sp, th, NAN_BLOCK_ITERS)
    gains = gain_of(sp.reads, sp.eumaps, s, s_next).numpy()
    assert gains[0] >= 1e-12 and np.isnan(gains[1]), gains

    run_world(mesh_solves, dp, dp, {"nan": (problem, reads, layout)},
              str(tmp_path), NAN_BLOCK_ITERS)
    theta, ll, it = (np.load(tmp_path / "rank0.npz")[f"nan/first/{k}"]
                     for k in ("theta", "ll", "it"))
    jmesh = jax_mesh.make_mesh(dp, dp=dp)
    j_theta, j_ll, j_it = jax_mesh.solve_sharded(
        jax_mesh.shard_problem(JaxSolverProblem(**fields), reads, jmesh,
                               dtype=np.float64, shard_by=layout),
        epsilon=1e-12, block_iters=NAN_BLOCK_ITERS)
    assert int(it) == j_it == 1
    assert abs(float(ll) - j_ll) <= 1e-9 * abs(j_ll), (ll, j_ll)
    np.testing.assert_allclose(theta, j_theta, rtol=1e-8, atol=1e-8)

    alone = tmesh.shard_problem(problem, reads[:1], tmesh.make_mesh(
        device=CPU), dtype=np.float64, shard_by=layout)
    j_alone = jax_mesh.shard_problem(JaxSolverProblem(**fields), reads[:1],
                                     jax_mesh.make_mesh(1), dtype=np.float64,
                                     shard_by=layout)
    assert (tmesh.solve_sharded(alone, epsilon=1e-12,
                                block_iters=NAN_BLOCK_ITERS)[2]
            == jax_mesh.solve_sharded(j_alone, epsilon=1e-12,
                                      block_iters=NAN_BLOCK_ITERS)[2] == 2)


def test_make_mesh_defaults_to_the_run_device(monkeypatch):
    """With no device named, the mesh is on this process's device from
    ``EMSAR_TORCH_DEVICE`` (default cuda, which raises without a card):
    never quietly on the host."""
    monkeypatch.setenv("EMSAR_TORCH_DEVICE", "cpu")
    assert tmesh.make_mesh().device == CPU
    if not torch.cuda.is_available():
        monkeypatch.delenv("EMSAR_TORCH_DEVICE")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()


def test_cuda_mesh_needs_a_card_a_rank(tmp_path):
    """Two ranks of a CUDA mesh on one card are refused before any NCCL
    group forms; a card each passes."""
    run_world(card_checks, 2, str(tmp_path))
    for r in range(2):
        shared = str(np.load(tmp_path / f"rank{r}.npz")["shared"])
        assert "one card a process" in shared, shared
