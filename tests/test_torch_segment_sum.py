"""``kernels.segment_sum`` on the CPU: the checks ``prepare`` makes once per
problem, the lanes it picks, and ``em_step``'s plain version against the
torch body of the CSR EM step it replaced (``_em_iter`` before the kernel
took the step)."""

import numpy as np
import pytest
import torch

from emsar_tpu_torch.kernels import segment_sum as ss
from emsar_tpu_torch.model import solver as tsolver
from tests.test_torch_kernels_cuda import _random_problem

CPU = torch.device("cpu")
torch.set_num_threads(1)


def _em_iter_body(p, theta):
    """The CSR EM step as the solver computed it before ``em_step``."""
    s = tsolver._intensities(p, theta)
    pos = s > 0
    ratio = torch.where(pos, p.reads / torch.where(pos, s, 1.0), 0.0)
    num = tsolver._segment_sum(p.by_tid, ratio)
    return theta * num * p.inv_denom


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_em_step_plain_is_the_em_iter_body(dtype, R):
    rng = np.random.default_rng(R)
    problem = _random_problem(rng, 300, 120, 2000)
    p = tsolver.problem_to_device(problem, CPU, dtype)
    theta = rng.uniform(0, 10, (R, problem.n_transcripts))
    theta[:, rng.random(problem.n_transcripts) < 0.2] = 0.0
    theta = torch.as_tensor(theta).to(dtype)
    want = _em_iter_body(p, theta)
    args = (p.by_cid, p.by_tid, p.reads, p.inv_denom)
    assert torch.equal(ss.em_step_ref(theta, *args), want)
    assert torch.equal(ss.em_step(theta, *args), want)
    assert torch.equal(tsolver._em_iter(p, theta), want)


def test_prepare_converts_and_picks_lanes():
    problem = _random_problem(np.random.default_rng(0), 300, 120, 2000)
    p = tsolver.problem_to_device(problem, CPU, torch.float64)
    for g, n_x in ((p.by_cid, problem.n_transcripts),
                   (p.by_tid, len(problem.eumaps))):
        assert g.idx.dtype == torch.int32 and g.offsets.dtype == torch.int64
        assert g.n_x == n_x and g.n_groups + 1 == g.offsets.shape[0]
        assert g.lanes == ss.lanes_for(g.idx.shape[0], g.n_groups)
    assert [ss.lanes_for(E, 10) for E in (0, 10, 40, 41, 80, 81, 160, 10**6)
            ] == [4, 4, 4, 8, 8, 16, 16, 32]


def _groups():
    off = torch.tensor([0, 2, 2, 5])
    idx = torch.tensor([1, 0, 3, 3, 2])
    return off, idx, torch.ones(5, dtype=torch.float64)


@pytest.mark.parametrize("fault", [
    "offsets_start", "offsets_end", "offsets_fall", "idx_high", "idx_low",
    "idx_dtype", "mult_dtype", "mult_length", "offsets_dtype"])
def test_prepare_rejects(fault):
    off, idx, w = _groups()
    n_x = 4
    if fault == "offsets_start":
        off = torch.tensor([1, 2, 2, 5])
    elif fault == "offsets_end":
        off = torch.tensor([0, 2, 2, 4])
    elif fault == "offsets_fall":
        off = torch.tensor([0, 3, 2, 5])
    elif fault == "idx_high":
        n_x = 3
    elif fault == "idx_low":
        idx = torch.tensor([1, 0, -1, 3, 2])
    elif fault == "idx_dtype":
        idx = idx.to(torch.int16)
    elif fault == "mult_dtype":
        w = w.to(torch.float16)
    elif fault == "mult_length":
        w = w[:4]
    else:
        off = off.to(torch.int32)
    with pytest.raises(ValueError):
        ss.prepare(off, idx, w, n_x)


def test_segment_sum_wrapper_on_cpu_is_the_plain_version():
    off, idx, w = _groups()
    x = torch.arange(8, dtype=torch.float64).reshape(2, 4)
    got = ss.segment_sum(x, w, idx, off)
    assert torch.equal(got, torch.tensor([[1.0, 0.0, 8.0], [9.0, 0.0, 20.0]]))
    assert torch.equal(ss.sum_groups(x, ss.prepare(off, idx, w, 4)), got)
    with pytest.raises(ValueError, match="contiguous"):
        ss.segment_sum(x.T, w, idx, off)


def test_tile_bounds_cut_the_groups():
    """Tiles of consecutive groups: every group in one tile, at most
    ``tile`` groups a tile and fewer than ``tile`` edges before a tile's
    last group; a group longer than a tile leaves tiles empty; no groups,
    one empty tile."""
    sizes = np.array([3, 0, 1, 40, 2, 2, 0, 0, 5, 1, 1, 17, 0, 3])
    off = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)]))
    for tile in (4, 8, 16, 512):
        b, e = ss.tile_bounds(off, tile).numpy()
        assert (e == off.numpy()[b]).all()
        assert b[0] == 0 and b[-1] == len(sizes)
        assert (np.diff(b) >= 0).all() and (np.diff(b) <= tile).all()
        for s0, s1 in zip(b[:-1], b[1:]):
            if s1 > s0:
                assert off[s1 - 1] - off[s0] < tile
        assert len(b) - 1 == max(1, -(-(int(off[-1]) + len(sizes)) // tile))
    assert (np.diff(ss.tile_bounds(off, 4)[0].numpy()) == 0).any()
    assert ss.tile_bounds(torch.zeros(1, dtype=torch.int64), 8).tolist() == [
        [0, 0], [0, 0]]
    g = ss.prepare(off, torch.zeros(int(off[-1]), dtype=torch.int64),
                   torch.ones(int(off[-1]), dtype=torch.float64), 1)
    assert torch.equal(g.tiles, ss.tile_bounds(off, ss.TILE))
