"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  These need an NVIDIA GPU with nvcc and skip elsewhere (a CUDA
kernel has no interpret mode).  This file imports neither JAX nor
``emsar_tpu``, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from emsar_tpu_torch.index.device_build import DeviceRef
from emsar_tpu_torch.io.fasta import build_transcriptome
from emsar_tpu_torch.kernels import segment_sum as ssum
from emsar_tpu_torch.kernels import squarem, window_hash
from emsar_tpu_torch.kernels.check import (block_agreement, block_tol,
                                           random_modules)
from emsar_tpu_torch.model import solver
from emsar_tpu_torch.model.dense import SIZE_CLASSES
from emsar_tpu_torch.sim import gene_family_transcriptome

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B", [64, 7, 1])
@pytest.mark.parametrize("n_iters", [1, 8], ids=["cycle", "block"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("C,T", SIZE_CLASSES,
                         ids=[f"{c}x{t}" for c, t in SIZE_CLASSES])
def test_squarem_kernel_matches_plain(cuda, C, T, dtype, n_iters, B):
    """Every class and dtype; B = 7 leaves the last block of the one-warp
    classes (four modules per block) ragged, and B = 1 and 7 carry inert
    pad rows (E = R = 0, no membership) as the padded classes do."""
    rng = np.random.default_rng(C + T + B)
    args = [torch.as_tensor(a).to(cuda, dtype)
            for a in random_modules(rng, B, C, T)]
    if B < 64:
        for a in args[:3]:
            a[:, C - 5:] = 0
    before = squarem.LAUNCHES
    got = squarem.squarem_block(*args, n_iters)
    torch.cuda.synchronize()
    assert squarem.LAUNCHES == before + 1
    want = squarem.squarem_block_ref(*args, n_iters)
    err, _, n = block_agreement(got, want, *args, n_iters)
    assert n >= max(1, B // 2)
    assert err <= block_tol(dtype, n_iters), err


def test_squarem_kernel_rejects_mixed_inputs(cuda):
    rng = np.random.default_rng(0)
    args = [torch.as_tensor(a).to(cuda) for a in random_modules(rng, 4, 32, 8)]
    args[1] = args[1].float()
    with pytest.raises(ValueError, match="eumaps"):
        squarem.squarem_block(*args, 8)
    with pytest.raises(ValueError, match="contiguous"):
        squarem.squarem_block(args[0].transpose(1, 2).contiguous()
                              .transpose(1, 2), *[a.double() for a in
                                                  args[1:]], 8)


# window starts per thread block of csrc/window_hash.cu (kTile)
TILE = 2048


def _hash_ref(rng, n_genes, cuda, tile_edge_n=False):
    """A gene-family transcriptome on the card with an N in transcript 3,
    a transcript shorter than most read lengths, one of 3,000 random bases
    that shares 1,100 of them with another (windows up to rl = 1024), and,
    with ``tile_edge_n``, N bases on both sides of the first tile edge."""
    names, seqs, _ = gene_family_transcriptome(rng, n_genes)
    seqs[3] = seqs[3][:50] + b"N" + seqs[3][51:]
    a, b = (bytes(rng.choice(list(b"ACGT"), 3000).tolist()) for _ in "ab")
    names += ["short", "long_a", "long_b"]
    seqs += [b"ACGTTGCAAC", a, b[:1500] + a[100:1200] + b[2600:]]
    if tile_edge_n:
        start = 0
        for k, s in enumerate(seqs):
            if start < TILE <= start + len(s) - 2:
                p = TILE - start - 1
                seqs[k] = s[:p] + b"NN" + s[p + 2:]
                break
            start += len(s) + 1
    return DeviceRef(build_transcriptome(names, seqs), cuda)


def _window_hash_bit_equal(ref, rl, unstranded):
    n = ref.borderpos - rl + 1
    args = (ref.codes, ref.tid_forward(n), ref.borderpos, ref.seqlength, rl,
            unstranded)
    before = window_hash.LAUNCHES
    got = window_hash.window_hash(*args)
    torch.cuda.synchronize()
    assert window_hash.LAUNCHES == before + 1
    want = window_hash.window_hash_ref(*args)
    assert (got[3] >= 0).any() and (got[3] < 0).any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return n


@pytest.mark.parametrize("unstranded", [True, False], ids=["ns", "ss"])
@pytest.mark.parametrize("rl", [1, 15, 16, 17, 20, 32, 33, 64, 76, 1024])
def test_window_hash_kernel_bit_equal(cuda, rl, unstranded):
    """Many tiles, the last one ragged, N bases across a tile edge."""
    ref = _hash_ref(np.random.default_rng(rl), 40, cuda, tile_edge_n=True)
    n = _window_hash_bit_equal(ref, rl, unstranded)
    assert n > 4 * TILE and n % TILE != 0


@pytest.mark.parametrize("unstranded", [True, False], ids=["ns", "ss"])
@pytest.mark.parametrize("rl", [16, 76])
def test_window_hash_kernel_one_short_tile(cuda, rl, unstranded):
    """Fewer windows than one tile."""
    names = ["a", "b", "c"]
    seqs = [b"ACGTTGCAAC", b"ACGTTGCAACGTTGCAACGTNGCAACGTT" * 8,
            b"GGCATTACGA" * 30]
    ref = DeviceRef(build_transcriptome(names, seqs), cuda)
    assert _window_hash_bit_equal(ref, rl, unstranded) < TILE


def _csr(rng, n_seg, n_x, E, long_seg=0):
    """Edges grouped by segment: uniform segments (some empty), idx
    unsorted within a segment, ``long_seg`` more edges in one segment."""
    seg = np.sort(np.concatenate([rng.integers(0, n_seg, E),
                                  np.full(long_seg, n_seg // 2)]))
    off = np.zeros(n_seg + 1, dtype=np.int64)
    np.cumsum(np.bincount(seg, minlength=n_seg), out=off[1:])
    return rng.integers(0, n_x, len(seg)), off


# (segments, entries of x, edges, edges of one long segment): mean edges
# per segment 0.4, 8, 10 and 25 give lanes 4, 8, 16 and 32
CSR_CASES = {"sparse": (5000, 3000, 2000, 0), "long": (1000, 800, 5000, 3000),
             "k16": (5000, 3000, 50000, 0), "k32": (1000, 800, 25000, 0)}


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("case", sorted(CSR_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_segment_sum_kernel_matches_plain(cuda, dtype, case, R):
    """The kernel gives the bits of the plain version on the CPU (the
    sequential ``index_add_``), on every launch."""
    n_seg, n_x, E, long_seg = CSR_CASES[case]
    rng = np.random.default_rng(9)
    idx, off = _csr(rng, n_seg, n_x, E, long_seg)
    E = len(idx)
    x = torch.as_tensor(rng.uniform(0, 10, (R, n_x))).to(cuda, dtype)
    w = torch.as_tensor(rng.integers(1, 3, E) * 1.0).to(cuda, dtype)
    t = [torch.as_tensor(a).to(cuda) for a in (idx, off)]
    before = ssum.LAUNCHES
    a = ssum.segment_sum(x, w, *t)
    b = ssum.segment_sum(x, w, *t)
    torch.cuda.synchronize()
    assert ssum.LAUNCHES == before + 2
    assert torch.equal(a, b)  # no atomics: the same bits every launch
    assert torch.equal(a.cpu(), ssum.segment_sum_ref(
        x.cpu(), w.cpu(), *(u.cpu() for u in t)))


def _random_problem(rng, n_seg, ntid, E):
    key = np.unique(rng.integers(0, n_seg, E) * ntid
                    + rng.integers(0, ntid, E))
    denom = rng.uniform(0.5, 3, ntid)
    denom[rng.random(ntid) < 0.05] = 0.0
    return solver.SolverProblem(
        n_transcripts=ntid, edge_cid=(key // ntid).astype(np.int32),
        edge_tid=(key % ntid).astype(np.int32),
        edge_mult=rng.integers(1, 3, len(key)).astype(np.float64),
        eumaps=rng.uniform(0.1, 2, n_seg), reads=rng.poisson(3, n_seg) * 1.0,
        denom=denom)


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_em_step_matches_cpu_em_iter(cuda, dtype, R):
    """em_step on the card gives the bits of the CPU ``_em_iter``, also
    with zero thetas (segments of zero intensity) and read-less
    segments."""
    rng = np.random.default_rng(R)
    problem = _random_problem(rng, 3000, 1200, 12000)
    theta = rng.uniform(0, 10, (R, problem.n_transcripts))
    theta[:, rng.random(problem.n_transcripts) < 0.2] = 0.0
    p_gpu = solver.problem_to_device(problem, cuda, dtype)
    p_cpu = solver.problem_to_device(problem, torch.device("cpu"), dtype)
    th = torch.as_tensor(theta).to(dtype)
    before = ssum.EM_LAUNCHES
    got = solver._em_iter(p_gpu, th.to(cuda))
    torch.cuda.synchronize()
    assert ssum.EM_LAUNCHES == before + 2
    assert torch.equal(got.cpu(), solver._em_iter(p_cpu, th))
