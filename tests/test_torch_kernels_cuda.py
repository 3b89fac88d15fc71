"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  These need an NVIDIA GPU with nvcc and skip elsewhere (a CUDA
kernel has no interpret mode).  This file imports neither JAX nor
``emsar_tpu``, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from emsar_tpu_torch.bench import cluster_sweep
from emsar_tpu_torch.index.device_build import DeviceRef
from emsar_tpu_torch.index.device_build_pe import rank_pass
from emsar_tpu_torch.io.fasta import build_transcriptome
from emsar_tpu_torch.kernels import csr_cluster, csr_cycle
from emsar_tpu_torch.kernels import pe_candidates as kpe
from emsar_tpu_torch.kernels import segment_sum as ssum
from emsar_tpu_torch.kernels import squarem, window_hash
from emsar_tpu_torch.kernels.check import (block_agreement, block_tol,
                                           random_modules)
from emsar_tpu_torch.model import solver
from emsar_tpu_torch.model.dense import SIZE_CLASSES
from emsar_tpu_torch.sim import gene_family_transcriptome
from torch_loop_cases import gain_branch_cases, torch_body_cycle

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


@pytest.mark.parametrize("R", [3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_em_step_per_sample_operands_match_cpu(cuda, dtype, R):
    """em_step with reads [R, C] and inv_denom [R, ntid], a row each (the
    batched multisample solve), gives the bits of its plain version on
    the CPU, on two calls; an operand of another shape is refused."""
    rng = np.random.default_rng(R + 7)
    problem = _random_problem(rng, 3000, 1200, 12000)
    C, T = len(problem.eumaps), problem.n_transcripts
    theta = rng.uniform(0, 10, (R, T))
    theta[:, rng.random(T) < 0.2] = 0.0
    reads = rng.poisson(3, (R, C)) * 1.0
    inv_denom = rng.uniform(0.2, 2, (R, T)) * (rng.random((R, T)) < 0.95)
    p_gpu = solver.problem_to_device(problem, cuda, dtype)
    p_cpu = solver.problem_to_device(problem, torch.device("cpu"), dtype)
    th, rd, inv = (torch.as_tensor(a).to(dtype)
                   for a in (theta, reads, inv_denom))
    before = ssum.EM_LAUNCHES
    got = [ssum.em_step(th.to(cuda), p_gpu.by_cid, p_gpu.by_tid,
                        rd.to(cuda), inv.to(cuda)) for _ in range(2)]
    torch.cuda.synchronize()
    assert ssum.EM_LAUNCHES == before + 4
    want = ssum.em_step_ref(th, p_cpu.by_cid, p_cpu.by_tid, rd, inv)
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0].cpu(), want)
    with pytest.raises(ValueError, match="reads"):
        ssum.em_step(th.to(cuda), p_gpu.by_cid, p_gpu.by_tid,
                     rd[:1].to(cuda), inv.to(cuda))


@pytest.mark.parametrize("nfl", [1, 11, 400])
@pytest.mark.parametrize("d0", [0, 189])
@pytest.mark.parametrize("unstranded", [True, False], ids=["ns", "ssfr"])
def test_pe_candidates_kernel_bit_equal(cuda, unstranded, d0, nfl):
    """Over every member of a gene-family PE build at l101 (both halves
    when unstranded), with the last window start and the last position
    (past the tid table) appended as a cluster of their own: the written
    keys and payloads, their count and the singleton counts equal the
    plain version's, on the whole and on a chunk that cuts clusters.
    Tandem repeats put one mate2 rank in several slots of singleton rows,
    which are dropped."""
    rl = 101
    names, seqs, _ = gene_family_transcriptome(
        np.random.default_rng(nfl + d0), 20)
    seqs[3] = seqs[3][:50] + b"N" + seqs[3][51:]
    for i in range(0, len(seqs), 3):
        k = 250 + 37 * i
        seqs[i] = seqs[i][:k] + b"ACGTTG" * 30 + seqs[i][k:]
    ref = DeviceRef(build_transcriptome(names, seqs), cuda)
    t32, nsep = ref.t32(rl), ref.nsep()
    R, spos, srank = rank_pass(ref, t32, rl, unstranded, 0)
    RF = R.flip(0).contiguous() if unstranded else None
    spos = torch.cat([spos, torch.tensor(
        [ref.seqlength - rl, ref.seqlength], dtype=torch.int32,
        device=cuda)])
    srank = torch.cat([srank, torch.tensor([1 << 29, 1 << 29],
                                           dtype=torch.int32, device=cuda)])
    n = spos.shape[0]
    tn = kpe.pack_tables(t32, nsep)
    for lo, hi in ((0, n), (n // 3 + 1, n - 5)):
        start = torch.arange(len(names) * nfl, device=cuda) % 3
        single, want_single = start.clone(), start.clone()
        args = (spos, srank, lo, hi, R, RF, tn, d0, nfl, rl, ref.borderpos,
                ref.seqlength, unstranded)
        before = kpe.LAUNCHES
        got = kpe.pe_candidates(*args, single)
        torch.cuda.synchronize()
        assert kpe.LAUNCHES == before + 1
        want = kpe.pe_candidates_ref(*args, want_single)
        assert want[0].shape[0] > 0 and (want_single != start).any()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(single, want_single)
        grid = kpe.pe_candidate_grid_ref(spos[lo:hi], srank[lo:hi], R, RF,
                                         t32, nsep, *args[7:])[0]
        sng = kpe.singleton_members(srank, lo, hi)
        valid = int((grid.view(-1, nfl)[sng] != kpe.INVALID_KEY).sum())
        assert (valid > int((single - start).sum())) == (nfl > 1)


def _cycle_inputs(rng, R, dtype, dev):
    """(DeviceProblem on ``dev``, the same on the CPU, theta [R, ntid] on
    the CPU) of a random problem: at R 16 with reads, EUMAps and 1 / denom
    a row each (the batched solve), else one row shared; theta's last row
    all zero when R > 1 (r = v = 0: alpha -1)."""
    problem = _random_problem(rng, 3000, 1200, 12000)
    C, T = len(problem.eumaps), problem.n_transcripts
    ps = [solver.problem_to_device(problem, d, dtype)
          for d in (dev, torch.device("cpu"))]
    if R == 16:
        reads = torch.as_tensor(rng.poisson(3, (R, C)) * 1.0).to(dtype)
        eumaps = torch.as_tensor(rng.uniform(0.1, 2, (R, C))).to(dtype)
        inv = torch.as_tensor(rng.uniform(0.2, 2, (R, T))
                              * (rng.random((R, T)) < 0.95)).to(dtype)
        ps = [dataclasses.replace(p, reads=reads.to(p.reads.device),
                                  eumaps=eumaps.to(p.reads.device),
                                  inv_denom=inv.to(p.reads.device))
              for p in ps]
    theta = rng.uniform(0, 10, (R, T))
    theta[:, rng.random(T) < 0.2] = 0.0
    if R > 1:
        theta[-1] = 0.0
    return ps[0], ps[1], torch.as_tensor(theta).to(dtype)


@pytest.mark.parametrize("R", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_csr_cycle_kernels_match_plain(cuda, dtype, R):
    """One cycle's pieces on the card, each against its plain version on
    the same inputs, bit for bit: em_step_cycle (t2, r * r, v * v) against
    the CPU's; cycle_extrap, the tiled pair_gain (its intensities against
    sums on the CPU, the gain terms against torch on the card, so CUDA's
    log1p on both sides), block_end and cycle_select against torch on the
    card; two calls equal; the launch counts."""
    rng = np.random.default_rng(R + 31)
    pg, pc, th = _cycle_inputs(rng, R, dtype, cuda)
    thg = th.to(cuda)
    t1 = ssum.em_step(thg, pg.by_cid, pg.by_tid, pg.reads, pg.inv_denom)
    before = ssum.EM_LAUNCHES
    got = ssum.em_step_cycle(t1, thg, pg.by_cid, pg.by_tid, pg.reads,
                             pg.inv_denom)
    torch.cuda.synchronize()
    assert ssum.EM_LAUNCHES == before + 2
    want = ssum.em_step_cycle_ref(t1.cpu(), th, pc.by_cid, pc.by_tid,
                                  pc.reads, pc.inv_denom)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    t2, r_sq, v_sq = got
    rs = torch.sum(r_sq, dim=1, keepdim=True)
    vs = torch.sum(v_sq, dim=1, keepdim=True)
    before = csr_cycle.LAUNCHES
    x = csr_cycle.cycle_extrap(thg, t1, t2, rs, vs)
    assert torch.equal(x, csr_cycle.cycle_extrap(thg, t1, t2, rs, vs))
    assert torch.equal(x, csr_cycle.cycle_extrap_ref(thg, t1, t2, rs, vs))
    cand = ssum.em_step(x, pg.by_cid, pg.by_tid, pg.reads, pg.inv_denom)
    g = pg.by_cid
    s_t2, s_cand = (ssum.segment_sum_ref(a.cpu(), pc.by_cid.mult,
                                         pc.by_cid.idx, pc.by_cid.offsets)
                    .to(cuda) for a in (t2, cand))
    terms = csr_cycle.gain_terms(pg.reads, pg.eumaps, s_t2, s_cand)
    got = csr_cycle.pair_gain(g, pg.reads, pg.eumaps, t2, cand)
    assert torch.equal(got, csr_cycle.pair_gain(g, pg.reads, pg.eumaps, t2,
                                                cand))
    assert torch.equal(got.nan_to_num(), terms.nan_to_num())
    assert torch.equal(torch.isnan(got), torch.isnan(terms))
    got, s_o, s_n = csr_cycle.pair_gain(g, pg.reads, pg.eumaps, t2, cand,
                                        intensities=True)
    assert torch.equal(s_o, s_t2) and torch.equal(s_n, s_cand)
    assert _same(got, terms)
    gain = torch.sum(terms, dim=-1)
    gain[0] = np.nan  # the accept's NaN branch: t2
    out = csr_cycle.cycle_select(gain, cand, t2)
    torch.cuda.synchronize()
    assert torch.equal(out, csr_cycle.cycle_select_ref(gain, cand, t2))
    s_prev = torch.roll(s_t2, 1, dims=1).contiguous()
    end = csr_cycle.block_end(gain, cand, t2, s_t2, s_cand, s_prev, pg.reads,
                              pg.eumaps)
    want = csr_cycle.block_end_ref(gain, cand, t2, s_t2, s_cand, s_prev,
                                   pg.reads, pg.eumaps)
    for a, w in zip(end, want):
        assert _same(a, w)
    assert torch.equal(end[0], out)
    assert csr_cycle.LAUNCHES == before + 7


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_gain_term_kernel_branches(cuda, dtype):
    """The gain term's every branch on one-edge segments (intensities =
    thetas): NaN intensities, died, born, both zero, a read-less collapse
    (0 * log1p(-1) = NaN): pair_gain and block_end give torch's terms on
    the card bit for bit; cycle_extrap keeps a NaN step length and takes
    -1 where vnorm is 0."""
    s_old, s_new, reads, eumaps = gain_branch_cases(dtype, cuda)
    n = s_old.shape[1]
    g = ssum.prepare(torch.arange(n + 1, device=cuda),
                     torch.arange(n, device=cuda),
                     torch.ones(n, dtype=dtype, device=cuda), n)
    want = csr_cycle.gain_terms(reads, eumaps, s_old, s_new)
    assert torch.isnan(want).sum() >= 3 and (want.abs() == 1e30).any()
    ones = torch.ones(s_new.shape[0], dtype=dtype, device=cuda)
    for got in (csr_cycle.pair_gain(g, reads, eumaps, s_old, s_new),
                csr_cycle.block_end(ones, s_new, s_old, s_old, s_new, s_old,
                                    reads, eumaps)[2]):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    th = torch.rand((4, 7), dtype=dtype, device=cuda)
    t1, t2 = th * 1.5, th * 1.75
    rs = torch.tensor([[np.nan], [np.inf], [4.0], [1.0]], dtype=dtype,
                      device=cuda)
    vs = torch.tensor([[1.0], [np.inf], [0.0], [1.0]], dtype=dtype,
                      device=cuda)
    assert torch.equal(csr_cycle.cycle_extrap(th, t1, t2, rs, vs),
                       csr_cycle.cycle_extrap_ref(th, t1, t2, rs, vs))


# (rows, transcripts) of cycle_extrap's and cycle_select's calls: the
# smoke's CSR problem at R 1, 3 (its restart rounds) and 16 (the batched
# solve), the oversized module's problem (159,815 edges), the 11.6 M-edge
# problem above CLUSTER_MAX_EDGES, and rows that start inside a 16-byte
# line; in float64 at R 16 and 11.6 M edges cycle_select reads only the
# picked row (above 512 KiB of cand), elsewhere both
CYCLE_SHAPES = [(1, 12090), (3, 12090), (16, 12090), (1, 20868),
                (1, 1702913), (3, 17), (3, 12091), (5, 3)]


@pytest.mark.parametrize("R,T", CYCLE_SHAPES,
                         ids=[f"R{r}-T{t}" for r, t in CYCLE_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_cycle_extrap_select_match_plain(cuda, dtype, R, T):
    """cycle_extrap and cycle_select on the card, bit for bit their plain
    versions on the card at the shapes of the main path's calls, and on
    arrays one element into their allocations: the step length from true
    row sums and from sums that make it NaN and -1, the accept on gains
    NaN, -0.0, -1e-300, 0, 1 and -inf by row; two calls equal; one launch
    each counted."""
    rng = np.random.default_rng(R * T % 1000)
    theta = rng.uniform(0, 10, (R, T))
    theta[:, rng.random(T) < 0.2] = 0.0
    t1 = theta * rng.uniform(0.5, 1.5, (R, T))
    t2 = t1 * rng.uniform(0.5, 1.5, (R, T)) - 0.5 * (rng.random((R, T))
                                                       < 0.1)
    cand = rng.uniform(0, 10, (R, T))
    theta, t1, t2, cand = (torch.as_tensor(a).to(cuda, dtype)
                           for a in (theta, t1, t2, cand))
    r, v = t1 - theta, t2 - 2 * t1 + theta
    special = (torch.tensor([np.nan, np.inf, 4.0] * R, dtype=dtype)[:R],
               torch.tensor([1.0, np.inf, 0.0] * R, dtype=dtype)[:R])
    sums = [(torch.sum(r * r, dim=1, keepdim=True),
             torch.sum(v * v, dim=1, keepdim=True)),
            tuple(a[:, None].to(cuda) for a in special)]
    vals = [np.nan, -0.0, -1e-300, 0.0, 1.0, -np.inf]
    gains = [torch.tensor([vals[(i + k) % 6] for i in range(R)],
                          dtype=dtype, device=cuda) for k in range(6)]

    def shifted(a):
        buf = torch.zeros(a.numel() + 1, dtype=dtype, device=cuda)
        buf[1:] = a.reshape(-1)
        return buf[1:].view(a.shape)
    for th, a, b, c in ((theta, t1, t2, cand),
                        tuple(shifted(x) for x in (theta, t1, t2, cand))):
        for rs, vs in sums:
            before = csr_cycle.EXTRAP_LAUNCHES
            x = csr_cycle.cycle_extrap(th, a, b, rs, vs)
            assert csr_cycle.EXTRAP_LAUNCHES == before + 1
            assert torch.equal(x, csr_cycle.cycle_extrap_ref(
                theta, t1, t2, rs, vs))
            assert torch.equal(x, csr_cycle.cycle_extrap(th, a, b, rs, vs))
        for gain in gains:
            before = csr_cycle.SELECT_LAUNCHES
            out = csr_cycle.cycle_select(gain, c, b)
            assert csr_cycle.SELECT_LAUNCHES == before + 1
            assert torch.equal(out, csr_cycle.cycle_select_ref(gain, cand,
                                                               t2))
            assert torch.equal(out, csr_cycle.cycle_select(gain, c, b))


@pytest.mark.parametrize("R", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_launch_cycles_replay_from_a_cuda_graph(cuda, dtype, R):
    """A block of eight cycles off clusters (twelve launches a cycle:
    cycle_extrap and cycle_select may start before the row sum they wait
    on ends) captured into a CUDA graph and replayed gives the eager
    block's bits, twice."""
    rng = np.random.default_rng(R + 81)
    pg, _, th = _cycle_inputs(rng, R, dtype, cuda)
    static = th.to(cuda)
    want = solver._squarem_cycles(pg, static, 8, None)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        solver._squarem_cycles(pg, static, 8, None)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = solver._squarem_cycles(pg, static, 8, None)
    for _ in range(2):
        out.fill_(-1.0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.parametrize("R", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_squarem_cycle_is_the_torch_body_on_the_card(cuda, dtype, R):
    """Eight cycles of ``solver._squarem_cycle`` give the bits of the torch
    body they replaced, run on the card with the same EM-step and
    intensity kernels, after every cycle; and eight cycles as one block
    of twelve launches a cycle give the body's bits after the eighth."""
    rng = np.random.default_rng(R + 41)
    pg, _, th = _cycle_inputs(rng, R, dtype, cuda)
    th = want = th0 = th.to(cuda)
    for _ in range(8):
        th = solver._squarem_cycle(pg, th)
        want = torch_body_cycle(pg, want)
        torch.cuda.synchronize()
        assert torch.equal(th, want)
    assert torch.equal(solver._squarem_cycles(pg, th0, 8, None), want)


def _same(a, b):
    """Equal bits, NaN where the other has NaN."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


def _check_cluster_kernels(pg, pc, th, plan, cuda):
    """cluster_em_pair (from theta, and from a cycle's accept) and
    cluster_extrap_gain on the card by ``plan`` against their plain
    versions on the same inputs: theta, t1, t2, r * r, v * v and cand bit
    for bit against the CPU's, the gain terms against torch's on the card
    over intensities summed on the CPU (CUDA's log1p on both sides); two
    calls equal; one launch each."""
    thg = th.to(cuda)
    args_g = (plan, pg.reads, pg.inv_denom)
    args_c = (pc.by_cid, pc.by_tid, pc.reads, pc.inv_denom)
    before = (csr_cluster.EM_PAIR_LAUNCHES, csr_cluster.EXTRAP_GAIN_LAUNCHES)
    got = csr_cluster.em_pair(thg, *args_g)
    again = csr_cluster.em_pair(thg, *args_g)
    torch.cuda.synchronize()
    want = csr_cluster.em_pair_ref(th, *args_c)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b) and torch.equal(a.cpu(), w)
    _, t1, t2, r_sq, v_sq = got
    rs = torch.sum(r_sq, dim=1, keepdim=True)
    vs = torch.sum(v_sq, dim=1, keepdim=True)
    ex = (thg, t1, t2, rs, vs, plan, pg.reads, pg.eumaps, pg.inv_denom)
    cand, terms = csr_cluster.extrap_gain(*ex)
    cand2, terms2, s_t2_k, s_cand_k = csr_cluster.extrap_gain(
        *ex, intensities=True)
    torch.cuda.synchronize()
    # the extrapolation by torch on the card (CUDA's sqrt, as the
    # kernel's: torch's CPU sqrt may be an ulp off), its EM step on the CPU
    x = csr_cycle.cycle_extrap_ref(thg, t1, t2, rs, vs).cpu()
    want_cand = ssum.em_step_ref(x, pc.by_cid, pc.by_tid, pc.reads,
                                 pc.inv_denom)
    assert torch.equal(cand, cand2) and _same(terms, terms2)
    assert torch.equal(cand.cpu(), want_cand)
    s_t2, s_cand = (ssum.segment_sum_ref(a.cpu(), pc.by_cid.mult,
                                         pc.by_cid.idx, pc.by_cid.offsets)
                    .to(cuda) for a in (t2, cand))
    assert _same(terms, csr_cycle.gain_terms(pg.reads, pg.eumaps, s_t2,
                                             s_cand))
    assert torch.equal(s_t2_k, s_t2) and _same(s_cand_k, s_cand)
    gain = torch.sum(terms, dim=-1)
    gain[0] = np.nan  # the accept's NaN branch: t2
    src = (gain, cand, t2)
    got = csr_cluster.em_pair(src, *args_g)
    torch.cuda.synchronize()
    want = csr_cluster.em_pair_ref(tuple(a.cpu() for a in src), *args_c)
    assert torch.equal(got[0][0], t2[0])
    for a, w in zip(got, want):
        assert torch.equal(a.cpu(), w)
    assert (csr_cluster.EM_PAIR_LAUNCHES, csr_cluster.EXTRAP_GAIN_LAUNCHES
            ) == (before[0] + 3, before[1] + 2)


@pytest.mark.parametrize("R", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_cluster_kernels_match_plain(cuda, dtype, R):
    """Both cluster kernels by ``plan_for``'s plan against their plain
    versions (``_check_cluster_kernels``)."""
    rng = np.random.default_rng(R + 51)
    pg, pc, th = _cycle_inputs(rng, R, dtype, cuda)
    _check_cluster_kernels(pg, pc, th, csr_cluster.plan_for(
        pg.by_cid, pg.by_tid, R), cuda)


@pytest.mark.parametrize("rows", ["row", "all_rows"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("R", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_cluster_kernels_at_each_cluster_size(cuda, dtype, R, cluster,
                                              rows):
    """Both cluster kernels on plans forced to clusters of 1, 2, 4 and 8
    blocks (as many tiles as the card holds such clusters over the rows,
    doubled until a block's share fits), a cluster taking a row or all R
    rows, against their plain versions (``_check_cluster_kernels``), on a
    problem of many modules (the cluster sweep's, ~12,000 edges) whose
    tiles spread over a cluster's blocks."""
    rng = np.random.default_rng(R + cluster)
    problem = cluster_sweep.random_problem(rng, 12_000)
    pg, pc = (solver.problem_to_device(problem, d, dtype)
              for d in (cuda, torch.device("cpu")))
    if R == 16:
        C, T = len(problem.eumaps), problem.n_transcripts
        ops = [torch.as_tensor(a).to(dtype) for a in (
            rng.poisson(3, (R, C)) * 1.0, rng.uniform(0.1, 2, (R, C)),
            rng.uniform(0.2, 2, (R, T)) * (rng.random((R, T)) < 0.95))]
        pg, pc = (dataclasses.replace(
            p, reads=ops[0].to(d), eumaps=ops[1].to(d),
            inv_denom=ops[2].to(d)) for p, d in ((pg, cuda),
                                                 (pc, torch.device("cpu"))))
    th = torch.as_tensor(cluster_sweep.rows(problem, R, rng)).to(dtype)
    fit = csr_cluster.max_active_clusters(dtype, 0, cluster,
                                          cuda.index or 0)
    n_tiles = max(1, fit // R)
    while True:
        plan = csr_cluster.tile_plan(pg.by_cid, pg.by_tid, n_tiles, cluster,
                                     rows=1 if rows == "row" else R)
        if plan.smem <= csr_cluster.SMEM_BYTES:
            break
        n_tiles *= 2
    _check_cluster_kernels(pg, pc, th, plan, cuda)


@pytest.mark.parametrize("R", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_cluster_cycles_are_the_launch_cycles_on_the_card(cuda, dtype, R):
    """Eight cycles on clusters (five launches a cycle) give the bits of
    the twelve-launch cycles on the card, and launch each cluster kernel
    once a cycle."""
    rng = np.random.default_rng(R + 61)
    pg, _, th = _cycle_inputs(rng, R, dtype, cuda)
    th = th.to(cuda)
    before = (csr_cluster.EM_PAIR_LAUNCHES, csr_cluster.EXTRAP_GAIN_LAUNCHES)
    got = solver._squarem_cycles(pg, th, 8,
                                 solver.cycle_plan(pg, R, clusters=True))
    assert (csr_cluster.EM_PAIR_LAUNCHES, csr_cluster.EXTRAP_GAIN_LAUNCHES
            ) == (before[0] + 8, before[1] + 8)
    want = solver._squarem_cycles(pg, th, 8, None)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not torch.equal(got, th)


def test_cluster_cycles_replay_from_a_cuda_graph(cuda):
    """A block of eight cycles on clusters captured into a CUDA graph and
    replayed gives the eager block's bits, twice."""
    rng = np.random.default_rng(71)
    pg, _, th = _cycle_inputs(rng, 3, torch.float64, cuda)
    static = th.to(cuda)
    plan = solver.cycle_plan(pg, 3, clusters=True)  # host work: not captured
    want = solver._squarem_cycles(pg, static, 8, plan)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        solver._squarem_cycles(pg, static, 8, plan)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = solver._squarem_cycles(pg, static, 8, plan)
    for _ in range(2):
        out.fill_(-1.0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_clusters_fit_on_the_card(cuda, dtype):
    """cudaOccupancyMaxActiveClusters finds room for at least one cluster
    of each kernel at every size the source is built for (the wrappers
    raise otherwise), fewer the larger they are."""
    fit = [min(csr_cluster.max_active_clusters(dtype, which, cl,
                                               cuda.index or 0)
               for which in (0, 1)) for cl in csr_cluster.CLUSTERS]
    assert fit[-1] >= 1 and fit == sorted(fit, reverse=True)


@pytest.mark.parametrize("tiles", [(1, 8), (5, 4), (9, 2), (17, 1)])
def test_cluster_kernels_on_every_tiling(cuda, tiles):
    """Eight cycles at R 3 on clusters of each size, in one to 17 tiles a
    row, give the twelve launches' bits, on a problem of many modules (the
    cluster sweep's, ~12,000 edges)."""
    rng = np.random.default_rng(81)
    problem = cluster_sweep.random_problem(rng, 12_000)
    pg = solver.problem_to_device(problem, cuda, torch.float64)
    th = torch.as_tensor(cluster_sweep.rows(problem, 3, rng)).to(cuda)
    plan = csr_cluster.tile_plan(pg.by_cid, pg.by_tid, *tiles)
    assert plan.smem <= csr_cluster.SMEM_BYTES
    got = solver._squarem_cycles(pg, th, 8, plan)
    want = solver._squarem_cycles(pg, th, 8, None)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("R", [3, 16])
def test_plan_rows_follow_the_sweep(cuda, R):
    """``plan_for`` gives a cluster a row below ``ALL_ROWS_MIN_EDGES``
    edges a row and a cluster all R rows from there on; one row a cluster
    at R 1."""
    for n_edges in (90_000, csr_cluster.ALL_ROWS_MIN_EDGES):
        problem = cluster_sweep.random_problem(
            np.random.default_rng(n_edges), n_edges * 101 // 100)
        pg = solver.problem_to_device(problem, cuda, torch.float64)
        big = pg.by_cid.idx.shape[0] >= csr_cluster.ALL_ROWS_MIN_EDGES
        assert big == (n_edges > 90_000)
        assert csr_cluster.plan_for(pg.by_cid, pg.by_tid, R).rows == (
            R if big else 1)
        assert csr_cluster.plan_for(pg.by_cid, pg.by_tid, 1).rows == 1
