"""The CUDA sources of the port run on the CPU against their plain
versions: each ``csrc/*.cu`` is built with g++ against
``tests/cuda_emu/cuda_runtime.h``, which emulates the threads, barriers
and shuffles the kernels use (one std::thread per CUDA thread), and its
``extern "C"`` launcher is called through ctypes on CPU tensors.  This
holds the kernels' index arithmetic, tiling, staging and reductions on
every CPU run; that nvcc builds them and what they cost on the card are
for ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import ctypes
import dataclasses
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from emsar_tpu_torch.index.device_build import DeviceRef
from emsar_tpu_torch.index.device_build_pe import rank_pass
from emsar_tpu_torch.io.fasta import build_transcriptome
from emsar_tpu_torch.kernels import (_build, csr_cluster, csr_cycle,
                                     pe_candidates, segment_sum, squarem,
                                     window_hash)
from emsar_tpu_torch.kernels.check import (block_agreement, block_tol,
                                           random_modules)
from emsar_tpu_torch.model import solver
from emsar_tpu_torch.model.dense import SIZE_CLASSES
from emsar_tpu_torch.sim import gene_family_transcriptome
from torch_loop_cases import gain_branch_cases

EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "cuda_emu")
TILE = 2048  # window starts per thread block (csrc/window_hash.cu kTile)


def _top_level_split(text: str) -> list:
    """``text`` split at the commas outside any brackets."""
    parts, depth, start = [], 0, 0
    for i, c in enumerate(text):
        depth += {"(": 1, "<": 1, ")": -1, ">": -1}.get(c, 0)
        if c == "," and depth == 0:
            parts.append(text[start:i].strip())
            start = i + 1
    return parts + [text[start:].strip()]


def _cluster_dims(text: str) -> dict:
    """{kernel: (its template parameters' names, the expression of its
    __cluster_dims__' first size)} of the source's cluster kernels."""
    found = {}
    for m in re.finditer(
            r"template\s*<([^<>]*)>\s*__global__\s+void\s+"
            r"__cluster_dims__\(([^,()]+),[^)]*\)\s*"
            r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", text):
        params = [p.split()[-1] for p in _top_level_split(m.group(1))]
        found[m.group(3)] = (params, m.group(2).strip())
    return found


def _cluster_of(kernel: str, clusters: dict) -> str:
    """The cluster size of a launch of ``kernel`` (``name<args>``): its
    __cluster_dims__ expression with the template's arguments put in,
    "1" for a kernel without one."""
    m = re.fullmatch(r"(\w+)\s*(?:<(.*)>)?", kernel, re.S)
    if m is None or m.group(1) not in clusters:
        return "1"
    params, expr = clusters[m.group(1)]
    args = dict(zip(params, _top_level_split(m.group(2) or "")))
    return "(" + re.sub(r"\w+", lambda w: f"({args[w.group(0)]})"
                        if w.group(0) in args else w.group(0), expr) + ")"


def _emulated_source(text: str) -> str:
    """The CUDA source with each launch as a call of emu_launch, with the
    kernel's cluster size (``__cluster_dims__``) when it has one."""
    text = text.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = emu_dyn_smem;")
    clusters = _cluster_dims(text)
    out, i = [], 0
    while (j := text.find("<<<", i)) >= 0:
        k = max(text.rfind(c, 0, j) for c in ";{}") + 1
        e = text.index(">>>", j)
        cfg = [a.strip() for a in text[j + 3:e].split(",")]
        depth, p = 0, e + 3
        while True:
            depth += {"(": 1, ")": -1}.get(text[p], 0)
            p += 1
            if depth == 0:
                break
        kernel = text[k:j].strip()
        out.append(f"{text[i:k]}\n    emu_launch({cfg[0]}, {cfg[1]}, "
                   f"{cfg[2] if len(cfg) > 2 else 0}, [&] {{ "
                   f"{kernel}({text[e + 4:p - 1]}); }}, "
                   f"{_cluster_of(kernel, clusters)})")
        i = p
    return "".join(out) + text[i:]


# threads a block of csrc/csr_cluster.cu's emulated clusters: few, so that
# a cluster's threads all run at once on the CPU
CLUSTER_THREADS = 64
# csrc/csr_cycle.cu's pair_gain built for tiles of at most 16 segments (32
# edges staged: a segment of more edges reads the rest from memory), 32
# threads a block
PAIR_TILE = 16
PAIR_THREADS = 32
# the emulated build of csrc/csr_cycle.cu whose pair_gain stages its tiles
# by bulk copies (EMSAR_PAIR_TMA=1: bench/pair_parts.py's variant)
PAIR_TMA = csr_cycle.SOURCE + " EMSAR_PAIR_TMA=1"
# cycle_select reads only the picked row above this many bytes of cand a
# call in the emulated build (512 KiB on the card): both of its paths run
# (test_cycle_runs_match_plain: rows of several runs at R 1 load both rows
# before the wait, at R 3 the picked one after it)
SELECT_EARLY_BYTES = 32768
# cycle_extrap's and cycle_select's elements a block in the emulated build
# (csrc/csr_cycle.cu: 2 vectors of 16 bytes a thread, 256 threads)
RUN_BYTES = 2 * 16 * 256


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{source: its library built for the CPU emulation}."""
    libs = {}
    builds = [(s, s, ()) for s in (
        window_hash.SOURCE, squarem.SOURCE, pe_candidates.SOURCE,
        segment_sum.SOURCE, csr_cycle.SOURCE, csr_cluster.SOURCE)]
    builds.append((PAIR_TMA, csr_cycle.SOURCE, ("-DEMSAR_PAIR_TMA=1",)))
    for name, source, flags in builds:
        with open(os.path.join(_build.CSRC_DIR, source)) as fh:
            text = _emulated_source(fh.read())
        cc = tmp_path_factory.mktemp("emu") / (source + ".cc")
        cc.write_text(text)
        so = str(cc) + ".so"
        subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", f"-DEMSAR_CLUSTER_THREADS="
                        f"{CLUSTER_THREADS}", f"-DEMSAR_PAIR_TILE={PAIR_TILE}",
                        f"-DEMSAR_PAIR_THREADS={PAIR_THREADS}",
                        f"-DEMSAR_SELECT_EARLY_BYTES={SELECT_EARLY_BYTES}",
                        *flags,
                        "-I", EMU_DIR, "-o", so, str(cc)], check=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def test_launches_are_rewritten():
    """A launch becomes emu_launch with cluster 1, a launch of a kernel
    with __cluster_dims__ carries that size, its template's arguments put
    in."""
    src = ("  k<F, 1><<<(unsigned)B, 128, smem,\n stream>>>(a, f(b), c);\n"
           "  return 0;")
    got = _emulated_source(src)
    assert "<<<" not in got
    assert re.search(r"emu_launch\(\(unsigned\)B, 128, smem, \[&\] \{ "
                     r"k<F, 1>\(a, f\(b\), c\); \}, 1\)", got)
    src = ("template <typename F, int CL>\n__global__ void "
           "__cluster_dims__(CL, 1, 1) __launch_bounds__(kThreads, 1)\n"
           "    ck(A<F> a) {}\nint f() {\n  ck<float, 2 * N><<<R * 8, "
           "kThreads, 0, s>>>(a);\n  return 0;\n}")
    got = _emulated_source(src)
    assert re.search(r"emu_launch\(R \* 8, kThreads, 0, \[&\] \{ "
                     r"ck<float, 2 \* N>\(a\); \}, \(\(2 \* N\)\)\)", got)
    # a cudaLaunchKernelEx launch stays as it is (the emulated header runs
    # it), a <<<>>> launch beside it is rewritten
    src = ("  cfg.numAttrs = 1;\n  const cudaError_t err = cudaLaunchKernelEx("
           "&cfg, kernel, args...);\n  k<F><<<B, 32>>>(a);\n")
    got = _emulated_source(src)
    assert "cudaLaunchKernelEx(&cfg, kernel, args...);" in got
    assert "<<<" not in got and "emu_launch(B, 32, 0, [&] { k<F>(a); }, 1)" in got


def test_launch_kernel_ex_runs_every_block(tmp_path):
    """The emulated cudaLaunchKernelEx runs each block of a 2-D grid once,
    with its blockIdx.x and .y, every thread of it, and
    cudaGridDependencySynchronize returns."""
    src = tmp_path / "kex.cc"
    src.write_text('''#include <cuda_runtime.h>
__global__ void mark(int* seen, int nx) {
  cudaGridDependencySynchronize();
  atomicAdd(seen + blockIdx.y * nx + blockIdx.x, (int)(threadIdx.x + 1));
}
extern "C" int run(int* seen, int nx, int ny) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nx, ny, 1);
  cfg.blockDim = dim3(8, 1, 1);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, mark, seen, nx);
}
''')
    so = str(src) + ".so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", "-I", EMU_DIR, "-o", so, str(src)],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    seen = torch.zeros(3 * 5, dtype=torch.int32)
    assert lib.run(seen.data_ptr(), 5, 3) == 0
    assert torch.equal(seen, torch.full_like(seen, sum(range(1, 9))))


def _hash_input(rng, n_genes, extra=()):
    """A gene-family transcriptome with an N in transcript 1, N bases on
    both sides of the first tile edge, and ``extra`` sequences."""
    names, seqs, _ = gene_family_transcriptome(rng, n_genes)
    seqs[1] = seqs[1][:30] + b"N" + seqs[1][31:]
    start = 0
    for k, s in enumerate(seqs):
        if start < TILE <= start + len(s) - 2:
            p = TILE - start - 1
            seqs[k] = s[:p] + b"NN" + s[p + 2:]
            break
        start += len(s) + 1
    names += [f"x{k}" for k in range(len(extra))]
    seqs += list(extra)
    return DeviceRef(build_transcriptome(names, seqs), torch.device("cpu"))


@pytest.mark.parametrize("shift", [0, 3], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("unstranded", [True, False], ids=["ns", "ss"])
@pytest.mark.parametrize("rl", [1, 17, 64, 76])
def test_window_hash_source_matches_plain(emulated, rl, unstranded, shift):
    """Bit-equal lanes and tids over several tiles, the last one ragged, a
    transcript shorter than rl, and codes that do not start on a 16-byte
    boundary (``shift``)."""
    ref = _hash_input(np.random.default_rng(rl), 6, [b"ACGTTGCAAC"])
    n = ref.borderpos - rl + 1
    assert n > 2 * TILE and n % TILE
    buf = torch.zeros(ref.codes.shape[0] + 32, dtype=torch.uint8)
    off = (-buf.data_ptr()) % 16 + shift
    codes = buf[off:off + ref.codes.shape[0]]
    codes.copy_(ref.codes)
    tidf = ref.tid_forward(n)
    mult = torch.as_tensor(window_hash.MULT[:3].view(np.int32).copy())
    got = [torch.full((n,), 7, dtype=torch.int32) for _ in range(4)]
    fn = emulated[window_hash.SOURCE].emsar_window_hash
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
    assert fn(codes.data_ptr(), tidf.data_ptr(), mult.data_ptr(), n,
              ref.seqlength, rl, int(unstranded),
              *(t.data_ptr() for t in got), None) == 0
    want = window_hash.window_hash_ref(ref.codes, tidf, ref.borderpos,
                                       ref.seqlength, rl, unstranded)
    assert (want[3] >= 0).any() and (want[3] < 0).any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_iters", [1, 8], ids=["cycle", "block"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("C,T", SIZE_CLASSES,
                         ids=[f"{c}x{t}" for c, t in SIZE_CLASSES])
def test_squarem_source_matches_plain(emulated, C, T, dtype, n_iters):
    """Every class: the one-warp classes with a ragged last block (B = 5,
    four modules a block) and inert pad rows, the block classes on two
    modules."""
    B = 5 if C <= 64 else 2
    rng = np.random.default_rng(C + T)
    args = [torch.as_tensor(a).to(dtype) for a in random_modules(rng, B, C, T)]
    for a in args[:3]:
        a[:, C - 3:] = 0
    out = torch.empty_like(args[4])
    lib = emulated[squarem.SOURCE]
    fn = (lib.emsar_squarem_block_f64 if dtype == torch.float64
          else lib.emsar_squarem_block_f32)
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    assert fn(*(a.data_ptr() for a in args), out.data_ptr(), B, C, T,
              n_iters, 0, None) == 0
    want = squarem.squarem_block_ref(*args, n_iters)
    err, _, n = block_agreement(out, want, *args, n_iters)
    assert n >= 1 and torch.isfinite(out).all()
    assert err <= block_tol(dtype, n_iters), err


def pe_chunk(rng, rl, unstranded, n_members, kind="mixed"):
    """A chunk of a gene-family transcriptome's PE build on the CPU: its
    tables, the rank-sorted members (``kind`` "multi" or "single": only
    the members of multi-member or of singleton mate1 clusters) with two
    members appended after a chunk of ``n_members`` (the last window start
    and the last position, past the tid table; one cluster of both for
    "multi", else two singletons), and the chunk's bounds [lo, hi), a
    member on either side of it."""
    names, seqs, _ = gene_family_transcriptome(rng, 4, n_exons=5,
                                               min_exon=40, max_exon=120)
    seqs[1] = seqs[1][:30] + b"N" + seqs[1][31:]
    # tandem repeats every 120 bp: the rows of the unique windows before
    # each see one mate2 rank in several slots
    for i in (2, 3):
        seqs[i] = b"".join(seqs[i][k:k + 120] + b"ACG" * 8
                           for k in range(0, len(seqs[i]), 120))
    ref = DeviceRef(build_transcriptome(names, seqs), torch.device("cpu"))
    t32, nsep = ref.t32(rl), ref.nsep()
    R, spos, srank = rank_pass(ref, t32, rl, unstranded, 0)
    if kind != "mixed":
        sng = pe_candidates.singleton_members(srank, 0, srank.shape[0])
        pick = sng if kind == "single" else ~sng
        spos, srank = spos[pick], srank[pick]
    n_members = min(n_members, spos.shape[0] // 3)
    lo = int(rng.integers(1, spos.shape[0] - 2 * n_members))
    hi = lo + n_members
    while srank[hi] == srank[hi - 1]:  # the appended members end a cluster
        hi += 1
    extra = torch.tensor([ref.seqlength - rl, ref.seqlength],
                         dtype=torch.int32)
    xrank = torch.tensor([1 << 29, 1 << 29 if kind == "multi"
                          else (1 << 29) + 1], dtype=torch.int32)
    spos = torch.cat([spos[:hi], extra, spos[hi:]])
    srank = torch.cat([srank[:hi], xrank, srank[hi:]])
    return (spos, srank, lo, hi + 2, R,
            R.flip(0).contiguous() if unstranded else None,
            pe_candidates.pack_tables(t32, nsep), ref)


def emulated_pe_candidates(lib, spos, srank, lo, hi, R, RF, tn, d0, nfl, rl,
                           ref, unstranded, single):
    """The emulated kernel's launch: (keys, payloads) of its count."""
    fn = lib.emsar_pe_candidates
    fn.restype = ctypes.c_int
    fn.argtypes = pe_candidates.ARGTYPES
    n_scratch = lib.emsar_pe_candidates_scratch
    n_scratch.restype = ctypes.c_longlong
    n_scratch.argtypes = pe_candidates.SCRATCH_ARGTYPES
    scratch = torch.zeros(n_scratch(hi - lo, nfl), dtype=torch.int64)
    cap = (hi - lo) * nfl
    keys = torch.full((cap,), 7, dtype=torch.int64)
    pay = torch.full((cap,), 7, dtype=torch.int32)
    assert fn(spos.data_ptr(), srank.data_ptr(), spos.shape[0], lo, hi - lo,
              R.data_ptr(), RF.data_ptr() if RF is not None else None,
              R.shape[0], tn.data_ptr(), tn.shape[0], d0, nfl, rl,
              ref.borderpos, ref.seqlength, int(unstranded),
              single.data_ptr(), single.shape[0],
              keys.data_ptr(), pay.data_ptr(), cap, scratch.data_ptr(),
              None) == 0
    n = int(scratch[1])
    assert torch.all(keys[n:] == 7)
    return keys[:n], pay[:n]


def _check_pe_source(lib, rng, unstranded, d0, nfl, n_members, kind):
    rl = 20
    spos, srank, lo, hi, R, RF, tn, ref = pe_chunk(
        rng, rl, unstranded, n_members, kind)
    n_single = ref.tx.n_transcripts * nfl
    start = torch.arange(n_single, dtype=torch.int64) % 5
    single, want_single = start.clone(), start.clone()
    keys, pay = emulated_pe_candidates(lib, spos, srank, lo, hi, R, RF, tn,
                                       d0, nfl, rl, ref, unstranded, single)
    want = pe_candidates.pe_candidates_ref(spos, srank, lo, hi, R, RF, tn,
                                           d0, nfl, rl, ref.borderpos,
                                           ref.seqlength, unstranded,
                                           want_single)
    assert torch.equal(keys, want[0]) and torch.equal(pay, want[1])
    assert torch.equal(single, want_single)
    grid = pe_candidates.pe_candidate_grid_ref(
        spos[lo:hi], srank[lo:hi], R, RF, *pe_candidates.unpack_tables(tn),
        d0, nfl, rl, ref.borderpos, ref.seqlength, unstranded)[0]
    sng = pe_candidates.singleton_members(srank, lo, hi)
    added = int((single - start).sum())
    valid = int((grid.view(-1, nfl)[sng] != pe_candidates.INVALID_KEY).sum())
    return keys.shape[0], added, valid - added


@pytest.mark.parametrize("nfl", [1, 11, 400])
@pytest.mark.parametrize("d0", [0, 37])
@pytest.mark.parametrize("unstranded", [True, False], ids=["ns", "ssfr"])
def test_pe_candidates_source_matches_plain(emulated, unstranded, d0, nfl):
    """Keys, payloads, their count and the singleton counts bit for bit,
    for members of both halves, a chunk that starts and ends between
    members of one cluster, a member whose mate2 windows run past the
    sequence and one past the tid table."""
    written, added, _ = _check_pe_source(
        emulated[pe_candidates.SOURCE], np.random.default_rng(nfl + d0),
        unstranded, d0, nfl, 150 if nfl == 400 else 300, "mixed")
    assert written > 0 and added > 0


@pytest.mark.parametrize("nfl", [11, 400])
@pytest.mark.parametrize("kind", ["multi", "single"])
@pytest.mark.parametrize("unstranded", [True, False], ids=["ns", "ssfr"])
def test_pe_candidates_source_chunk_kinds(emulated, unstranded, kind, nfl):
    """A chunk with no singleton member writes every valid candidate and
    counts none; one of singletons only writes none, and drops the slots
    whose mate2 rank repeats in the row."""
    written, added, dropped = _check_pe_source(
        emulated[pe_candidates.SOURCE], np.random.default_rng(nfl + 3),
        unstranded, 5, nfl, 40 if nfl == 400 else 200, kind)
    assert (written > 0, added > 0, dropped > 0) == (
        (True, False, False) if kind == "multi" else (False, True, True))


def _sum_problem(rng, n_seg=40, ntid=48, n_edges=700):
    """A SolverProblem whose last quarter of segments and of transcripts
    have no edge, segment 0 holding an edge to every other transcript
    (more edges than a warp), read-less segments among the rest."""
    used_seg, used_tid = n_seg * 3 // 4, ntid * 3 // 4
    key = np.unique(np.concatenate([
        rng.integers(0, used_seg, n_edges) * ntid
        + rng.integers(0, used_tid, n_edges), np.arange(used_tid)]))
    return solver.SolverProblem(
        n_transcripts=ntid, edge_cid=(key // ntid).astype(np.int32),
        edge_tid=(key % ntid).astype(np.int32),
        edge_mult=rng.integers(1, 3, len(key)).astype(np.float64),
        eumaps=rng.uniform(0.1, 2, n_seg),
        reads=rng.poisson(3, n_seg) * (rng.random(n_seg) < 0.8),
        denom=rng.uniform(0.5, 3, ntid) * (rng.random(ntid) < 0.9))


def _emulated_sum(lib, x, g, lanes, mode, a=None, b=None, a_stride=0):
    """The emulated launch of csrc/segment_sum.cu over grouping ``g``."""
    fn = (lib.emsar_segment_sum_f64 if x.dtype == torch.float64
          else lib.emsar_segment_sum_f32)
    fn.restype = ctypes.c_int
    fn.argtypes = segment_sum.ARGTYPES
    out = torch.full((x.shape[0], g.n_groups), 7.0, dtype=x.dtype)
    assert fn(x.data_ptr(), g.mult.data_ptr(), g.idx.data_ptr(),
              g.offsets.data_ptr(), None if a is None else a.data_ptr(),
              None if b is None else b.data_ptr(), out.data_ptr(),
              x.shape[0], g.n_groups, g.n_x, a_stride, lanes, mode,
              None) == 0
    return out


@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_pair_gain_tma_staging_is_the_direct_kernel(emulated, dtype, shift):
    """pair_gain built to stage its tiles' tids, weights and group ends by
    bulk copies (EMSAR_PAIR_TMA=1, the variant bench/pair_parts.py times)
    gives the default build's bits, with and without the intensities, on
    groupings whose arrays start ``shift`` elements into their allocation
    (a tile's first element then lies inside a 16-byte line, whose other
    elements the threads load), reads and eumaps a row each at R = 3; the
    intensities equal the plain version's."""
    rng = np.random.default_rng(40 + shift)
    problem = _sum_problem(rng, n_seg=120, ntid=90, n_edges=1500)
    p = solver.problem_to_device(problem, torch.device("cpu"), dtype)

    def shifted(t):
        buf = torch.zeros(t.numel() + shift, dtype=t.dtype)
        buf[shift:] = t
        return buf[shift:]
    g = dataclasses.replace(p.by_cid, mult=shifted(p.by_cid.mult),
                            idx=shifted(p.by_cid.idx),
                            offsets=shifted(p.by_cid.offsets))
    assert g.idx.data_ptr() % 16 == 4 * shift % 16
    R, T = 3, problem.n_transcripts
    reads = torch.stack([p.reads * k for k in (1, 2, 0.5)])
    eumaps = torch.stack([p.eumaps.roll(k) for k in range(R)])
    t2 = torch.as_tensor(rng.uniform(0, 10, (R, T))).to(dtype)
    cand = torch.as_tensor(rng.uniform(0, 10, (R, T))).to(dtype)
    assert (torch.diff(g.offsets) > 2 * PAIR_TILE).any()
    for intensities in (False, True):
        want = _emulated_gain(emulated[csr_cycle.SOURCE], g, reads, eumaps,
                              t2, cand, intensities)
        got = _emulated_gain(emulated[PAIR_TMA], g, reads, eumaps, t2, cand,
                             intensities)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
    s_t2, s_cand = (segment_sum.segment_sum_ref(a, g.mult, g.idx, g.offsets)
                    for a in (t2, cand))
    assert torch.equal(got[1], s_t2) and torch.equal(got[2], s_cand)


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
@pytest.mark.parametrize("lanes", segment_sum.LANES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_segment_sum_source_matches_plain(emulated, dtype, lanes, per_row):
    """Mode 0 (the plain sums by cid and by tid), mode 1 (the read ratio)
    and mode 2 (the update) at every lane count, with reads and inv_denom
    one row shared by the R = 3 rows of theta or one row each: bit-equal
    to ``segment_sum_ref`` and ``em_step_ref``, with empty segments, a
    segment of more edges than a warp, zero thetas and read-less
    segments."""
    rng = np.random.default_rng(lanes + 2 * per_row)
    problem = _sum_problem(rng)
    p = solver.problem_to_device(problem, torch.device("cpu"), dtype)
    R, C, T = 3, len(problem.eumaps), problem.n_transcripts
    theta = rng.uniform(0, 10, (R, T))
    theta[:, rng.random(T) < 0.2] = 0.0
    theta = torch.as_tensor(theta).to(dtype)
    reads, inv_denom = p.reads, p.inv_denom
    if per_row:  # each row its own sample: scaled reads, other denominators
        reads = torch.stack([reads * k for k in (1, 2, 0.5)])
        inv_denom = torch.stack([inv_denom.roll(k) for k in range(R)])
    lib = emulated[segment_sum.SOURCE]
    for g, x in ((p.by_cid, theta), (p.by_tid, reads.expand(R, C)
                                     .contiguous())):
        want = segment_sum.segment_sum_ref(x, g.mult, g.idx, g.offsets)
        assert torch.equal(_emulated_sum(lib, x, g, lanes, 0), want)
    stride = C if per_row else 0
    ratio = _emulated_sum(lib, theta, p.by_cid, lanes, 1, a=reads,
                          a_stride=stride)
    s = segment_sum.segment_sum_ref(theta, p.by_cid.mult, p.by_cid.idx,
                                    p.by_cid.offsets)
    assert (s == 0).any() and (reads == 0).any()
    assert torch.equal(ratio, torch.where(s > 0, reads / torch.where(
        s > 0, s, 1.0), 0.0))
    got = _emulated_sum(lib, ratio, p.by_tid, lanes, 2, a=inv_denom,
                        b=theta, a_stride=T if per_row else 0)
    want = segment_sum.em_step_ref(theta, p.by_cid, p.by_tid, reads,
                                   inv_denom)
    assert torch.equal(got, want) and (want > 0).any()


def _emulated_cycle_update(lib, ratio, t1, theta, g, lanes, inv_denom,
                           a_stride):
    """The emulated mode-3 launch of csrc/segment_sum.cu: (t2, rr, vv)."""
    fn = (lib.emsar_em_cycle_update_f64 if t1.dtype == torch.float64
          else lib.emsar_em_cycle_update_f32)
    fn.restype = ctypes.c_int
    fn.argtypes = segment_sum.CYCLE_ARGTYPES
    out = [torch.full_like(t1, 7.0) for _ in range(3)]
    assert fn(ratio.data_ptr(), g.mult.data_ptr(), g.idx.data_ptr(),
              g.offsets.data_ptr(), inv_denom.data_ptr(), t1.data_ptr(),
              theta.data_ptr(), *(o.data_ptr() for o in out), t1.shape[0],
              g.n_groups, g.n_x, a_stride, lanes, None) == 0
    return out


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
@pytest.mark.parametrize("lanes", [4, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_em_cycle_update_source_matches_plain(emulated, dtype, lanes,
                                              per_row):
    """Mode 3 (the second EM step of a cycle): t2, r * r and v * v
    bit-equal to ``em_step_cycle_ref``, with one row of reads and
    inv_denom shared by the R = 3 rows or one each."""
    rng = np.random.default_rng(lanes + 5 * per_row)
    problem = _sum_problem(rng)
    p = solver.problem_to_device(problem, torch.device("cpu"), dtype)
    R, C, T = 3, len(problem.eumaps), problem.n_transcripts
    theta = rng.uniform(0, 10, (R, T))
    theta[:, rng.random(T) < 0.2] = 0.0
    theta = torch.as_tensor(theta).to(dtype)
    reads, inv_denom = p.reads, p.inv_denom
    if per_row:
        reads = torch.stack([reads * k for k in (1, 2, 0.5)])
        inv_denom = torch.stack([inv_denom.roll(k) for k in range(R)])
    t1 = segment_sum.em_step_ref(theta, p.by_cid, p.by_tid, reads,
                                 inv_denom)
    lib = emulated[segment_sum.SOURCE]
    ratio = _emulated_sum(lib, t1, p.by_cid, lanes, 1, a=reads,
                          a_stride=C if per_row else 0)
    got = _emulated_cycle_update(lib, ratio, t1, theta, p.by_tid, lanes,
                                 inv_denom, T if per_row else 0)
    want = segment_sum.em_step_cycle_ref(t1, theta, p.by_cid, p.by_tid,
                                         reads, inv_denom)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (want[1] > 0).any() and (want[2] > 0).any()


def _log1p_tolerance(got, want, reads, s_old, s_new, skip_unread=False):
    """The emulated gain terms against the plain version's: the same bits
    where the term has no log1p, and where it has one within 4 ulps of
    reads * log1p(...) plus one ulp of the term (the host libm's log1p
    and torch's CPU log1p may differ by an ulp, and the term's last
    rounding then by one more; on the card both are CUDA's log1p, and the
    terms are bit-equal there; with ``skip_unread`` a segment without
    reads has no log1p)."""
    both = (s_old > 0) & (s_new > 0)
    if skip_unread:
        both &= reads > 0
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    exact = ok & ~both
    assert torch.equal(got[exact], want[exact])
    eps = torch.finfo(got.dtype).eps
    ratio = torch.log1p((s_new - s_old) / torch.where(both, s_old, 1.0))
    tol = 4 * eps * (reads * ratio).abs() + eps * want.abs()
    close = ok & both
    assert ((got - want).abs()[close] <= tol[close]).all()


def _identity_groups(n, dtype):
    """n segments of one edge each, segment i to transcript i: the
    intensities are the thetas."""
    return segment_sum.prepare(torch.arange(n + 1), torch.arange(n),
                               torch.ones(n, dtype=dtype), n)


def _emulated_gain(lib, g, reads, eumaps, x_old, x_new, intensities=True,
                   skip_unread=False):
    """The emulated pair_gain launch over the emulated build's tiles of
    ``g``: (terms, x_old's intensities, x_new's), the intensities None
    unless asked for."""
    fn = (lib.emsar_pair_gain_f64 if x_new.dtype == torch.float64
          else lib.emsar_pair_gain_f32)
    fn.restype = ctypes.c_int
    fn.argtypes = csr_cycle.PAIR_ARGTYPES
    R, C = x_new.shape[0], g.n_groups
    tiles = segment_sum.tile_bounds(g.offsets, PAIR_TILE)
    out = torch.full((R, C), 7.0, dtype=x_new.dtype)
    s_pair = ((torch.full_like(out, 7.0), torch.full_like(out, 7.0))
              if intensities else (None, None))
    a_stride = C if reads.dim() == 2 else 0
    assert fn(x_old.data_ptr(), x_new.data_ptr(), g.mult.data_ptr(),
              g.idx.data_ptr(), g.offsets.data_ptr(), tiles.data_ptr(),
              reads.data_ptr(), eumaps.data_ptr(),
              *(_ptr(t) for t in s_pair), out.data_ptr(), R, C, g.n_x,
              a_stride, tiles.shape[1] - 1, PAIR_TILE, int(skip_unread),
              None) == 0
    return (out, *s_pair)


def _emulated_block_end(lib, gain, cand, t2, s_t2, s_cand, s_prev, reads,
                        eumaps, skip_unread=False):
    """The emulated block_end launch: (theta, intensities, terms or
    None)."""
    fn = (lib.emsar_block_end_f64 if cand.dtype == torch.float64
          else lib.emsar_block_end_f32)
    fn.restype = ctypes.c_int
    fn.argtypes = csr_cycle.BLOCK_END_ARGTYPES
    R, T = cand.shape
    C = s_t2.shape[1]
    theta = torch.full_like(cand, 7.0)
    s = torch.full_like(s_t2, 7.0)
    terms = None if s_prev is None else torch.full_like(s_t2, 7.0)
    assert fn(gain.data_ptr(), cand.data_ptr(), t2.data_ptr(),
              s_t2.data_ptr(), s_cand.data_ptr(), _ptr(s_prev),
              reads.data_ptr(), eumaps.data_ptr(), theta.data_ptr(),
              s.data_ptr(), _ptr(terms), R, C, T,
              C if reads.dim() == 2 else 0, int(skip_unread), None) == 0
    return theta, s, terms


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_gain_term_source_branches(emulated, dtype):
    """Every branch of the gain term, one segment each, through pair_gain
    on one-edge segments (intensities = thetas) and through block_end
    (the accept of cand at a gain >= 0, of t2 at a NaN gain), with reads
    and eumaps a row each: NaN where the plain version has NaN, the same
    bits elsewhere but for the log1p tolerance; the intensities and
    block_end's theta bit-equal."""
    s_old, s_new, reads, eumaps = gain_branch_cases(dtype)
    g = _identity_groups(s_old.shape[1], dtype)
    lib = emulated[csr_cycle.SOURCE]
    want = csr_cycle.gain_terms(reads, eumaps, s_old, s_new)
    assert torch.isnan(want).sum() >= 3 and (want.abs() == 1e30).any()
    got, s_o, s_n = _emulated_gain(lib, g, reads, eumaps, s_old, s_new)
    assert torch.equal(s_o.nan_to_num(), s_old.nan_to_num())
    assert torch.equal(s_n.nan_to_num(), s_new.nan_to_num())
    _log1p_tolerance(got, want, reads, s_old, s_new)
    other = s_new.flip(-1)
    for value, (cand, t2) in ((0.0, (s_new, other)),
                              (np.nan, (other, s_new))):
        gain = torch.full((s_new.shape[0],), value, dtype=dtype)
        theta, s, got = _emulated_block_end(lib, gain, cand, t2, t2, cand,
                                            s_old, reads, eumaps)
        assert torch.equal(theta.nan_to_num(), s_new.nan_to_num())
        assert torch.equal(s.nan_to_num(), s_new.nan_to_num())
        _log1p_tolerance(got, want, reads, s_old, s_new)


@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_pair_gain_tma_staging_is_the_direct_kernel(emulated, dtype, shift):
    """pair_gain built to stage its tiles' tids, weights and group ends by
    bulk copies (EMSAR_PAIR_TMA=1, the variant bench/pair_parts.py times)
    gives the default build's bits, with and without the intensities, on
    groupings whose arrays start ``shift`` elements into their allocation
    (a tile's first element then lies inside a 16-byte line, whose other
    elements the threads load), reads and eumaps a row each at R = 3; the
    intensities equal the plain version's."""
    rng = np.random.default_rng(40 + shift)
    problem = _sum_problem(rng, n_seg=120, ntid=90, n_edges=1500)
    p = solver.problem_to_device(problem, torch.device("cpu"), dtype)

    def shifted(t):
        buf = torch.zeros(t.numel() + shift, dtype=t.dtype)
        buf[shift:] = t
        return buf[shift:]
    g = dataclasses.replace(p.by_cid, mult=shifted(p.by_cid.mult),
                            idx=shifted(p.by_cid.idx),
                            offsets=shifted(p.by_cid.offsets))
    assert g.idx.data_ptr() % 16 == 4 * shift % 16
    R, T = 3, problem.n_transcripts
    reads = torch.stack([p.reads * k for k in (1, 2, 0.5)])
    eumaps = torch.stack([p.eumaps.roll(k) for k in range(R)])
    t2 = torch.as_tensor(rng.uniform(0, 10, (R, T))).to(dtype)
    cand = torch.as_tensor(rng.uniform(0, 10, (R, T))).to(dtype)
    assert (torch.diff(g.offsets) > 2 * PAIR_TILE).any()
    for intensities in (False, True):
        want = _emulated_gain(emulated[csr_cycle.SOURCE], g, reads, eumaps,
                              t2, cand, intensities)
        got = _emulated_gain(emulated[PAIR_TMA], g, reads, eumaps, t2, cand,
                             intensities)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
    s_t2, s_cand = (segment_sum.segment_sum_ref(a, g.mult, g.idx, g.offsets)
                    for a in (t2, cand))
    assert torch.equal(got[1], s_t2) and torch.equal(got[2], s_cand)


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
@pytest.mark.parametrize("lanes", segment_sum.LANES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_csr_cycle_source_matches_plain(emulated, dtype, lanes, per_row):
    """The four kernels of csrc/csr_cycle.cu on one cycle of a random
    problem at R = 3 (reads and eumaps shared or a row each; every lane
    count of the EM steps): pair_gain's intensities (tiles of 16 segments,
    a segment of more edges than a tile stages among them), cycle_extrap,
    cycle_select and block_end's theta and intensities bit-equal to their
    plain versions, the gain terms so but for the log1p tolerance;
    cycle_extrap also on rows whose v is 0 (alpha -1) and whose alpha is
    NaN, cycle_select and block_end on NaN and signed-zero gains."""
    rng = np.random.default_rng(lanes + 11 * per_row)
    problem = _sum_problem(rng)
    p = solver.problem_to_device(problem, torch.device("cpu"), dtype)
    g = dataclasses.replace(p.by_cid, lanes=lanes)
    R, C, T = 3, len(problem.eumaps), problem.n_transcripts
    reads, eumaps, inv_denom = p.reads, p.eumaps, p.inv_denom
    if per_row:
        reads = torch.stack([reads * k for k in (1, 2, 0.5)])
        eumaps = torch.stack([eumaps.roll(k) for k in range(R)])
        inv_denom = torch.stack([inv_denom.roll(k) for k in range(R)])
    theta = rng.uniform(0, 10, (R, T))
    theta[:, rng.random(T) < 0.2] = 0.0
    theta = torch.as_tensor(theta).to(dtype)
    theta[2] = 0.0  # t1 = t2 = theta: r = v = 0
    t1 = segment_sum.em_step_ref(theta, p.by_cid, p.by_tid, reads, inv_denom)
    t2, r_sq, v_sq = segment_sum.em_step_cycle_ref(
        t1, theta, p.by_cid, p.by_tid, reads, inv_denom)
    rs = torch.sum(r_sq, dim=1, keepdim=True)
    vs = torch.sum(v_sq, dim=1, keepdim=True)
    assert vs[2, 0] == 0
    lib = emulated[csr_cycle.SOURCE]
    for r_sum, v_sum in [(rs, vs), _special_sums(R, dtype)]:
        got = _emulated_extrap(lib, theta, t1, t2, r_sum, v_sum)
        want = csr_cycle.cycle_extrap_ref(theta, t1, t2, r_sum, v_sum)
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    x = csr_cycle.cycle_extrap_ref(theta, t1, t2, rs, vs)
    cand = segment_sum.em_step_ref(x, p.by_cid, p.by_tid, reads, inv_denom)
    s_t2, s_cand = (segment_sum.segment_sum_ref(a, g.mult, g.idx, g.offsets)
                    for a in (t2, cand))
    want = csr_cycle.gain_terms(reads, eumaps, s_t2, s_cand)
    assert (torch.diff(g.offsets) > 2 * PAIR_TILE).any()
    got, none, _ = _emulated_gain(lib, g, reads, eumaps, t2, cand,
                                  intensities=False)
    assert none is None
    _log1p_tolerance(got, want, reads, s_t2, s_cand)
    got, s_o, s_n = _emulated_gain(lib, g, reads, eumaps, t2, cand)
    assert torch.equal(s_o, s_t2) and torch.equal(s_n, s_cand)
    _log1p_tolerance(got, want, reads, s_t2, s_cand)
    s_prev = segment_sum.segment_sum_ref(theta, g.mult, g.idx, g.offsets)
    for gain in [torch.sum(want, dim=-1), *_special_gains(R, dtype)]:
        got = _emulated_select(lib, gain, cand, t2)
        assert torch.equal(got, csr_cycle.cycle_select_ref(gain, cand, t2))
        end = csr_cycle.block_end_ref(gain, cand, t2, s_t2, s_cand, s_prev,
                                      reads, eumaps)
        out = _emulated_block_end(lib, gain, cand, t2, s_t2, s_cand, s_prev,
                                  reads, eumaps)
        assert torch.equal(out[0], end[0]) and torch.equal(out[1], end[1])
        _log1p_tolerance(out[2], end[2], reads, s_prev, end[1])
        out = _emulated_block_end(lib, gain, cand, t2, s_t2, s_cand, None,
                                  reads, eumaps)
        assert torch.equal(out[1], end[1]) and out[2] is None


def _emulated_extrap(lib, theta, t1, t2, r_sum, v_sum, out=None):
    """The emulated cycle_extrap launch, into ``out`` (a fresh tensor of
    7s by default)."""
    fn = (lib.emsar_cycle_extrap_f64 if theta.dtype == torch.float64
          else lib.emsar_cycle_extrap_f32)
    fn.restype = ctypes.c_int
    fn.argtypes = csr_cycle.EXTRAP_ARGTYPES
    out = torch.full_like(theta, 7.0) if out is None else out
    R, T = theta.shape
    assert fn(theta.data_ptr(), t1.data_ptr(), t2.data_ptr(),
              r_sum.data_ptr(), v_sum.data_ptr(), out.data_ptr(), R, T,
              None) == 0
    return out


def _emulated_select(lib, gain, cand, t2, out=None):
    """The emulated cycle_select launch, into ``out`` (a fresh tensor of
    7s by default)."""
    fn = (lib.emsar_cycle_select_f64 if cand.dtype == torch.float64
          else lib.emsar_cycle_select_f32)
    fn.restype = ctypes.c_int
    fn.argtypes = csr_cycle.SELECT_ARGTYPES
    out = torch.full_like(cand, 7.0) if out is None else out
    R, T = cand.shape
    assert fn(gain.data_ptr(), cand.data_ptr(), t2.data_ptr(),
              out.data_ptr(), R, T, None) == 0
    return out


def _special_sums(R, dtype):
    """Row sums [R, 1] of r * r and v * v whose step length is NaN (a NaN
    sum), NaN (inf / inf) and -1 (v * v summing to 0), the first R."""
    return (torch.tensor([[np.nan], [np.inf], [4.0]], dtype=dtype)[:R],
            torch.tensor([[1.0], [np.inf], [0.0]], dtype=dtype)[:R])


def _special_gains(R, dtype):
    """Gains [R] on the accept's edges: NaN (t2), -0.0 (cand), the least
    negative (t2), 0, 1 (cand) and -inf (t2), R a tensor."""
    vals = [np.nan, -0.0, -1e-300, 0.0, 1.0, -np.inf]
    return [torch.tensor(vals[i:i + R], dtype=dtype)
            for i in range(0, len(vals) - R + 1, R)]


def _placed(t, shift):
    """A contiguous copy of ``t`` that starts ``shift`` elements into its
    allocation."""
    buf = torch.full((t.numel() + shift,), 7.0, dtype=t.dtype)
    buf[shift:] = t.reshape(-1)
    return buf[shift:].view(t.shape)


@pytest.mark.parametrize("layout", ["aligned", "shifted", "apart"])
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("T", [1, 3, 5, 17, "runs"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_cycle_runs_match_plain(emulated, dtype, T, R, layout):
    """cycle_extrap and cycle_select of csrc/csr_cycle.cu bit-equal to
    their plain versions on every path of a block's run: rows of 1, 3, 5
    and 17 elements (less than a 16-byte line, a line and one more: loose
    elements before a row's first line and after its last; at R 3 rows
    that start inside a line) and of more than three blocks' runs; the
    arrays at the start of their allocations ("aligned"), all one element
    in (a loose head, "shifted") or each at its own offset within its
    16-byte lines (one-element vectors, "apart").  cycle_extrap on the
    true row sums and on sums that make the step length NaN or -1,
    cycle_select on gains NaN, -0.0, -1e-300, 0, 1 and -inf, both before
    the wait (both rows loaded early) and after it (above the emulated
    build's SELECT_EARLY_BYTES: the picked row alone); nothing written
    outside the rows."""
    item = torch.finfo(dtype).bits // 8
    T = 3 * RUN_BYTES // item + 5 if T == "runs" else T
    rng = np.random.default_rng(T + 7 * R)
    theta = rng.uniform(0, 10, (R, T))
    theta[:, rng.random(T) < 0.2] = 0.0
    t1 = theta * rng.uniform(0.5, 1.5, (R, T))
    t2 = t1 * rng.uniform(0.5, 1.5, (R, T)) - 0.5 * (rng.random((R, T))
                                                       < 0.1)
    theta, t1, t2 = (torch.as_tensor(a).to(dtype) for a in (theta, t1, t2))
    r, v = t1 - theta, t2 - t1 - (t1 - theta)
    sums = [(torch.sum(r * r, dim=1, keepdim=True),
             torch.sum(v * v, dim=1, keepdim=True)), _special_sums(R, dtype)]
    cand = torch.as_tensor(rng.uniform(0, 10, (R, T))).to(dtype)
    shifts = {"aligned": (0,) * 5, "shifted": (1,) * 5,
              "apart": (0, 1, 2, 3, 1)}[layout]
    th_, t1_, t2_, cand_ = (_placed(a, k) for a, k in zip(
        (theta, t1, t2, cand), shifts))
    lib = emulated[csr_cycle.SOURCE]
    for r_sum, v_sum in sums:
        buf = _placed(torch.full((R * T + 1,), 7.0, dtype=dtype), shifts[4])
        got = _emulated_extrap(lib, th_, t1_, t2_, r_sum, v_sum,
                               buf[:R * T].view(R, T))
        assert torch.equal(got, csr_cycle.cycle_extrap_ref(
            theta, t1, t2, r_sum, v_sum))
        assert buf[-1] == 7.0
    assert (R * T * item > SELECT_EARLY_BYTES) == (T > 17 and R == 3)
    for gain in _special_gains(R, dtype):
        buf = _placed(torch.full((R * T + 1,), 7.0, dtype=dtype), shifts[4])
        got = _emulated_select(lib, gain, cand_, t2_, buf[:R * T].view(R, T))
        assert torch.equal(got, csr_cycle.cycle_select_ref(gain, cand, t2))
        assert buf[-1] == 7.0


def _collapse_problem(rng):
    """``_sum_problem`` with one more module: segments A = {a, b} (100
    reads) and B = {b} (no reads, EUMAp 1e4).  From b at 1 and a at 1e15
    (1e7 in float32) one EM step takes B's intensity below the float's
    resolution of 1 (its gain term is then 0 * log1p(-1) = NaN) and A's
    to 100 / a of its level (a finite term)."""
    base = _sum_problem(rng)
    C, T = len(base.eumaps), base.n_transcripts
    cid = np.concatenate([base.edge_cid, [C, C, C + 1]]).astype(np.int32)
    tid = np.concatenate([base.edge_tid, [T, T + 1, T + 1]]).astype(np.int32)
    mult = np.concatenate([base.edge_mult, np.ones(3)])
    eumaps = np.concatenate([base.eumaps, [1.0, 1e4]])
    reads = np.concatenate([base.reads, [100.0, 0.0]]).astype(np.float64)
    denom = np.concatenate([base.denom, [1.0, 1.0 + 1e4]])
    return solver.SolverProblem(n_transcripts=T + 2, edge_cid=cid,
                                edge_tid=tid, edge_mult=mult, eumaps=eumaps,
                                reads=reads, denom=denom)


def _cluster_inputs(R, dtype, per_row, seed, tiles=(1, 8), rows=1):
    """(TilePlan on the CPU of ``tiles`` (tiles a row, blocks a cluster),
    ``rows`` rows a cluster, theta [R, T], reads, eumaps, inv_denom): one
    shared row of the operands, or a row each; theta with zeros, its last
    row all zero when R > 1 (r = v = 0: alpha -1)."""
    rng = np.random.default_rng(R + 7 * seed + 3 * per_row)
    problem = _collapse_problem(rng)
    p = solver.problem_to_device(problem, torch.device("cpu"), dtype)
    plan = csr_cluster.tile_plan(p.by_cid, p.by_tid, *tiles, rows=rows)
    C, T = len(problem.eumaps), problem.n_transcripts
    reads, eumaps, inv_denom = p.reads, p.eumaps, p.inv_denom
    if per_row:
        k = torch.as_tensor(rng.uniform(0.5, 2, (R, 1))).to(dtype)
        reads = (reads * k).contiguous()
        eumaps = torch.stack([eumaps.roll(i) for i in range(R)])
        inv_denom = torch.stack([inv_denom.roll(i) for i in range(R)])
    theta = rng.uniform(0, 10, (R, T))
    theta[:, rng.random(T) < 0.2] = 0.0
    if R > 1:
        theta[-1] = 0.0
    return plan, torch.as_tensor(theta).to(dtype), reads, eumaps, inv_denom


def _ptr(t):
    return None if t is None else t.data_ptr()


def _cluster_fn(lib, name, dtype, argtypes):
    fn = getattr(lib, f"emsar_cluster_{name}_"
                 + ("f64" if dtype == torch.float64 else "f32"))
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def emulated_em_pair(lib, src, plan, reads, inv_denom):
    """The emulated cluster_em_pair: (theta, t1, t2, r * r, v * v)."""
    like = src if isinstance(src, torch.Tensor) else src[1]
    theta, (gain, cand, t2p) = ((src, (None,) * 3)
                                if isinstance(src, torch.Tensor)
                                else (None, src))
    R, T = like.shape
    C = plan.by_cid.n_groups
    theta_out, t1, t2, rr, vv = (torch.full_like(like, 7.0)
                                 for _ in range(5))
    fn = _cluster_fn(lib, "em_pair", like.dtype,
                     csr_cluster.EM_PAIR_ARGTYPES)
    assert fn(_ptr(theta), _ptr(gain), _ptr(cand), _ptr(t2p), *plan.args(),
              reads.data_ptr(), inv_denom.data_ptr(), theta_out.data_ptr(),
              t1.data_ptr(), t2.data_ptr(), rr.data_ptr(), vv.data_ptr(), R,
              T, plan.n_tiles, plan.rows, plan.smem,
              C if reads.dim() == 2 else 0, T if inv_denom.dim() == 2 else 0,
              plan.cluster, None) == 0
    if theta is not None:
        assert torch.all(theta_out == 7.0)  # not written
    return (theta if theta is not None else theta_out), t1, t2, rr, vv


def emulated_extrap_gain(lib, theta, t1, t2, rs, vs, plan, reads, eumaps,
                         inv_denom, intensities=False, skip_unread=False):
    """The emulated cluster_extrap_gain: (cand, gain terms), and with
    ``intensities`` t2's and cand's intensities too."""
    R, T = theta.shape
    C = plan.by_cid.n_groups
    cand = torch.full_like(theta, 7.0)
    terms = torch.full((R, C), 7.0, dtype=theta.dtype)
    s_pair = ((torch.full_like(terms, 7.0), torch.full_like(terms, 7.0))
              if intensities else (None, None))
    fn = _cluster_fn(lib, "extrap_gain", theta.dtype,
                     csr_cluster.EXTRAP_GAIN_ARGTYPES)
    assert fn(theta.data_ptr(), t1.data_ptr(), t2.data_ptr(), rs.data_ptr(),
              vs.data_ptr(), *plan.args(), reads.data_ptr(),
              eumaps.data_ptr(), inv_denom.data_ptr(), cand.data_ptr(),
              terms.data_ptr(), *(_ptr(t) for t in s_pair), R, C, T,
              plan.n_tiles, plan.rows, plan.smem,
              C if reads.dim() == 2 else 0, T if inv_denom.dim() == 2 else 0,
              plan.cluster, int(skip_unread), None) == 0
    return (cand, terms, *s_pair) if intensities else (cand, terms)


def _extrap_gain_ieee(theta, t1, t2, rs, vs, p, reads, eumaps, inv_denom):
    """``csr_cluster.extrap_gain_ref`` with the step length's square roots
    correctly rounded (NumPy's), as CUDA's and the emulated kernel's are:
    torch's CPU sqrt may be an ulp off.  The rest is the plain version's
    own lines."""
    rnorm, vnorm = (torch.as_tensor(np.sqrt(a.numpy())) for a in (rs, vs))
    alpha = torch.clamp(torch.where(
        vnorm > 0, -rnorm / torch.where(vnorm > 0, vnorm, 1.0), -1.0),
        max=-1.0)
    r = t1 - theta
    v = t2 - t1 - r
    extrap = theta - 2.0 * alpha * r + (alpha * alpha) * v
    cand = segment_sum.em_step_ref(torch.where(extrap > 0, extrap, t2),
                                   p.by_cid, p.by_tid, reads, inv_denom)
    return cand, csr_cycle.pair_gain_ref(p.by_cid, reads, eumaps, t2, cand)


CLUSTER_CASES = [(1, torch.float64, False), (3, torch.float32, False),
                 (3, torch.float64, False), (16, torch.float64, True)]
CLUSTER_IDS = ["R1-f64", "R3-f32", "R3-f64", "R16-f64-per_row"]


# (tiles a row, blocks a cluster): one tile of a cluster of 8 (a whole
# row), and three tiles of clusters of 2
TILINGS = [(1, 8), (3, 2)]
TILING_IDS = ["1x8", "3x2"]


@pytest.mark.parametrize("tiles", TILINGS, ids=TILING_IDS)
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("R,dtype,per_row", CLUSTER_CASES, ids=CLUSTER_IDS)
def test_cluster_em_pair_source_matches_plain(emulated, R, dtype, per_row,
                                              seed, tiles):
    """cluster_em_pair, its clusters' blocks run together behind the
    emulated cluster barrier: theta, t1, t2, r * r and v * v bit-equal to
    ``em_pair_ref``, from theta and from a previous cycle's accept with
    NaN, -0, negative and positive gains."""
    p, theta, reads, eumaps, inv_denom = _cluster_inputs(R, dtype, per_row,
                                                         seed, tiles)
    lib = emulated[csr_cluster.SOURCE]
    want = csr_cluster.em_pair_ref(theta, p.by_cid, p.by_tid, reads,
                                   inv_denom)
    got = emulated_em_pair(lib, theta, p, reads, inv_denom)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (want[3] > 0).any() and (want[4] > 0).any()
    rng = np.random.default_rng(R)
    cand = torch.as_tensor(rng.uniform(0, 5, theta.shape)).to(dtype)
    gain = torch.tensor([np.nan, -0.0, -1e-300, 2.0] * 4,
                        dtype=dtype)[:R].contiguous()
    src = (gain, cand, want[2])
    want = csr_cluster.em_pair_ref(src, p.by_cid, p.by_tid, reads, inv_denom)
    got = emulated_em_pair(lib, src, p, reads, inv_denom)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("tiles", TILINGS, ids=TILING_IDS)
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("R,dtype,per_row", CLUSTER_CASES, ids=CLUSTER_IDS)
def test_cluster_extrap_gain_source_matches_plain(emulated, R, dtype,
                                                  per_row, seed, tiles):
    """cluster_extrap_gain on one cycle's t1, t2 and step-length sums: cand
    bit-equal to the plain version's (``_extrap_gain_ieee``: its square
    roots correctly rounded), the gain terms so but for the log1p
    tolerance, and with the intensities asked for (a block's last cycle)
    t2's and cand's bit-equal to their segment sums; also on rows whose
    step length is NaN (kept by the clamp), inf / inf, or whose v is 0
    (alpha -1)."""
    p, theta, reads, eumaps, inv_denom = _cluster_inputs(R, dtype, per_row,
                                                         seed, tiles)
    lib = emulated[csr_cluster.SOURCE]
    _, t1, t2, r_sq, v_sq = csr_cluster.em_pair_ref(
        theta, p.by_cid, p.by_tid, reads, inv_denom)
    rs = torch.sum(r_sq, dim=1, keepdim=True)
    vs = torch.sum(v_sq, dim=1, keepdim=True)
    odd = torch.tensor([[np.nan, 1.0], [np.inf, np.inf], [4.0, 0.0]] * 6,
                       dtype=dtype)[:R]
    for r_sum, v_sum in ((rs, vs), (odd[:, :1].contiguous(),
                                    odd[:, 1:].contiguous())):
        args = (theta, t1, t2, r_sum, v_sum)
        want = _extrap_gain_ieee(*args, p, reads, eumaps, inv_denom)
        got = emulated_extrap_gain(lib, *args, p, reads, eumaps, inv_denom,
                                   intensities=True)
        assert torch.equal(got[0].nan_to_num(), want[0].nan_to_num())
        assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
        s_t2, s_cand = (segment_sum.segment_sum_ref(
            a, p.by_cid.mult, p.by_cid.idx, p.by_cid.offsets)
            for a in (t2, want[0]))
        _log1p_tolerance(got[1], want[1], reads, s_t2, s_cand)
        assert torch.equal(got[2], s_t2)
        assert torch.equal(got[3].nan_to_num(), s_cand.nan_to_num())
        assert torch.equal(torch.isnan(got[3]), torch.isnan(s_cand))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_cluster_kernels_nan_branches(emulated, dtype):
    """The NaN cases the CSR stop depends on, through both cluster
    kernels: a read-less segment whose intensity collapses from t2 to cand
    (0 * log1p(-1)) makes a NaN gain term and a NaN gain, and the next
    cycle's em_pair then takes t2 in that row, as cycle_select does."""
    p, theta, reads, eumaps, inv_denom = _cluster_inputs(3, dtype, False, 2,
                                                         (2, 4))
    T = theta.shape[1]
    big = 1e15 if dtype == torch.float64 else 1e7
    theta[0, T - 2:] = torch.tensor([big, 1.0], dtype=dtype)
    theta[1, T - 2:] = torch.tensor([1.0, 1.0], dtype=dtype)
    zero = torch.zeros((3, 1), dtype=dtype)
    lib = emulated[csr_cluster.SOURCE]
    args = (theta, theta, theta, zero, zero)  # alpha -1: x = theta
    want = csr_cluster.extrap_gain_ref(*args, p.by_cid, p.by_tid, reads,
                                       eumaps, inv_denom)
    got = emulated_extrap_gain(lib, *args, p, reads, eumaps, inv_denom)
    assert torch.equal(got[0], want[0])
    nan = torch.isnan(want[1])
    assert nan[0, -1] and not nan[1:].any()
    s_old, s_new = (segment_sum.segment_sum_ref(
        a, p.by_cid.mult, p.by_cid.idx, p.by_cid.offsets)
        for a in (theta, want[0]))
    _log1p_tolerance(got[1], want[1], reads, s_old, s_new)
    gain = torch.sum(got[1], dim=-1)
    assert torch.isnan(gain[0]) and not torch.isnan(gain[1:]).any()
    src = (gain, got[0], theta * 2)
    want = csr_cluster.em_pair_ref(src, p.by_cid, p.by_tid, reads, inv_denom)
    out = emulated_em_pair(lib, src, p, reads, inv_denom)
    assert torch.equal(out[0][0], theta[0] * 2)
    for g, w in zip(out, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_gain_term_source_skips_unread(emulated, dtype):
    """``skip_unread``: every branch of the gain term, through pair_gain
    and block_end, with the read term of segments without reads left out:
    finite wherever the intensities are (the read-less collapses of
    ``gain_branch_cases`` are NaN without it), the plain version's bits
    with the same option but for the log1p tolerance, and the JAX
    package's terms on every read-bearing segment."""
    s_old, s_new, reads, eumaps = gain_branch_cases(dtype)
    g = _identity_groups(s_old.shape[1], dtype)
    lib = emulated[csr_cycle.SOURCE]
    want = csr_cycle.gain_terms(reads, eumaps, s_old, s_new, True)
    jax = csr_cycle.gain_terms(reads, eumaps, s_old, s_new)
    finite = ~(torch.isnan(s_old) | torch.isnan(s_new))
    assert torch.isfinite(want[finite]).all()
    assert torch.isnan(jax[finite]).any()
    assert torch.equal(want[reads > 0].nan_to_num(),
                       jax[reads > 0].nan_to_num())
    got, _, _ = _emulated_gain(lib, g, reads, eumaps, s_old, s_new,
                               skip_unread=True)
    _log1p_tolerance(got, want, reads, s_old, s_new, True)
    gain = torch.zeros((s_new.shape[0],), dtype=dtype)
    _, _, got = _emulated_block_end(lib, gain, s_new, s_new, s_new, s_new,
                                    s_old, reads, eumaps, skip_unread=True)
    _log1p_tolerance(got, want, reads, s_old, s_new, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_squarem_source_skips_unread(emulated, dtype):
    """The dense kernel with ``skip_unread`` on modules of which the first
    holds a read-less segment that collapses in a cycle (``kernel5``'s
    accept gain is then NaN): the plain version's theta with the same
    option, within the kernel's agreement rule."""
    B, C, T, n_iters = 5, 32, 8, 3
    rng = np.random.default_rng(5)
    args = [torch.as_tensor(a).to(dtype) for a in random_modules(rng, B, C, T)]
    m, eumaps, reads, inv_denom, theta = args
    # module 0: segments {t0, t1} (100 reads) and {t1} (no reads, a large
    # EUMAp): an EM step cuts t1 by that factor, more than the precision
    big = 1e17 if dtype == torch.float64 else 1e8
    m[0], eumaps[0], reads[0], theta[0] = 0.0, 0.0, 0.0, 0.0
    m[0, 0, :2] = m[0, 1, 1] = 1.0
    eumaps[0, :2] = torch.tensor([1.0, big], dtype=dtype)
    reads[0, 0] = 100.0
    theta[0, :2] = torch.tensor([100.0, 1.0], dtype=dtype)
    denom = torch.sum(m * eumaps[:, :, None], dim=1)
    inv_denom.copy_(torch.where(denom > 0, 1.0 / torch.where(
        denom > 0, denom, 1.0), 0.0))
    _, gain, _ = squarem.squarem_cycle_ref(*args)
    _, fixed, _ = squarem.squarem_cycle_ref(*args, True)
    assert torch.isnan(gain[0]) and torch.isfinite(fixed).all()
    lib = emulated[squarem.SOURCE]
    fn = (lib.emsar_squarem_block_f64 if dtype == torch.float64
          else lib.emsar_squarem_block_f32)
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    out = torch.empty_like(theta)
    assert fn(*(a.data_ptr() for a in args), out.data_ptr(), B, C, T,
              n_iters, 1, None) == 0
    want = squarem.squarem_block_ref(*args, n_iters, True)
    err, _, n = block_agreement(out, want, *args, n_iters, True)
    assert n >= 1 and torch.isfinite(out).all()
    assert err <= block_tol(dtype, n_iters), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_cluster_kernels_skip_unread(emulated, dtype):
    """``test_cluster_kernels_nan_branches``' collapse with ``skip_unread``
    through cluster_extrap_gain: the collapsing read-less segment's term
    is -eumaps * (s_new - s_old), finite, and every term the plain
    version's with the same option."""
    p, theta, reads, eumaps, inv_denom = _cluster_inputs(3, dtype, False, 2,
                                                         (2, 4))
    T = theta.shape[1]
    big = 1e15 if dtype == torch.float64 else 1e7
    theta[0, T - 2:] = torch.tensor([big, 1.0], dtype=dtype)
    theta[1, T - 2:] = torch.tensor([1.0, 1.0], dtype=dtype)
    zero = torch.zeros((3, 1), dtype=dtype)
    lib = emulated[csr_cluster.SOURCE]
    args = (theta, theta, theta, zero, zero)  # alpha -1: x = theta
    jax = csr_cluster.extrap_gain_ref(*args, p.by_cid, p.by_tid, reads,
                                      eumaps, inv_denom)
    want = csr_cluster.extrap_gain_ref(*args, p.by_cid, p.by_tid, reads,
                                       eumaps, inv_denom, skip_unread=True)
    got = emulated_extrap_gain(lib, *args, p, reads, eumaps, inv_denom,
                               skip_unread=True)
    assert torch.isnan(jax[1][0, -1]) and torch.isfinite(want[1]).all()
    assert torch.equal(got[0], want[0])
    s_old, s_new = (segment_sum.segment_sum_ref(
        a, p.by_cid.mult, p.by_cid.idx, p.by_cid.offsets)
        for a in (theta, want[0]))
    _log1p_tolerance(got[1], want[1], reads, s_old, s_new, True)
    assert torch.isfinite(torch.sum(got[1], dim=-1)).all()


# (R, dtype, a row of operands each) of the distributed-read cases
SPREAD_CASES = [(1, torch.float32, False), (1, torch.float64, False),
                (3, torch.float32, False), (3, torch.float64, False),
                (16, torch.float32, True), (16, torch.float64, True)]
SPREAD_IDS = ["R1-f32", "R1-f64", "R3-f32", "R3-f64", "R16-f32-per_row",
              "R16-f64-per_row"]


@pytest.mark.parametrize("rows", ["row", "all_rows"])
@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("R,dtype,per_row", SPREAD_CASES, ids=SPREAD_IDS)
def test_cluster_kernels_read_other_blocks(emulated, R, dtype, per_row,
                                           cluster, rows):
    """Both cluster kernels with each tile spread over a cluster's blocks
    (two tiles of 1, 2 or 4 blocks), so that a gather reads another
    block's vectors through the emulated distributed shared memory, a
    cluster taking a row or all R rows: cluster_em_pair from theta and
    from an accept bit-equal to ``em_pair_ref``, cluster_extrap_gain's
    cand bit-equal to the plain version's and its gain terms so but for
    the log1p tolerance."""
    p, theta, reads, eumaps, inv_denom = _cluster_inputs(
        R, dtype, per_row, cluster, (2, cluster),
        rows=1 if rows == "row" else R)
    local = p.cid.local.numpy().astype(np.int64) >> csr_cluster.RANK_SHIFT
    assert (local > 0).any() == (cluster > 1)
    lib = emulated[csr_cluster.SOURCE]
    want = csr_cluster.em_pair_ref(theta, p.by_cid, p.by_tid, reads,
                                   inv_denom)
    got = emulated_em_pair(lib, theta, p, reads, inv_denom)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, t1, t2, r_sq, v_sq = want
    args = (theta, t1, t2, torch.sum(r_sq, dim=1, keepdim=True),
            torch.sum(v_sq, dim=1, keepdim=True))
    want_x = _extrap_gain_ieee(*args, p, reads, eumaps, inv_denom)
    cand, terms, got_t2, got_cand = emulated_extrap_gain(
        lib, *args, p, reads, eumaps, inv_denom, intensities=True)
    assert torch.equal(cand, want_x[0])
    s_t2, s_cand = (segment_sum.segment_sum_ref(
        a, p.by_cid.mult, p.by_cid.idx, p.by_cid.offsets)
        for a in (t2, cand))
    _log1p_tolerance(terms, want_x[1], reads, s_t2, s_cand)
    assert torch.equal(got_t2, s_t2) and torch.equal(got_cand, s_cand)
    gain = torch.sum(want_x[1], dim=-1)
    gain[0] = -1.0  # row 0 takes t2
    src = (gain, cand, t2)
    want = csr_cluster.em_pair_ref(src, p.by_cid, p.by_tid, reads, inv_denom)
    got = emulated_em_pair(lib, src, p, reads, inv_denom)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
