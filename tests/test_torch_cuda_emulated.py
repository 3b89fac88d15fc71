"""The CUDA sources of the port run on the CPU against their plain
versions: each ``csrc/*.cu`` is built with g++ against
``tests/cuda_emu/cuda_runtime.h``, which emulates the threads, barriers
and shuffles the kernels use (one std::thread per CUDA thread), and its
``extern "C"`` launcher is called through ctypes on CPU tensors.  This
holds the kernels' index arithmetic, tiling, staging and reductions on
every CPU run; that nvcc builds them and what they cost on the card are
for ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from emsar_tpu_torch.index.device_build import DeviceRef
from emsar_tpu_torch.io.fasta import build_transcriptome
from emsar_tpu_torch.kernels import _build, squarem, window_hash
from emsar_tpu_torch.kernels.check import (block_agreement, block_tol,
                                           random_modules)
from emsar_tpu_torch.model.dense import SIZE_CLASSES
from emsar_tpu_torch.sim import gene_family_transcriptome

EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "cuda_emu")
TILE = 2048  # window starts per thread block (csrc/window_hash.cu kTile)


def _emulated_source(text: str) -> str:
    """The CUDA source with each launch as a call of emu_launch."""
    text = text.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = emu_dyn_smem;")
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
        out.append(f"{text[i:k]}\n    emu_launch({cfg[0]}, {cfg[1]}, "
                   f"{cfg[2] if len(cfg) > 2 else 0}, [&] {{ "
                   f"{text[k:j].strip()}({text[e + 4:p - 1]}); }})")
        i = p
    return "".join(out) + text[i:]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{source: its library built for the CPU emulation}."""
    libs = {}
    for source in (window_hash.SOURCE, squarem.SOURCE):
        with open(os.path.join(_build.CSRC_DIR, source)) as fh:
            text = _emulated_source(fh.read())
        cc = tmp_path_factory.mktemp("emu") / (source + ".cc")
        cc.write_text(text)
        so = str(cc) + ".so"
        subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", "-I", EMU_DIR, "-o", so, str(cc)],
                       check=True)
        libs[source] = ctypes.CDLL(so)
    return libs


def test_launches_are_rewritten():
    src = ("  k<F, 1><<<(unsigned)B, 128, smem,\n stream>>>(a, f(b), c);\n"
           "  return 0;")
    got = _emulated_source(src)
    assert "<<<" not in got
    assert re.search(r"emu_launch\(\(unsigned\)B, 128, smem, \[&\] \{ "
                     r"k<F, 1>\(a, f\(b\), c\); \}\)", got)


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
        ctypes.c_void_p]
    assert fn(*(a.data_ptr() for a in args), out.data_ptr(), B, C, T,
              n_iters, None) == 0
    want = squarem.squarem_block_ref(*args, n_iters)
    err, _, n = block_agreement(out, want, *args, n_iters)
    assert n >= 1 and torch.isfinite(out).all()
    assert err <= block_tol(dtype, n_iters), err
