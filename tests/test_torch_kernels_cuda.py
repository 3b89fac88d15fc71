"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  These need an NVIDIA GPU with nvcc and skip elsewhere (a CUDA
kernel has no interpret mode).  This file imports no JAX, so it also runs
where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from emsar_tpu.io.fasta import build_transcriptome
from emsar_tpu.sim import gene_family_transcriptome
from emsar_tpu_torch.index.device_build import DeviceRef
from emsar_tpu_torch.kernels import segment_sum as ssum
from emsar_tpu_torch.kernels import squarem, window_hash
from emsar_tpu_torch.kernels.check import (block_agreement, block_tol,
                                           random_modules)
from emsar_tpu_torch.model.dense import SIZE_CLASSES

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n_iters", [1, 8], ids=["cycle", "block"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("C,T", SIZE_CLASSES,
                         ids=[f"{c}x{t}" for c, t in SIZE_CLASSES])
def test_squarem_kernel_matches_plain(cuda, C, T, dtype, n_iters):
    rng = np.random.default_rng(C + T)
    args = [torch.as_tensor(a).to(cuda, dtype)
            for a in random_modules(rng, 64, C, T)]
    before = squarem.LAUNCHES
    got = squarem.squarem_block(*args, n_iters)
    torch.cuda.synchronize()
    assert squarem.LAUNCHES == before + 1
    want = squarem.squarem_block_ref(*args, n_iters)
    err, _, n = block_agreement(got, want, *args, n_iters)
    assert n >= 32
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


@pytest.mark.parametrize("unstranded", [True, False], ids=["ns", "ss"])
@pytest.mark.parametrize("rl", [15, 16, 20, 33, 76])
def test_window_hash_kernel_bit_equal(cuda, rl, unstranded):
    rng = np.random.default_rng(rl)
    names, seqs, _ = gene_family_transcriptome(rng, 40)
    seqs[3] = seqs[3][:50] + b"N" + seqs[3][51:]
    ref = DeviceRef(build_transcriptome(names, seqs), cuda)
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


def _csr(rng, n_seg, n_x, E):
    seg = np.sort(rng.integers(0, n_seg, E))
    off = np.zeros(n_seg + 1, dtype=np.int64)
    np.cumsum(np.bincount(seg, minlength=n_seg), out=off[1:])
    return rng.integers(0, n_x, E), off


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_segment_sum_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(9)
    idx, off = _csr(rng, 5000, 3000, 60000)
    x = torch.as_tensor(rng.uniform(0, 10, (3, 3000))).to(cuda, dtype)
    w = torch.as_tensor(rng.integers(1, 3, 60000) * 1.0).to(cuda, dtype)
    t = [torch.as_tensor(a).to(cuda) for a in (idx, off)]
    before = ssum.LAUNCHES
    a = ssum.segment_sum(x, w, *t)
    b = ssum.segment_sum(x, w, *t)
    torch.cuda.synchronize()
    assert ssum.LAUNCHES == before + 2
    assert torch.equal(a, b)  # no atomics: the same bits every launch
    want = ssum.segment_sum_ref(x, w, *t)
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    torch.testing.assert_close(a, want, rtol=tol, atol=0)
