"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  These need an NVIDIA GPU with nvcc and skip elsewhere (a CUDA
kernel has no interpret mode).  This file imports no JAX, so it also runs
where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from emsar_tpu_torch.kernels import squarem
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
