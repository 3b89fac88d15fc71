"""The dense SQUAREM block: hand-written CUDA kernel and its plain version.

``squarem_block`` runs ``n_iters`` stabilized SQUAREM cycles on every
padded module of a dense size class and returns the new theta.  It
replaces the Pallas TPU kernel ``emsar_tpu/model/dense.py::_pallas_block``
(kernel body ``kernel5``); the CUDA source is ``csrc/squarem_block.cu``,
built for ``sm_90a`` at first use (``kernels/_build.py``).  The classes
(32, 8) and (64, 16) run one warp per module with M and theta in
registers; (128, 32) one block per module with M staged in shared memory;
larger classes one block per module reading M from L1/L2.  Theta stays on
the SM across all cycles.  What bounds each class on the H100 is written
in the source.

On a CPU tensor the wrapper computes ``squarem_block_ref``, the plain
PyTorch version written like ``kernel5`` (elementwise product and sum).
On a CUDA tensor it launches the kernel or raises; it never falls back.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

SOURCE = "squarem_block.cu"
LAUNCHES = 0


def _em_ref(m, reads, inv_denom, th):
    s = torch.sum(m * th[:, None, :], dim=2)
    pos = s > 0
    ratio = torch.where(pos, reads / torch.where(pos, s, 1.0), 0.0)
    num = torch.sum(m * ratio[:, :, None], dim=1)
    return th * num * inv_denom


def squarem_cycle_ref(m: torch.Tensor, eumaps: torch.Tensor,
                      reads: torch.Tensor, inv_denom: torch.Tensor,
                      theta: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One cycle of ``kernel5``'s body.  Returns (theta [B, T], gain [B],
    gain_scale [B]): the accept test's termwise likelihood gain and the sum
    of its terms' magnitudes, whose ratio says how far a module sat from
    the ``gain >= 0`` boundary."""
    t1 = _em_ref(m, reads, inv_denom, theta)
    t2 = _em_ref(m, reads, inv_denom, t1)
    r = t1 - theta
    v = t2 - t1 - r
    rn = torch.sqrt(torch.sum(r * r, dim=1, keepdim=True))
    vn = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
    alpha = torch.clamp(
        torch.where(vn > 0, -rn / torch.where(vn > 0, vn, 1.0), -1.0),
        max=-1.0)
    # zero-crossing coordinates fall back to the plain double-EM value
    # (exact 0 is absorbing for multiplicative EM)
    extrap = theta - 2.0 * alpha * r + alpha * alpha * v
    cand = _em_ref(m, reads, inv_denom, torch.where(extrap > 0, extrap, t2))
    lam2 = torch.sum(m * t2[:, None, :], dim=2)
    lamc = torch.sum(m * cand[:, None, :], dim=2)
    both = (lam2 > 0) & (lamc > 0)
    ratio = torch.log1p(torch.where(both, (lamc - lam2) /
                                    torch.where(both, lam2, 1.0), 0.0))
    died = (lam2 > 0) & (lamc <= 0) & (reads > 0)
    born = (lam2 <= 0) & (lamc > 0) & (reads > 0)
    # died and born exclude each other: kernel5's nested where
    term = torch.where(both, reads * ratio,
                       (born.to(theta.dtype) - died.to(theta.dtype)) * 1e30)
    delta = eumaps * (lamc - lam2)
    gain = torch.sum(term - delta, dim=1)
    scale = torch.sum(term.abs() + delta.abs(), dim=1)
    return torch.where((gain >= 0)[:, None], cand, t2), gain, scale


def squarem_block_ref(m: torch.Tensor, eumaps: torch.Tensor,
                      reads: torch.Tensor, inv_denom: torch.Tensor,
                      theta: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``n_iters`` cycles."""
    for _ in range(n_iters):
        theta, _, _ = squarem_cycle_ref(m, eumaps, reads, inv_denom, theta)
    return theta


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    for fn in (lib.emsar_squarem_block_f32, lib.emsar_squarem_block_f64):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
    return lib


def build() -> None:
    """Build and load the kernel library (no launch)."""
    _lib()


def squarem_block(m: torch.Tensor, eumaps: torch.Tensor, reads: torch.Tensor,
                  inv_denom: torch.Tensor, theta: torch.Tensor,
                  n_iters: int) -> torch.Tensor:
    """``n_iters`` SQUAREM cycles per module: m [B, C, T], eumaps/reads
    [B, C], inv_denom/theta [B, T], float32 or float64.  Returns theta."""
    global LAUNCHES
    if theta.device.type == "cpu":
        return squarem_block_ref(m, eumaps, reads, inv_denom, theta, n_iters)
    if theta.device.type != "cuda":
        raise ValueError(f"squarem_block: unsupported device {theta.device}")
    B, C, T = m.shape
    args = (m, eumaps, reads, inv_denom, theta)
    shapes = ((B, C, T), (B, C), (B, C), (B, T), (B, T))
    for name, x, shape in zip(("m", "eumaps", "reads", "inv_denom", "theta"),
                              args, shapes):
        if x.device != theta.device or x.dtype != theta.dtype:
            raise ValueError(f"squarem_block: {name} is {x.dtype} on "
                             f"{x.device}, theta {theta.dtype} on "
                             f"{theta.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"squarem_block: {name} must be a contiguous "
                             f"{shape} tensor, got {tuple(x.shape)}")
    if theta.dtype == torch.float32:
        fn = _lib().emsar_squarem_block_f32
    elif theta.dtype == torch.float64:
        fn = _lib().emsar_squarem_block_f64
    else:
        raise ValueError(f"squarem_block: unsupported dtype {theta.dtype}")
    out = torch.empty_like(theta)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    rc = fn(*(x.data_ptr() for x in args), out.data_ptr(), B, C, T,
            int(n_iters), stream)
    if rc != 0:
        raise RuntimeError(f"squarem_block: kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out
