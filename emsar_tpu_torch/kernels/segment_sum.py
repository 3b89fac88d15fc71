"""Deterministic CSR segment sums: hand-written CUDA kernel and its plain
version.

``segment_sum(x, w, idx, offsets)`` returns ``out [R, G]`` with
``out[r, g] = sum of w[e] * x[r, idx[e]]`` over the edges ``e`` of segment
``g``; edges are grouped by segment, segment ``g`` holding the edges
``offsets[g]:offsets[g + 1]`` (``G = len(offsets) - 1``).  It carries both segment sums
of the CSR EM step (``model/solver.py``), in place of the
``jax.ops.segment_sum`` calls of ``emsar_tpu/model/solver.py::_em_solve``.
The CUDA source is ``csrc/segment_sum.cu`` (one thread per output, edges
summed in CSR order, no atomics; what bounds it is written there).

On a CPU tensor the wrapper computes ``segment_sum_ref``, the plain
``index_add_`` form, which adds edges sequentially in edge order on the
CPU.  On a CUDA tensor it launches the kernel or raises; it never falls
back (``index_add_`` on CUDA sums with float atomics, in an order that
changes between launches).  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

SOURCE = "segment_sum.cu"
LAUNCHES = 0


def segment_sum_ref(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of ``w * x[:, idx]`` by each
    edge's segment."""
    G = offsets.shape[0] - 1
    seg = torch.repeat_interleave(torch.arange(G, device=offsets.device),
                                  torch.diff(offsets))
    return x.new_zeros((x.shape[0], G)).index_add_(1, seg, w * x[:, idx])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    for fn in (lib.emsar_segment_sum_f32, lib.emsar_segment_sum_f64):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
            ctypes.c_void_p]
    return lib


def build() -> None:
    """Build and load the kernel library (no launch)."""
    _lib()


def segment_sum(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """Segment sums of ``w * x[:, idx]``: x [R, N] float32 or float64, w
    [E] of x's dtype, idx [E] and offsets [G + 1] int64."""
    global LAUNCHES
    if x.device.type == "cpu":
        return segment_sum_ref(x, w, idx, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"segment_sum: x must be a contiguous [R, N] "
                         f"tensor, got {tuple(x.shape)}")
    E = idx.shape[0]
    for name, t, dtype, n in (("w", w, x.dtype, E), ("idx", idx, torch.int64,
                                                     E),
                              ("offsets", offsets, torch.int64, None)):
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"segment_sum: {name} is {t.dtype} on "
                             f"{t.device}, want {dtype} on {x.device}")
        if t.dim() != 1 or not t.is_contiguous() or (
                n is not None and t.shape[0] != n):
            raise ValueError(f"segment_sum: {name} must be a contiguous 1-d "
                             f"tensor of {n or 'G + 1'} entries, got "
                             f"{tuple(t.shape)}")
    if x.dtype == torch.float32:
        fn = _lib().emsar_segment_sum_f32
    elif x.dtype == torch.float64:
        fn = _lib().emsar_segment_sum_f64
    else:
        raise ValueError(f"segment_sum: unsupported dtype {x.dtype}")
    R, N = x.shape
    G = offsets.shape[0] - 1
    out = torch.empty((R, G), dtype=x.dtype, device=x.device)
    if R * G == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w.data_ptr(), idx.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), R, G, N, stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum: kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out
