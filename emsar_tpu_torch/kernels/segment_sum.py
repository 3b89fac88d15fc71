"""Deterministic CSR segment sums and the CSR EM step: hand-written CUDA
kernel and its plain versions.

``segment_sum(x, w, idx, offsets)`` returns ``out [R, G]`` with
``out[r, g] = sum of w[e] * x[r, idx[e]]`` over the edges ``e`` of segment
``g``; edges are grouped by segment, segment ``g`` holding the edges
``offsets[g]:offsets[g + 1]`` (``G = len(offsets) - 1``).  ``em_step``
computes one EM step of the CSR solver (``model/solver.py::_em_iter``)
from two such sums, by cid and by tid, with the elementwise work in their
epilogues; ``em_step_cycle`` is the second EM step of a SQUAREM cycle,
whose epilogue also writes the squares of the cycle's r and v (the
step-length norms' summands).  Together they replace the
``jax.ops.segment_sum`` calls of
``emsar_tpu/model/solver.py::_em_solve``.  The CUDA source is
``csrc/segment_sum.cu`` (a group of lanes per output, products folded in
edge order, no atomics; what bounds it is written there).

``prepare`` checks an edge grouping once (device, dtype, contiguity,
offsets, index range), stores ``idx`` as int32, picks the lanes per
output and cuts the groups into the tiles ``csr_cycle.pair_gain``
stages (``tile_bounds``); ``sum_groups`` and ``em_step`` then launch
with no checks per call.  The public ``segment_sum`` prepares on every
call.

On CPU tensors the wrappers compute the plain versions (``segment_sum_ref``:
``index_add_``, which adds edges sequentially in edge order on the CPU;
``em_step_ref``, ``em_step_cycle_ref``: the torch body of the EM step
and of the cycle's lines it takes).  On CUDA tensors they
launch the kernel or raise; they never fall back (``index_add_`` on CUDA
sums with float atomics, in an order that changes between launches).  The
kernel gives the CPU plain versions' bits.  ``LAUNCHES`` counts plain-sum
launches, ``EM_LAUNCHES`` the launches of ``em_step`` and
``em_step_cycle`` (two per step).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from . import _build

SOURCE = "segment_sum.cu"
LAUNCHES = 0
EM_LAUNCHES = 0
LANES = (4, 8, 16, 32)
_PLAIN, _RATIO, _UPDATE = 0, 1, 2
# emsar_segment_sum_f32/f64(x, w, idx, offsets, a, b, out, R, G, N,
# a_stride, lanes, mode, stream)
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# emsar_em_cycle_update_f32/f64(x, w, idx, offsets, a, b, c, out, rr, vv,
# R, G, N, a_stride, lanes, stream)
CYCLE_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 4 + [
    ctypes.c_int, ctypes.c_void_p]
# Groups of a tile of ``csr_cycle.pair_gain`` at most, and edges before
# its last group fewer (csrc/csr_cycle.cu's EMSAR_PAIR_TILE): 512 f64
# edges take ~41 KB of a block's shared memory, and the smoke's CSR
# problem ~230 tiles, more blocks than the H100 has SMs.
TILE = 512


@dataclasses.dataclass
class EdgeGroups:
    """Edges grouped by one endpoint, checked for the kernel: the CSR
    ``offsets`` of the groups, the other endpoint ``idx`` (int32, in
    ``[0, n_x)``) and the weight ``mult``, both in grouped order, the
    kernel's ``lanes`` per output, and the groups cut into tiles of at
    most ``TILE`` (``tile_bounds``)."""

    offsets: torch.Tensor  # int64 [G + 1]
    idx: torch.Tensor  # int32 [E]
    mult: torch.Tensor  # [E]
    n_x: int
    lanes: int
    tiles: torch.Tensor  # int64 [2, n_tiles + 1]: group, edge bounds

    @property
    def n_groups(self) -> int:
        return self.offsets.shape[0] - 1


def lanes_for(n_edges: int, n_groups: int) -> int:
    """Lanes per output: the least of LANES at or above the mean edges per
    group (so most groups finish in one chunk), at most a warp."""
    mean = n_edges / max(n_groups, 1)
    return next((k for k in LANES if k >= mean), LANES[-1])


def tile_bounds(offsets: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Consecutive groups cut into tiles: int64 [2, n + 1], the tiles'
    group bounds and, below them, their edge bounds (``offsets`` there).
    Tile k holds the groups g whose ``offsets[g] + g`` lies in [k tile,
    (k + 1) tile), so at most ``tile`` groups with fewer than ``tile``
    edges before the last (n = ceil((E + G) / tile), at least 1; a tile
    inside one long group's edges is empty)."""
    G = offsets.shape[0] - 1
    key = offsets[:-1] + torch.arange(G, device=offsets.device)
    n = max(1, -(-(int(offsets[-1]) + G) // tile))
    bounds = torch.searchsorted(
        key, torch.arange(n + 1, device=offsets.device) * tile)
    return torch.stack([bounds, offsets[bounds]])


def prepare(offsets: torch.Tensor, idx: torch.Tensor, mult: torch.Tensor,
            n_x: int) -> EdgeGroups:
    """Check one edge grouping and convert it for the kernel: offsets
    int64 [G + 1] from 0 to E, non-decreasing; idx int32 or int64 [E] in
    ``[0, n_x)``; mult float32 or float64 [E]; all contiguous on one
    device.  Raises ValueError on anything else."""
    dev = mult.device
    if mult.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"segment_sum: unsupported dtype {mult.dtype}")
    E = mult.shape[0]
    for name, t, dtypes, n in (("mult", mult, (mult.dtype,), E),
                               ("idx", idx, (torch.int32, torch.int64), E),
                               ("offsets", offsets, (torch.int64,), None)):
        if t.device != dev or t.dtype not in dtypes:
            raise ValueError(f"segment_sum: {name} is {t.dtype} on "
                             f"{t.device}, want {dtypes} on {dev}")
        if t.dim() != 1 or not t.is_contiguous() or (
                n is not None and t.shape[0] != n):
            raise ValueError(f"segment_sum: {name} must be a contiguous 1-d "
                             f"tensor of {n or 'G + 1'} entries, got "
                             f"{tuple(t.shape)}")
    if offsets.shape[0] < 1 or int(offsets[0]) != 0 or int(
            offsets[-1]) != E or bool((torch.diff(offsets) < 0).any()):
        raise ValueError("segment_sum: offsets must rise from 0 to E")
    if not 0 <= n_x < 2**31:
        raise ValueError(f"segment_sum: {n_x} entries of x do not fit int32")
    if E and (int(idx.min()) < 0 or int(idx.max()) >= n_x):
        raise ValueError(f"segment_sum: idx outside [0, {n_x})")
    G = offsets.shape[0] - 1
    return EdgeGroups(offsets=offsets, idx=idx.to(torch.int32), mult=mult,
                      n_x=n_x, lanes=lanes_for(E, G),
                      tiles=tile_bounds(offsets))


def segment_sum_ref(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of ``w * x[:, idx]`` by each
    edge's segment."""
    G = offsets.shape[0] - 1
    seg = torch.repeat_interleave(torch.arange(G, device=offsets.device),
                                  torch.diff(offsets))
    return x.new_zeros((x.shape[0], G)).index_add_(1, seg, w * x[:, idx])


def em_step_ref(theta: torch.Tensor, by_cid: EdgeGroups, by_tid: EdgeGroups,
                reads: torch.Tensor, inv_denom: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of one CSR EM step from theta [R, ntid]:
    s = segment sums of mult * theta[:, tid] by cid, ratio = reads / s
    where s > 0 (else 0), num = segment sums of mult * ratio[:, cid] by
    tid, theta * num * inv_denom (reads and inv_denom broadcast: one row
    or one per row of theta)."""
    s = segment_sum_ref(theta, by_cid.mult, by_cid.idx, by_cid.offsets)
    pos = s > 0
    ratio = torch.where(pos, reads / torch.where(pos, s, 1.0), 0.0)
    num = segment_sum_ref(ratio, by_tid.mult, by_tid.idx, by_tid.offsets)
    return theta * num * inv_denom


def em_step_cycle_ref(t1: torch.Tensor, theta: torch.Tensor,
                      by_cid: EdgeGroups, by_tid: EdgeGroups,
                      reads: torch.Tensor, inv_denom: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``em_step_cycle``: (t2, r * r, v * v) for t2 =
    ``em_step_ref(t1)``, r = t1 - theta and v = t2 - t1 - r."""
    t2 = em_step_ref(t1, by_cid, by_tid, reads, inv_denom)
    r = t1 - theta
    v = t2 - t1 - r
    return t2, r * r, v * v


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    for fn in (lib.emsar_segment_sum_f32, lib.emsar_segment_sum_f64):
        fn.restype = ctypes.c_int
        fn.argtypes = ARGTYPES
    for fn in (lib.emsar_em_cycle_update_f32, lib.emsar_em_cycle_update_f64):
        fn.restype = ctypes.c_int
        fn.argtypes = CYCLE_ARGTYPES
    return lib


def build() -> None:
    """Build and load the kernel library (no launch)."""
    _lib()


def _row_stride(a: torch.Tensor, R: int, G: int, name: str) -> int:
    """The row stride of an EM epilogue operand: 0 for one row [G] shared
    by the R rows, G for a row each [R, G] (contiguous).  Raises
    ValueError on any other shape (a shape check: no sync)."""
    if tuple(a.shape) == (G,):
        return 0
    if tuple(a.shape) == (R, G) and a.is_contiguous():
        return G
    raise ValueError(f"em_step: {name} must be [{G}] or a contiguous "
                     f"[{R}, {G}], got {tuple(a.shape)}")


def _launch(x: torch.Tensor, g: EdgeGroups, mode: int, a=None, b=None,
            a_stride: int = 0) -> torch.Tensor:
    """One launch over ``g`` with x [R, n_x] contiguous on g's device in
    g's dtype (not checked); ``a`` (row ``r`` at ``r * a_stride``) and
    ``b`` [R, G] feed the EM epilogues."""
    fn = (_lib().emsar_segment_sum_f64 if x.dtype == torch.float64 else
          _lib().emsar_segment_sum_f32)
    R = x.shape[0]
    G = g.n_groups
    out = torch.empty((R, G), dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), g.mult.data_ptr(), g.idx.data_ptr(),
            g.offsets.data_ptr(), None if a is None else a.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), R, G, g.n_x,
            a_stride, g.lanes, mode,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum: kernel launch failed with CUDA "
                           f"error {rc}")
    return out


def sum_groups(x: torch.Tensor, g: EdgeGroups) -> torch.Tensor:
    """Segment sums of ``g.mult * x[:, g.idx]`` over a prepared grouping;
    x [R, g.n_x] contiguous, in g's dtype and on g's device (not checked
    on the card: this is the solver's per-step call)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return segment_sum_ref(x, g.mult, g.idx, g.offsets)
    if x.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {x.device}")
    out = _launch(x, g, _PLAIN)
    LAUNCHES += 1
    return out


def em_step(theta: torch.Tensor, by_cid: EdgeGroups, by_tid: EdgeGroups,
            reads: torch.Tensor, inv_denom: torch.Tensor) -> torch.Tensor:
    """One CSR EM step (``em_step_ref``) in two launches on the card: by
    cid with the read ratio as epilogue, by tid with the update.  theta
    [R, ntid] contiguous; reads [C] or [R, C] and inv_denom [ntid] or [R,
    ntid] (one row shared by every row of theta, or one each: the batched
    multisample solve's per-sample operands), in theta's dtype on its
    device (shapes checked, dtype and device not, on the card)."""
    global EM_LAUNCHES
    if theta.device.type == "cpu":
        return em_step_ref(theta, by_cid, by_tid, reads, inv_denom)
    if theta.device.type != "cuda":
        raise ValueError(f"em_step: unsupported device {theta.device}")
    R = theta.shape[0]
    ratio = _launch(theta, by_cid, _RATIO, a=reads, a_stride=_row_stride(
        reads, R, by_cid.n_groups, "reads"))
    out = _launch(ratio, by_tid, _UPDATE, a=inv_denom, b=theta,
                  a_stride=_row_stride(inv_denom, R, by_tid.n_groups,
                                       "inv_denom"))
    EM_LAUNCHES += 2
    return out


def em_step_cycle(t1: torch.Tensor, theta: torch.Tensor, by_cid: EdgeGroups,
                  by_tid: EdgeGroups, reads: torch.Tensor,
                  inv_denom: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The second EM step of a SQUAREM cycle from theta: (t2 = one EM step
    from t1, r * r, v * v) for r = t1 - theta and v = t2 - t1 - r, all
    [R, ntid] (``em_step_cycle_ref``).  Two launches on the card, the
    squares written by the update's epilogue; operands as ``em_step``'s,
    theta [R, ntid] contiguous in t1's dtype on its device."""
    global EM_LAUNCHES
    if theta.device != t1.device or theta.dtype != t1.dtype:
        raise ValueError(f"em_step_cycle: theta is {theta.dtype} on "
                         f"{theta.device}, want {t1.dtype} on {t1.device}")
    if t1.device.type == "cpu":
        return em_step_cycle_ref(t1, theta, by_cid, by_tid, reads,
                                 inv_denom)
    if t1.device.type != "cuda":
        raise ValueError(f"em_step_cycle: unsupported device {t1.device}")
    if theta.shape != t1.shape or not theta.is_contiguous():
        raise ValueError(f"em_step_cycle: theta must be a contiguous "
                         f"{tuple(t1.shape)} tensor, got "
                         f"{tuple(theta.shape)}")
    R, G = t1.shape[0], by_tid.n_groups
    ratio = _launch(t1, by_cid, _RATIO, a=reads, a_stride=_row_stride(
        reads, R, by_cid.n_groups, "reads"))
    t2, rr, vv = (torch.empty((R, G), dtype=t1.dtype, device=t1.device)
                  for _ in range(3))
    fn = (_lib().emsar_em_cycle_update_f64 if t1.dtype == torch.float64
          else _lib().emsar_em_cycle_update_f32)
    rc = fn(ratio.data_ptr(), by_tid.mult.data_ptr(), by_tid.idx.data_ptr(),
            by_tid.offsets.data_ptr(), inv_denom.data_ptr(), t1.data_ptr(),
            theta.data_ptr(), t2.data_ptr(), rr.data_ptr(), vv.data_ptr(), R,
            G, by_tid.n_x, _row_stride(inv_denom, R, G, "inv_denom"),
            by_tid.lanes, torch.cuda.current_stream(t1.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"em_step_cycle: kernel launch failed with CUDA "
                           f"error {rc}")
    EM_LAUNCHES += 2
    return t2, rr, vv


def segment_sum(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """Segment sums of ``w * x[:, idx]``: x [R, N] float32 or float64, w
    [E] of x's dtype, idx [E] int32 or int64 in [0, N), offsets [G + 1]
    int64.  Checks every argument (``prepare``) on every call."""
    if x.device != w.device or x.dtype != w.dtype:
        raise ValueError(f"segment_sum: x is {x.dtype} on {x.device}, w "
                         f"{w.dtype} on {w.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"segment_sum: x must be a contiguous [R, N] "
                         f"tensor, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return segment_sum_ref(x, w, idx, offsets)
    return sum_groups(x, prepare(offsets, idx, w, x.shape[1]))
