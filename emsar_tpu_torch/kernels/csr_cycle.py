"""The vector work of the CSR SQUAREM cycle: hand-written CUDA kernels and
their plain versions.

A stabilized SQUAREM cycle of the CSR solver (``model/solver.py::
_squarem_cycle``) takes theta [R, T] through three EM steps.  Around the
steps it computes the step length and the extrapolation, the
intensities of the double-EM value t2 and of the stabilized candidate,
their likelihood gain per row, and keeps the candidate where that gain
is >= 0.  These wrappers do that work in three launches a cycle:

* ``cycle_extrap(theta, t1, t2, r_sq_sum, v_sq_sum)``: the third EM
  step's input, ``where(extrap > 0, extrap, t2)``, from the row sums of
  r * r and v * v (written by ``segment_sum.em_step_cycle``, summed with
  ``torch.sum``);
* ``pair_gain(g, reads, eumaps, t2, cand)``: the gain terms [R, C] of cand
  over t2, both intensities summed in one pass over the edges grouped by
  cid (``g``); ``block_gain(g, reads, eumaps, s_old, theta)`` the same
  against intensities already known, returning theta's intensities too
  (the gain at the end of a block);
* ``cycle_select(gain, cand, t2)``: ``where(gain >= 0, cand, t2)`` by row.

The gain of a row is ``torch.sum(terms, dim=-1)``: the reductions stay
torch's, over the tensors the torch body reduced.  The kernels replace
the elementwise XLA ops of ``emsar_tpu/model/solver.py::_em_solve``'s
``squarem_cycle`` and ``gain_of``.  The CUDA source is ``csrc/
csr_cycle.cu`` (bits, NaN and what bounds it are written there).

The plain versions are the torch body of the cycle: ``gain_terms`` is
``model/solver.py::gain_of`` before its sum (the dense solvers' gain
too), the others the lines of the cycle they replace.  On CPU tensors the
wrappers compute the plain versions; on CUDA tensors they launch the
kernels or raise, never falling back.  The kernels give the torch body's
bits on the card.  ``LAUNCHES`` counts the launches of all three
kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .segment_sum import EdgeGroups, segment_sum_ref

SOURCE = "csr_cycle.cu"
LAUNCHES = 0
# emsar_pair_gain_f32/f64(x_new, x_old, s_old, w, idx, offsets, reads,
# eumaps, s_out, out, R, G, N, a_stride, lanes, stream)
PAIR_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 4 + [
    ctypes.c_int, ctypes.c_void_p]
# emsar_cycle_extrap_f32/f64(theta, t1, t2, rsum, vsum, out, R, T, stream)
EXTRAP_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 + [
    ctypes.c_void_p]
# emsar_cycle_select_f32/f64(gain, cand, t2, out, R, T, stream)
SELECT_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [
    ctypes.c_void_p]


def gain_terms(reads: torch.Tensor, eumaps: torch.Tensor,
               s_old: torch.Tensor, s_new: torch.Tensor) -> torch.Tensor:
    """Per segment, logL(s_new) - logL(s_old), termwise from the intensity
    deltas (resolves tiny gains even in float32).  A read-bearing segment
    whose intensity collapses to 0 is a likelihood collapse (-1e30), the
    reverse +1e30."""
    both = (s_old > 0) & (s_new > 0)
    safe_old = torch.where(both, s_old, 1.0)
    ratio = torch.log1p(torch.where(both, (s_new - s_old) / safe_old, 0.0))
    died = (s_old > 0) & (s_new <= 0) & (reads > 0)
    born = (s_old <= 0) & (s_new > 0) & (reads > 0)
    # died and born exclude each other: the nested where of the JAX code
    term = torch.where(both, reads * ratio,
                       (born.to(s_new.dtype) - died.to(s_new.dtype)) * 1e30)
    return term - eumaps * (s_new - s_old)


def pair_gain_ref(g: EdgeGroups, reads: torch.Tensor, eumaps: torch.Tensor,
                  x_old: torch.Tensor, x_new: torch.Tensor) -> torch.Tensor:
    """Plain version of ``pair_gain``: the gain terms [R, C] of x_new's
    intensities over x_old's."""
    return gain_terms(reads, eumaps,
                      segment_sum_ref(x_old, g.mult, g.idx, g.offsets),
                      segment_sum_ref(x_new, g.mult, g.idx, g.offsets))


def block_gain_ref(g: EdgeGroups, reads: torch.Tensor, eumaps: torch.Tensor,
                   s_old: torch.Tensor, x_new: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``block_gain``: (x_new's intensities, their gain
    terms over s_old)."""
    s_new = segment_sum_ref(x_new, g.mult, g.idx, g.offsets)
    return s_new, gain_terms(reads, eumaps, s_old, s_new)


def cycle_extrap_ref(theta: torch.Tensor, t1: torch.Tensor,
                     t2: torch.Tensor, r_sq_sum: torch.Tensor,
                     v_sq_sum: torch.Tensor) -> torch.Tensor:
    """Plain version of ``cycle_extrap``: the step length from the row
    sums [R, 1] of r * r and v * v, never shorter than a plain step, and
    the extrapolated theta, t2 where it is not positive."""
    r = t1 - theta
    v = t2 - t1 - r
    rnorm = torch.sqrt(r_sq_sum)
    vnorm = torch.sqrt(v_sq_sum)
    alpha = torch.where(vnorm > 0, -rnorm / torch.where(vnorm > 0, vnorm, 1.0),
                        -1.0)
    alpha = torch.clamp(alpha, max=-1.0)  # never shorter than a plain step
    # zero-crossing coordinates fall back to the plain double-EM value: an
    # exact 0 is an absorbing boundary for multiplicative EM and can freeze
    # a suboptimal KKT point
    extrap = theta - 2.0 * alpha * r + (alpha * alpha) * v
    return torch.where(extrap > 0, extrap, t2)


def cycle_select_ref(gain: torch.Tensor, cand: torch.Tensor,
                     t2: torch.Tensor) -> torch.Tensor:
    """Plain version of ``cycle_select``: cand in the rows whose gain is
    >= 0, else t2."""
    return torch.where((gain >= 0)[:, None], cand, t2)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    for name, argtypes in (("emsar_pair_gain", PAIR_ARGTYPES),
                           ("emsar_cycle_extrap", EXTRAP_ARGTYPES),
                           ("emsar_cycle_select", SELECT_ARGTYPES)):
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    return lib


def build() -> None:
    """Build and load the kernel library (no launch)."""
    _lib()


def _check(like: torch.Tensor, what: str, **tensors) -> None:
    """Raise ValueError unless every tensor is contiguous with ``like``'s
    dtype and device and its shape (``(name, shape)`` pairs)."""
    for name, (t, shape) in tensors.items():
        if t.device != like.device or t.dtype != like.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"want {like.dtype} on {like.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{tuple(shape)} tensor, got {tuple(t.shape)}")


def _on_card(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what}: unsupported dtype {x.dtype}")


def _fn(name: str, dtype: torch.dtype):
    return getattr(_lib(), name + ("_f64" if dtype == torch.float64
                                   else "_f32"))


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc}")


def _gain_launch(g: EdgeGroups, reads: torch.Tensor, eumaps: torch.Tensor,
                 x_new: torch.Tensor, x_old: Optional[torch.Tensor],
                 s_old: Optional[torch.Tensor], what: str
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One pair_gain launch: (x_new's intensities when s_old is given, else
    None; the gain terms)."""
    global LAUNCHES
    _on_card(x_new, what)
    R, C = x_new.shape[0], g.n_groups
    if tuple(reads.shape) == (C,):
        a_stride = 0
    elif tuple(reads.shape) == (R, C):
        a_stride = C
    else:
        raise ValueError(f"{what}: reads must be [{C}] or [{R}, {C}], got "
                         f"{tuple(reads.shape)}")
    rows = {"x_new": (x_new, (R, g.n_x)), "reads": (reads, reads.shape),
            "eumaps": (eumaps, reads.shape), "mult": (g.mult, g.mult.shape)}
    if x_old is not None:
        rows["x_old"] = (x_old, (R, g.n_x))
    else:
        rows["s_old"] = (s_old, (R, C))
    _check(x_new, what, **rows)
    out = torch.empty((R, C), dtype=x_new.dtype, device=x_new.device)
    s_out = None if s_old is None else torch.empty_like(out)
    rc = _fn("emsar_pair_gain", x_new.dtype)(
        x_new.data_ptr(), None if x_old is None else x_old.data_ptr(),
        None if s_old is None else s_old.data_ptr(), g.mult.data_ptr(),
        g.idx.data_ptr(), g.offsets.data_ptr(), reads.data_ptr(),
        eumaps.data_ptr(), None if s_out is None else s_out.data_ptr(),
        out.data_ptr(), R, C, g.n_x, a_stride, g.lanes,
        torch.cuda.current_stream(x_new.device).cuda_stream)
    _raise_on(rc, what)
    LAUNCHES += 1
    return s_out, out


def pair_gain(g: EdgeGroups, reads: torch.Tensor, eumaps: torch.Tensor,
              x_old: torch.Tensor, x_new: torch.Tensor) -> torch.Tensor:
    """The gain terms [R, C] of x_new's intensities over x_old's (both
    [R, T], their intensities the segment sums over ``g``, the edges
    grouped by cid); reads and eumaps [C] or [R, C] (one row shared by
    every row, or one each)."""
    if x_new.device.type == "cpu":
        return pair_gain_ref(g, reads, eumaps, x_old, x_new)
    return _gain_launch(g, reads, eumaps, x_new, x_old, None, "pair_gain")[1]


def block_gain(g: EdgeGroups, reads: torch.Tensor, eumaps: torch.Tensor,
               s_old: torch.Tensor, x_new: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_new's intensities [R, C], their gain terms [R, C] over the
    intensities ``s_old``), as ``pair_gain``."""
    if x_new.device.type == "cpu":
        return block_gain_ref(g, reads, eumaps, s_old, x_new)
    return _gain_launch(g, reads, eumaps, x_new, None, s_old, "block_gain")


def cycle_extrap(theta: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor,
                 r_sq_sum: torch.Tensor, v_sq_sum: torch.Tensor
                 ) -> torch.Tensor:
    """The third EM step's input of a cycle from theta, t1 and t2 [R, T]
    and the row sums [R, 1] of r * r and v * v (``cycle_extrap_ref``)."""
    global LAUNCHES
    if theta.device.type == "cpu":
        return cycle_extrap_ref(theta, t1, t2, r_sq_sum, v_sq_sum)
    _on_card(theta, "cycle_extrap")
    R, T = theta.shape
    _check(theta, "cycle_extrap", theta=(theta, (R, T)), t1=(t1, (R, T)),
           t2=(t2, (R, T)), r_sq_sum=(r_sq_sum, (R, 1)),
           v_sq_sum=(v_sq_sum, (R, 1)))
    out = torch.empty_like(theta)
    rc = _fn("emsar_cycle_extrap", theta.dtype)(
        theta.data_ptr(), t1.data_ptr(), t2.data_ptr(), r_sq_sum.data_ptr(),
        v_sq_sum.data_ptr(), out.data_ptr(), R, T,
        torch.cuda.current_stream(theta.device).cuda_stream)
    _raise_on(rc, "cycle_extrap")
    LAUNCHES += 1
    return out


def cycle_select(gain: torch.Tensor, cand: torch.Tensor, t2: torch.Tensor
                 ) -> torch.Tensor:
    """cand [R, T] in the rows whose gain [R] is >= 0, else t2."""
    global LAUNCHES
    if cand.device.type == "cpu":
        return cycle_select_ref(gain, cand, t2)
    _on_card(cand, "cycle_select")
    R, T = cand.shape
    _check(cand, "cycle_select", gain=(gain, (R,)), cand=(cand, (R, T)),
           t2=(t2, (R, T)))
    out = torch.empty_like(cand)
    rc = _fn("emsar_cycle_select", cand.dtype)(
        gain.data_ptr(), cand.data_ptr(), t2.data_ptr(), out.data_ptr(), R,
        T, torch.cuda.current_stream(cand.device).cuda_stream)
    _raise_on(rc, "cycle_select")
    LAUNCHES += 1
    return out
