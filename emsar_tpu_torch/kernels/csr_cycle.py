"""The vector work of the CSR SQUAREM cycle and of a block's end:
hand-written CUDA kernels and their plain versions.

A stabilized SQUAREM cycle of the CSR solver (``model/solver.py::
_squarem_cycle_launches``) takes theta [R, T] through three EM steps.
Around the steps it computes the step length and the extrapolation, the
intensities of the double-EM value t2 and of the stabilized candidate,
their likelihood gain per row, and keeps the candidate where that gain
is >= 0.  These wrappers do that work in three launches a cycle, and
end a block in one:

* ``pair_gain(g, reads, eumaps, t2, cand)``: the gain terms [R, C] of
  cand over t2, both intensities summed in one pass over the edges
  grouped by cid (``g``), a block per tile of consecutive segments
  (``segment_sum.tile_bounds``) and row; with ``intensities=True`` (a
  block's last cycle) both intensities too;
* ``block_end(gain, cand, t2, s_t2, s_cand, s_prev, reads, eumaps)``: the
  end of a block, from its last cycle: theta = the accept (cand in the
  rows whose gain [R] is >= 0, else t2), its intensities picked the same
  way from those of t2 and cand, and with ``s_prev`` (the previous
  block's intensities) their gain terms; one elementwise launch, no pass
  over the edges.  On clusters the intensities come from
  ``csr_cluster.extrap_gain``'s last pass;
* ``cycle_extrap(theta, t1, t2, r_sq_sum, v_sq_sum)``: the third EM
  step's input, ``where(extrap > 0, extrap, t2)``, from the row sums of
  r * r and v * v (written by ``segment_sum.em_step_cycle``, summed with
  ``torch.sum``);
* ``cycle_select(gain, cand, t2)``: ``where(gain >= 0, cand, t2)`` by row
  (the accept, the next cycle's theta).

``cycle_extrap`` and ``cycle_select`` are launched with programmatic
stream serialization: each may start while the kernel launched directly
before it on the stream still runs, loads every input but its last
(``v_sq_sum``; ``gain``) then, and waits for that kernel before it reads
the last one and writes.  So of their inputs only ``v_sq_sum`` and
``gain`` may come from the kernel launched directly before them (as in
the cycle, where that kernel is their ``torch.sum``); the rest must have
been written before it.

The gain of a row is ``torch.sum(terms, dim=-1)``: the reductions stay
torch's, over the tensors the torch body reduced.  The kernels replace
the elementwise XLA ops of ``emsar_tpu/model/solver.py::_em_solve``'s
``squarem_cycle`` and ``gain_of`` and the block's gain.  The CUDA source
is ``csrc/csr_cycle.cu`` (design, bits, NaN and what bounds it are
written there): in ``pair_gain`` a thread an edge of the tile computes
both products into shared memory and a thread a segment folds them in
edge order; ``block_end``'s intensities are those a pass over the edges
would sum from the accept, bit for bit, since the accept takes one whole
row and each was folded in the same order.

The plain versions are the torch body: ``gain_terms`` is
``model/solver.py::gain_of`` before its sum (the dense solvers' gain
too), ``block_end_ref`` is ``cycle_select_ref`` then ``gain_terms`` on the
picked intensities, the others the lines of the cycle they replace.  On
CPU tensors the wrappers compute the plain versions; on CUDA tensors they
launch the kernels or raise, never falling back.  The kernels give the
torch body's bits on the card.  ``LAUNCHES`` counts the launches of
every kernel here, ``PAIR_GAIN_LAUNCHES``, ``BLOCK_END_LAUNCHES``,
``EXTRAP_LAUNCHES`` and ``SELECT_LAUNCHES`` those of each.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from . import _build
from .segment_sum import TILE, EdgeGroups, segment_sum_ref

SOURCE = "csr_cycle.cu"
LAUNCHES = 0
PAIR_GAIN_LAUNCHES = 0
BLOCK_END_LAUNCHES = 0
EXTRAP_LAUNCHES = 0
SELECT_LAUNCHES = 0
# emsar_pair_gain_f32/f64(x_old, x_new, w, idx, offsets, tiles, reads,
# eumaps, s_old_out, s_new_out, out, R, G, N, a_stride, n_tiles, tile,
# stream)
PAIR_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 5 + [
    ctypes.c_int, ctypes.c_void_p]
# emsar_block_end_f32/f64(gain, cand, t2, s_t2, s_cand, s_prev, reads,
# eumaps, theta, s_out, terms, R, C, T, a_stride, stream)
BLOCK_END_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 4 + [
    ctypes.c_void_p]
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
                  x_old: torch.Tensor, x_new: torch.Tensor, *,
                  intensities: bool = False):
    """Plain version of ``pair_gain``: the gain terms [R, C] of x_new's
    intensities over x_old's, and with ``intensities`` (terms, x_old's
    intensities, x_new's)."""
    s_old = segment_sum_ref(x_old, g.mult, g.idx, g.offsets)
    s_new = segment_sum_ref(x_new, g.mult, g.idx, g.offsets)
    terms = gain_terms(reads, eumaps, s_old, s_new)
    return (terms, s_old, s_new) if intensities else terms


def block_end_ref(gain: torch.Tensor, cand: torch.Tensor, t2: torch.Tensor,
                  s_t2: torch.Tensor, s_cand: torch.Tensor,
                  s_prev: Optional[torch.Tensor], reads: torch.Tensor,
                  eumaps: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    """Plain version of ``block_end``: (theta, its intensities, their gain
    terms over s_prev or None) for theta = ``cycle_select_ref(gain, cand,
    t2)``, its intensities picked the same way."""
    theta = cycle_select_ref(gain, cand, t2)
    s = cycle_select_ref(gain, s_cand, s_t2)
    return theta, s, (None if s_prev is None
                      else gain_terms(reads, eumaps, s_prev, s))


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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/csr_cycle.cu``) with its launchers'
    argument and result types set."""
    for name, argtypes in (("emsar_pair_gain", PAIR_ARGTYPES),
                           ("emsar_block_end", BLOCK_END_ARGTYPES),
                           ("emsar_cycle_extrap", EXTRAP_ARGTYPES),
                           ("emsar_cycle_select", SELECT_ARGTYPES)):
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load(SOURCE))


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


def _a_stride(reads: torch.Tensor, R: int, C: int, what: str) -> int:
    """0 for reads [C] shared by the rows, C for a row each [R, C]."""
    if tuple(reads.shape) == (C,):
        return 0
    if tuple(reads.shape) == (R, C):
        return C
    raise ValueError(f"{what}: reads must be [{C}] or [{R}, {C}], got "
                     f"{tuple(reads.shape)}")


def _count(name: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    globals()[name] += 1


def pair_gain(g: EdgeGroups, reads: torch.Tensor, eumaps: torch.Tensor,
              x_old: torch.Tensor, x_new: torch.Tensor, *,
              intensities: bool = False
              ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The gain terms [R, C] of x_new's intensities over x_old's (both
    [R, T], their intensities the segment sums over ``g``, the edges
    grouped by cid); reads and eumaps [C] or [R, C] (one row shared by
    every row, or one each).  With ``intensities``: (terms, x_old's
    intensities, x_new's), all [R, C].  One launch on the card, a block
    per (row, tile of ``g.tiles``)."""
    if x_new.device.type == "cpu":
        return pair_gain_ref(g, reads, eumaps, x_old, x_new,
                             intensities=intensities)
    what = "pair_gain"
    _on_card(x_new, what)
    R, C = x_new.shape[0], g.n_groups
    a_stride = _a_stride(reads, R, C, what)
    _check(x_new, what, x_new=(x_new, (R, g.n_x)),
           x_old=(x_old, (R, g.n_x)), reads=(reads, reads.shape),
           eumaps=(eumaps, reads.shape), mult=(g.mult, g.mult.shape))
    out = torch.empty((R, C), dtype=x_new.dtype, device=x_new.device)
    s_pair = ((torch.empty_like(out), torch.empty_like(out)) if intensities
              else (None, None))
    rc = _fn("emsar_pair_gain", x_new.dtype)(
        x_old.data_ptr(), x_new.data_ptr(), g.mult.data_ptr(),
        g.idx.data_ptr(), g.offsets.data_ptr(), g.tiles.data_ptr(),
        reads.data_ptr(), eumaps.data_ptr(),
        *(None if t is None else t.data_ptr() for t in s_pair),
        out.data_ptr(), R, C, g.n_x, a_stride, g.tiles.shape[1] - 1, TILE,
        torch.cuda.current_stream(x_new.device).cuda_stream)
    _raise_on(rc, what)
    _count("PAIR_GAIN_LAUNCHES")
    return (out, *s_pair) if intensities else out


def block_end(gain: torch.Tensor, cand: torch.Tensor, t2: torch.Tensor,
              s_t2: torch.Tensor, s_cand: torch.Tensor,
              s_prev: Optional[torch.Tensor], reads: torch.Tensor,
              eumaps: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The end of a block from its last cycle's gain [R], cand and t2
    [R, T] and their intensities [R, C]: (theta = cand in the rows whose
    gain is >= 0, else t2; its intensities, picked the same way; their
    gain terms [R, C] over the intensities ``s_prev``, or None without
    them).  reads and eumaps [C] or [R, C].  One launch on the card."""
    if cand.device.type == "cpu":
        return block_end_ref(gain, cand, t2, s_t2, s_cand, s_prev, reads,
                             eumaps)
    what = "block_end"
    _on_card(cand, what)
    R, T = cand.shape
    C = s_t2.shape[-1]
    a_stride = _a_stride(reads, R, C, what)
    rows = {"gain": (gain, (R,)), "t2": (t2, (R, T)),
            "s_t2": (s_t2, (R, C)), "s_cand": (s_cand, (R, C)),
            "reads": (reads, reads.shape), "eumaps": (eumaps, reads.shape)}
    if s_prev is not None:
        rows["s_prev"] = (s_prev, (R, C))
    _check(cand, what, cand=(cand, (R, T)), **rows)
    theta = torch.empty_like(cand)
    s = torch.empty_like(s_t2)
    terms = None if s_prev is None else torch.empty_like(s_t2)
    rc = _fn("emsar_block_end", cand.dtype)(
        gain.data_ptr(), cand.data_ptr(), t2.data_ptr(), s_t2.data_ptr(),
        s_cand.data_ptr(), None if s_prev is None else s_prev.data_ptr(),
        reads.data_ptr(), eumaps.data_ptr(), theta.data_ptr(), s.data_ptr(),
        None if terms is None else terms.data_ptr(), R, C, T, a_stride,
        torch.cuda.current_stream(cand.device).cuda_stream)
    _raise_on(rc, what)
    _count("BLOCK_END_LAUNCHES")
    return theta, s, terms


def cycle_extrap(theta: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor,
                 r_sq_sum: torch.Tensor, v_sq_sum: torch.Tensor
                 ) -> torch.Tensor:
    """The third EM step's input of a cycle from theta, t1 and t2 [R, T]
    and the row sums [R, 1] of r * r and v * v (``cycle_extrap_ref``).
    One launch on the card, which may overlap the kernel launched before
    it: only ``v_sq_sum`` may come from that kernel (module note)."""
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
    _count("EXTRAP_LAUNCHES")
    return out


def cycle_select(gain: torch.Tensor, cand: torch.Tensor, t2: torch.Tensor
                 ) -> torch.Tensor:
    """cand [R, T] in the rows whose gain [R] is >= 0, else t2.  One
    launch on the card, which may overlap the kernel launched before it:
    only ``gain`` may come from that kernel (module note)."""
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
    _count("SELECT_LAUNCHES")
    return out
