"""The mate2 candidate expansion of the PE index build: hand-written CUDA
kernel and its plain version.

``pe_candidates(spos, srank, lo, hi, R, RF, tn, d0, nfl, rl, borderpos,
seqlength, unstranded, single)`` expands the chunk of mate1 members
``[lo, hi)`` of the rank-sorted members (window start ``spos[j]``,
cluster rank ``srank[j]``): for member j and slot dd, the candidate mate2
window starts at q = spos[j] + d0 + dd.  ``tn = pack_tables(t32, nsep)``
holds each position's tid and next separator in one int64.  A candidate
is valid under the tests of ``csrc/pe_candidates.cu``; its key is
``srank[j] << 30 | R[q]``, its payload ``t32[p] << 9 | dd``.

* A member that is a mate1 cluster of its own (its rank differs from
  ``srank[j - 1]`` and ``srank[j + 1]``; the neighbours outside the chunk
  are read too) is resolved here: a valid slot whose mate2 rank appears in
  no other valid slot of the row adds 1 to ``single[tid * nfl + dd]``
  (int64, in place); the others are the reference's multi-d drop
  (src/emsar_functions.c:1926).  Nothing of the row is returned.
* The valid candidates of the other members are returned, compacted, in
  member-major order: ``(keys, pay)``, int64 and int32.

This replaces ``emsar_tpu/index/device_build.py::_pe_cvalid``, the key
packing of ``_pe_expand_sort`` and ``_pe_single_chunk``.  The full grid of
the parent contract (every member x slot, invalid keys ``INVALID_KEY``) is
``pe_candidate_grid_ref``; ``pe_candidates_ref`` is that grid resolved.

On a CPU tensor the wrapper computes ``pe_candidates_ref``, the plain
PyTorch version.  On a CUDA tensor it launches the kernel or raises; it
never falls back.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .window_hash import to_int32_bits

SOURCE = "pe_candidates.cu"
LAUNCHES = 0
BIG_RANK = 0x3FFFFFFF  # the rank of an invalid window; valid ranks are below
INVALID_KEY = (1 << 63) - 1
RANK_BITS = 30
MAX_NFL = 512  # dd rides in the payload's low 9 bits
TID_MASK = (1 << 23) - 1  # the tid rides in the payload above dd
MAX_CANDIDATES = 1 << 30  # members and written candidates per launch
# grid cells the plain version expands at once: a CPU build's fixed chunk
# budget, so that a slice holds no more cells than a chunk of multi-cluster
# members does; on the card a slice this large keeps its launches few
REF_SLICE_CELLS = 1 << 26


def pe_candidate_grid_ref(mpos: torch.Tensor, mrank: torch.Tensor,
                          R: torch.Tensor, RF: Optional[torch.Tensor],
                          t32: torch.Tensor, nsep: torch.Tensor, d0: int,
                          nfl: int, rl: int, borderpos: int, seqlength: int,
                          unstranded: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every candidate of members (mpos, mrank): keys and payloads
    [M * nfl], member-major, an invalid candidate's key ``INVALID_KEY``.
    Every table index is masked against the table's length, never clamped
    into it."""
    M = mpos.shape[0]
    dev = mpos.device
    p = mpos.to(torch.int64)
    r1 = mrank.to(torch.int64)

    def take(table, idx, ok, fill):
        return torch.where(ok, table[torch.where(ok, idx, 0)].to(torch.int64),
                           fill)

    n_rank = R.shape[0]
    in_nsep = (p >= 0) & (p < nsep.shape[0])
    tid = take(t32, p, (p >= 0) & (p < t32.shape[0]), 0)
    dmax = take(nsep, p, in_nsep, 0) - rl - p
    if unstranded:
        rfp = take(RF, p, (p >= 0) & (p < n_rank), BIG_RANK)
    keys = torch.full((M, nfl), INVALID_KEY, dtype=torch.int64, device=dev)
    pay = torch.empty((M, nfl), dtype=torch.int32, device=dev)
    for dd in range(nfl):
        d = d0 + dd
        q = p + d
        ok = in_nsep & (q <= seqlength - rl) & (q < n_rank)
        r2 = take(R, q, ok, BIG_RANK)
        ok &= (r2 >= 0) & (r2 < BIG_RANK) & (d <= dmax)
        if unstranded:
            cmp = torch.sign(r1 - take(RF, q, ok, BIG_RANK))
            cmp = torch.where(cmp != 0, cmp, torch.sign(r2 - rfp))
            ok &= torch.where(p < borderpos, cmp <= 0, cmp < 0)
        keys[:, dd] = torch.where(ok, (r1 << RANK_BITS) | r2, INVALID_KEY)
        pay[:, dd] = to_int32_bits((tid << 9) | dd)
    return keys.reshape(-1), pay.reshape(-1)


def pack_tables(t32: torch.Tensor, nsep: torch.Tensor) -> torch.Tensor:
    """int64 [len(nsep)]: ``nsep[p] << 32 | t32[p]`` (t32 0 past its end,
    as a masked read gives): the kernel reads a member's tid and next
    separator as one 8-byte entry."""
    tn = nsep.to(torch.int64)
    tn.bitwise_left_shift_(32)
    tn[:t32.shape[0]].bitwise_or_(t32)
    return tn


def unpack_tables(tn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t32, nsep) of ``pack_tables``, int32, both of tn's length."""
    return ((tn & 0xFFFFFFFF).to(torch.int32),
            (tn >> 32).to(torch.int32))


def singleton_members(srank: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """[hi - lo] bool: member j of [lo, hi) is a mate1 cluster of its own,
    its rank unequal to ``srank[j - 1]`` and ``srank[j + 1]`` where they
    exist."""
    s0, s1 = max(lo - 1, 0), min(hi + 1, srank.shape[0])
    ext = srank[s0:s1]
    eq = ext[1:] == ext[:-1]
    same = torch.zeros(ext.shape[0], dtype=torch.bool, device=srank.device)
    same[1:] |= eq
    same[:-1] |= eq
    return ~same[lo - s0:hi - s0]


def resolve_grid(keys: torch.Tensor, pay: torch.Tensor, sng: torch.Tensor,
                 nfl: int, single: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A full grid (``pe_candidate_grid_ref``'s) under the kernel's
    contract: the rows of singleton members (``sng``) resolved into
    ``single`` by the row-local duplicate test of ``_pe_single_chunk``
    (sort each row, drop ranks equal to a neighbour); returns the valid
    candidates of the other rows, member-major."""
    keys, pay = keys.view(-1, nfl), pay.view(-1, nfl)
    rows = keys[sng]
    valid = rows != INVALID_KEY
    r2 = torch.where(valid, rows & ((1 << RANK_BITS) - 1), BIG_RANK)
    del rows
    sr, order = torch.sort(r2, dim=1)
    del r2
    eq = sr[:, 1:] == sr[:, :-1]
    dup = torch.zeros_like(valid)
    dup[:, 1:] |= eq
    dup[:, :-1] |= eq
    keep = torch.zeros_like(valid).scatter_(1, order, (sr != BIG_RANK) & ~dup)
    del sr, order, eq, dup, valid
    kp = pay[sng][keep].to(torch.int64)
    at = ((kp >> 9) & TID_MASK) * nfl + (kp & 0x1FF)
    at = at[at < single.shape[0]]
    single.index_add_(0, at, torch.ones_like(at))
    del kp, at, keep
    mk, mp = keys[~sng], pay[~sng]
    valid = mk != INVALID_KEY
    return mk[valid], mp[valid]


def pe_candidates_ref(spos: torch.Tensor, srank: torch.Tensor, lo: int,
                      hi: int, R: torch.Tensor, RF: Optional[torch.Tensor],
                      tn: torch.Tensor, d0: int, nfl: int, rl: int,
                      borderpos: int, seqlength: int, unstranded: bool,
                      single: torch.Tensor, capacity: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (see the module note).  The
    grid is expanded and resolved a slice of at most ``REF_SLICE_CELLS``
    cells (member x slot) at a time, so that its memory does not grow with
    the chunk's singleton members, which the chunk plan weighs lightly."""
    t32, nsep = unpack_tables(tn)
    sng = singleton_members(srank, lo, hi)
    step = max(1, REF_SLICE_CELLS // nfl)
    keys, pay, n = [], [], 0
    for a in range(lo, hi, step):
        b = min(a + step, hi)
        k, p = pe_candidate_grid_ref(spos[a:b], srank[a:b], R, RF, t32, nsep,
                                     d0, nfl, rl, borderpos, seqlength,
                                     unstranded)
        k, p = resolve_grid(k, p, sng[a - lo:b - lo], nfl, single)
        n += k.shape[0]
        if capacity is not None and n > capacity:
            raise RuntimeError(f"pe_candidates: at least {n} candidates "
                               f"exceed the capacity of {capacity}")
        keys.append(k)
        pay.append(p)
    if not keys:
        return (torch.empty(0, dtype=torch.int64, device=spos.device),
                torch.empty(0, dtype=torch.int32, device=spos.device))
    return torch.cat(keys), torch.cat(pay)


def bytes_moved_grid(mpos: torch.Tensor, nfl: int, unstranded: bool) -> int:
    """The bytes of the full-grid expansion (the parent contract), each
    once: per member its position, rank, t32 and nsep entries (and RF[p]
    when unstranded); the window entries of ``_window_bytes``; 12 B
    written per candidate of the grid."""
    M = mpos.shape[0]
    if M == 0:
        return 0
    return ((16 + (4 if unstranded else 0)) * M
            + _window_bytes(mpos, nfl, unstranded) + 12 * M * nfl)


def bytes_moved(mpos: torch.Tensor, nfl: int, unstranded: bool,
                n_written: int, n_entries: int) -> int:
    """The bytes the kernel's function must move, each once: per member
    its position, rank and tn entry (16 B); the window entries of
    ``_window_bytes``; 12 B per written candidate (``n_written``); 8 B
    read and 8 B written per entry of ``single`` that the call changes
    (``n_entries``, however many slots add to it).  RF[p] is read only on
    an orientation tie and is not counted."""
    if mpos.shape[0] == 0:
        return 0
    return (16 * mpos.shape[0] + _window_bytes(mpos, nfl, unstranded)
            + 12 * n_written + 16 * n_entries)


def _window_bytes(mpos: torch.Tensor, nfl: int, unstranded: bool) -> int:
    """4 B per distinct R entry (and RF entry when unstranded) that the
    members' windows [p + d0, p + d0 + nfl) cover together."""
    s = torch.sort(mpos.to(torch.int64)).values
    span = int(torch.clamp(torch.diff(s), max=nfl).sum()) + nfl
    return 4 * span * (2 if unstranded else 1)


# emsar_pe_candidates(spos, srank, n_members, lo, M, R, RF, n_rank, tn,
# n_tn, d0, nfl, rl, borderpos, seqlength, unstranded, single, n_single,
# keys, pay, capacity, scratch, stream)
ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
            + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
            + [ctypes.c_void_p, ctypes.c_longlong]
            + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int]
            + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2
            + [ctypes.c_longlong] + [ctypes.c_void_p] * 2)
# emsar_pe_candidates_scratch(M, nfl): int64 entries of the scratch
SCRATCH_ARGTYPES = [ctypes.c_longlong, ctypes.c_int]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.emsar_pe_candidates
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    lib.emsar_pe_candidates_scratch.restype = ctypes.c_longlong
    lib.emsar_pe_candidates_scratch.argtypes = SCRATCH_ARGTYPES
    return lib


def build() -> None:
    """Build and load the kernel library (no launch)."""
    _lib()


def _check(spos, srank, lo, hi, R, RF, tn, d0, nfl, rl, unstranded, single,
           capacity) -> int:
    if not (0 < nfl <= MAX_NFL and 0 < rl <= 1024
            and 0 <= d0 < (1 << 31) - MAX_NFL):
        raise ValueError(f"pe_candidates: nfl {nfl}, rl {rl} or d0 {d0} "
                         f"out of range")
    if not 0 <= lo <= hi <= spos.shape[0] or srank.shape[0] != spos.shape[0]:
        raise ValueError(f"pe_candidates: members [{lo}, {hi}) of "
                         f"{spos.shape[0]} positions and {srank.shape[0]} "
                         f"ranks")
    if capacity is None:
        capacity = (hi - lo) * nfl
    if hi - lo > MAX_CANDIDATES or capacity > MAX_CANDIDATES:
        raise ValueError(f"pe_candidates: {hi - lo} members or a capacity of "
                         f"{capacity} exceed {MAX_CANDIDATES} a launch")
    if unstranded and RF is None:
        raise ValueError("pe_candidates: an unstranded expansion reads RF")
    for name, t in (("tn", tn), ("single", single)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"pe_candidates: {name} must be a 1-d int64 "
                             f"tensor")
    return capacity


def launch(spos: torch.Tensor, srank: torch.Tensor, lo: int, hi: int,
           R: torch.Tensor, RF: Optional[torch.Tensor], tn: torch.Tensor,
           d0: int, nfl: int, rl: int, borderpos: int, seqlength: int,
           unstranded: bool, single: torch.Tensor,
           capacity: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's launch on CUDA tensors, without a sync: (key buffer,
    payload buffer, [1] int64 count on the card); the first ``count``
    entries of the buffers are the candidates.  ``capacity`` (default
    (hi - lo) * nfl) sizes the buffers; more candidates raise in
    ``pe_candidates``."""
    global LAUNCHES
    capacity = _check(spos, srank, lo, hi, R, RF, tn, d0, nfl, rl,
                      unstranded, single, capacity)
    dev = spos.device
    if dev.type != "cuda":
        raise ValueError(f"pe_candidates: the kernel takes CUDA tensors, got "
                         f"{dev}")
    tables = (("spos", spos), ("srank", srank), ("R", R), ("tn", tn),
              ("single", single)) + ((("RF", RF),) if RF is not None else ())
    for name, t in tables:
        want = torch.int64 if name in ("tn", "single") else torch.int32
        if (t.device != dev or t.dtype != want or t.dim() != 1
                or not t.is_contiguous()):
            raise ValueError(f"pe_candidates: {name} must be a contiguous "
                             f"1-d {want} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if RF is not None and RF.shape[0] != R.shape[0]:
        raise ValueError("pe_candidates: RF must match R")
    M = hi - lo
    lib = _lib()
    scratch = torch.zeros(lib.emsar_pe_candidates_scratch(M, nfl),
                          dtype=torch.int64, device=dev)
    keys = torch.empty(capacity, dtype=torch.int64, device=dev)
    pay = torch.empty(capacity, dtype=torch.int32, device=dev)
    if M == 0:
        return keys, pay, scratch[1:2]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.emsar_pe_candidates(
        spos.data_ptr(), srank.data_ptr(), spos.shape[0], lo, M,
        R.data_ptr(), RF.data_ptr() if RF is not None else None, R.shape[0],
        tn.data_ptr(), tn.shape[0], d0, nfl, rl, borderpos, seqlength,
        int(bool(unstranded)),
        single.data_ptr(), single.shape[0], keys.data_ptr(), pay.data_ptr(),
        capacity, scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pe_candidates: kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return keys, pay, scratch[1:2]


def pe_candidates(spos: torch.Tensor, srank: torch.Tensor, lo: int, hi: int,
                  R: torch.Tensor, RF: Optional[torch.Tensor],
                  tn: torch.Tensor, d0: int, nfl: int, rl: int,
                  borderpos: int, seqlength: int, unstranded: bool,
                  single: torch.Tensor, capacity: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk [lo, hi) of the rank-sorted members expanded (see the
    module note): singleton members' counts added to ``single``; returns
    the other members' valid candidates (keys, payloads).  The tables are
    1-d int32 (``tn`` and ``single`` int64); ``RF`` is read only when
    ``unstranded`` (None otherwise).  On CUDA the count is read back
    once."""
    if spos.device.type == "cpu":
        _check(spos, srank, lo, hi, R, RF, tn, d0, nfl, rl, unstranded,
               single, capacity)
        return pe_candidates_ref(spos, srank, lo, hi, R, RF, tn, d0, nfl, rl,
                                 borderpos, seqlength, unstranded, single,
                                 capacity)
    keys, pay, count = launch(spos, srank, lo, hi, R, RF, tn, d0, nfl, rl,
                              borderpos, seqlength, unstranded, single,
                              capacity)
    n = int(count)
    if n > keys.shape[0]:
        raise RuntimeError(f"pe_candidates: {n} candidates exceed the "
                           f"capacity of {keys.shape[0]}")
    return keys[:n], pay[:n]
