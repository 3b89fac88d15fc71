"""The mate2 candidate expansion of the PE index build: hand-written CUDA
kernel and its plain version.

``pe_candidates(mpos, mrank, R, RF, t32, nsep, d0, nfl, rl, borderpos,
seqlength, unstranded)`` returns ``(keys, pay)``, [M * nfl] int64 and
int32, member-major: for mate1 member m (window start ``mpos[m]``, cluster
rank ``mrank[m]``) and slot dd, the candidate mate2 window starts at
q = mpos[m] + d0 + dd.  A valid candidate's key is
``mrank[m] << 30 | R[q]``, an invalid one's ``INVALID_KEY`` (it sorts
last); the payload is ``t32[p] << 9 | dd`` either way.  Validity and the
tables are written in ``csrc/pe_candidates.cu``, which replaces
``emsar_tpu/index/device_build.py::_pe_cvalid`` and the key packing of
``_pe_expand_sort``.

On a CPU tensor the wrapper computes ``pe_candidates_ref``, the plain
PyTorch version (a loop over dd).  On a CUDA tensor it launches the kernel
or raises; it never falls back.  ``LAUNCHES`` counts kernel launches.
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
MAX_CANDIDATES = 1 << 30  # per launch (csrc/pe_candidates.cu)


def pe_candidates_ref(mpos: torch.Tensor, mrank: torch.Tensor,
                      R: torch.Tensor, RF: Optional[torch.Tensor],
                      t32: torch.Tensor, nsep: torch.Tensor, d0: int,
                      nfl: int, rl: int, borderpos: int, seqlength: int,
                      unstranded: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (see the module note): every
    table index is masked against the table's length, never clamped into
    it."""
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


def bytes_moved(mpos: torch.Tensor, nfl: int, unstranded: bool) -> int:
    """Bytes the function must move, each once: per member its position,
    rank, t32 and nsep entries (and RF[p] when unstranded); the distinct
    R entries (and RF entries when unstranded) that the members' windows
    [p + d0, p + d0 + nfl) cover together; 12 B written per candidate."""
    M = mpos.shape[0]
    if M == 0:
        return 0
    s = torch.sort(mpos.to(torch.int64)).values
    span = int(torch.clamp(torch.diff(s), max=nfl).sum()) + nfl
    per_member = 16 + (4 if unstranded else 0)
    return per_member * M + 4 * span * (2 if unstranded else 1) \
        + 12 * M * nfl


# emsar_pe_candidates(mpos, mrank, M, R, RF, n_rank, t32, n_t32, nsep,
# n_nsep, d0, nfl, rl, borderpos, seqlength, unstranded, keys, pay, stream)
ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
            + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
            + [ctypes.c_void_p, ctypes.c_longlong] * 2
            + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
            + [ctypes.c_int] + [ctypes.c_void_p] * 3)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.emsar_pe_candidates
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    return lib


def build() -> None:
    """Build and load the kernel library (no launch)."""
    _lib()


def pe_candidates(mpos: torch.Tensor, mrank: torch.Tensor, R: torch.Tensor,
                  RF: Optional[torch.Tensor], t32: torch.Tensor,
                  nsep: torch.Tensor, d0: int, nfl: int, rl: int,
                  borderpos: int, seqlength: int, unstranded: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keys and payloads of the M * nfl candidates of a chunk (see the
    module note).  All tensors are 1-d int32; ``RF`` is read only when
    ``unstranded`` (None otherwise)."""
    global LAUNCHES
    M = mpos.shape[0]
    if not (0 < nfl <= MAX_NFL and 0 < rl <= 1024
            and 0 <= d0 < (1 << 31) - MAX_NFL):
        raise ValueError(f"pe_candidates: nfl {nfl}, rl {rl} or d0 {d0} "
                         f"out of range")
    if M * nfl > MAX_CANDIDATES:
        raise ValueError(f"pe_candidates: {M} members x {nfl} slots exceed "
                         f"{MAX_CANDIDATES} candidates a launch")
    if unstranded and RF is None:
        raise ValueError("pe_candidates: an unstranded expansion reads RF")
    if mpos.device.type == "cpu":
        return pe_candidates_ref(mpos, mrank, R, RF, t32, nsep, d0, nfl, rl,
                                 borderpos, seqlength, unstranded)
    if mpos.device.type != "cuda":
        raise ValueError(f"pe_candidates: unsupported device {mpos.device}")
    tables = (("mpos", mpos), ("mrank", mrank), ("R", R), ("t32", t32),
              ("nsep", nsep)) + ((("RF", RF),) if RF is not None else ())
    for name, t in tables:
        if (t.device != mpos.device or t.dtype != torch.int32
                or t.dim() != 1 or not t.is_contiguous()):
            raise ValueError(f"pe_candidates: {name} must be a contiguous "
                             f"1-d int32 tensor on {mpos.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if mrank.shape[0] != M or (RF is not None and RF.shape[0] != R.shape[0]):
        raise ValueError("pe_candidates: mrank must match mpos and RF must "
                         "match R")
    keys = torch.empty(M * nfl, dtype=torch.int64, device=mpos.device)
    pay = torch.empty(M * nfl, dtype=torch.int32, device=mpos.device)
    if M == 0:
        return keys, pay
    stream = torch.cuda.current_stream(mpos.device).cuda_stream
    rc = _lib().emsar_pe_candidates(
        mpos.data_ptr(), mrank.data_ptr(), M, R.data_ptr(),
        RF.data_ptr() if RF is not None else None, R.shape[0],
        t32.data_ptr(), t32.shape[0], nsep.data_ptr(), nsep.shape[0], d0,
        nfl, rl, borderpos, seqlength, int(bool(unstranded)),
        keys.data_ptr(), pay.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pe_candidates: kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return keys, pay
