"""The SE hash pass of the index build: hand-written CUDA kernel and its
plain version.

``window_hash(codes, tidf, borderpos, seqlength, rl, unstranded)`` returns
``(h1, h2, h3, tid)``, int32 [n] with n = borderpos - rl + 1: for every
forward window start, the three 32-bit hash lanes of its canonical 2-bit
words (the JAX package's 96-bit window identity) as int32 bit patterns,
and its transcript id from ``tidf``; a window holding a non-ACGT code gets
all-ones lanes and tid -1.  It replaces
``emsar_tpu/index/device_build.py::_se_hash_slab`` with ``_p16_range``,
``_bad_win``, ``_slab_words_packed`` and ``_hash3_cols``; the CUDA source is
``csrc/window_hash.cu`` (a block per tile of 2048 windows, which it stages
in shared memory as 2-bit-packed words; what bounds it is written there).

On a CPU tensor the wrapper computes ``window_hash_ref``, the plain PyTorch
version: the same arithmetic in int64 masked to 32 bits (torch has no
uint32 add or shift on the CPU).  On a CUDA tensor it launches the kernel
or raises; it never falls back.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from . import _build

SOURCE = "window_hash.cu"
LAUNCHES = 0
MAX_WORDS = 64  # read lengths up to 1024
WORD_BASES = 16
_MASK = 0xFFFFFFFF
_MIX = 0x85EBCA6B


def _multipliers() -> np.ndarray:
    """The odd per-word lane multipliers of the JAX package's window hash
    (``emsar_tpu/index/kernels.py::_MULT``, same seed and draw)."""
    rng = np.random.default_rng(0x9E3779B97F4A7C15)
    m = rng.integers(0, 1 << 32, size=(4, MAX_WORDS), dtype=np.uint32)
    return m | 1


MULT = _multipliers()  # uint32 [4, 64]; lanes 0..2 are the window identity


def mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant m,
    with every partial product below 2^63."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors of the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _words(c3: torch.Tensor, start: int, n: int, rl: int, flip: bool):
    """The window words of n windows as int64 [n] columns.  Window k's
    first base is c3[start + k] (``flip``: c3[start - k])."""
    out = []
    for w in range((rl + WORD_BASES - 1) // WORD_BASES):
        nb = min(WORD_BASES, rl - WORD_BASES * w)
        word = torch.zeros(n, dtype=torch.int64, device=c3.device)
        for k in range(nb):
            p = start + WORD_BASES * w + k
            col = c3[p - n + 1:p + 1].flip(0) if flip else c3[p:p + n]
            word = (word << 2) | col
        out.append(word)
    return out


def window_hash_ref(codes: torch.Tensor, tidf: torch.Tensor, borderpos: int,
                    seqlength: int, rl: int, unstranded: bool
                    ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel (see the module note)."""
    n = borderpos - rl + 1
    c = codes.to(torch.int64)
    pref = torch.zeros(c.shape[0] + 1, dtype=torch.int64, device=c.device)
    torch.cumsum((c >= 4).to(torch.int64), 0, out=pref[1:])
    valid = (pref[rl:rl + n] - pref[:n]) == 0
    c3 = c & 3
    words = _words(c3, 0, n, rl, flip=False)
    if unstranded:
        rc = _words(c3, seqlength - rl, n, rl, flip=True)
        cmp = torch.zeros(n, dtype=torch.int64, device=c.device)
        for f, r in zip(words, rc):
            cmp = torch.where(cmp == 0, (f > r).long() - (f < r).long(), cmp)
        words = [torch.where(cmp <= 0, f, r) for f, r in zip(words, rc)]
    lanes = []
    for lane in range(3):
        acc = torch.zeros(n, dtype=torch.int64, device=c.device)
        for w, word in enumerate(words):
            acc = (acc + mul32(word, int(MULT[lane, w]))) & _MASK
            acc = acc ^ (((acc >> 16) * _MIX) & _MASK)
        lanes.append(torch.where(valid, to_int32_bits(acc), -1))
    tid = torch.where(valid, tidf[:n], -1).to(torch.int32)
    return lanes[0], lanes[1], lanes[2], tid


def bytes_moved(borderpos: int, rl: int, unstranded: bool) -> int:
    """Bytes the function must move, each once: the forward codes
    [0, borderpos) that its windows read, the rc stretch of as many bytes
    when unstranded (a stranded run reads no rc code), the n windows'
    tids, and the four int32 outputs."""
    n = borderpos - rl + 1
    return (2 if unstranded else 1) * borderpos + 4 * n + 16 * n


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.emsar_window_hash
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
    return lib


@functools.lru_cache(maxsize=None)
def _mult_on(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(MULT[:3].view(np.int32).copy()).to(device)


def build() -> None:
    """Build and load the kernel library (no launch)."""
    _lib()


def window_hash(codes: torch.Tensor, tidf: torch.Tensor, borderpos: int,
                seqlength: int, rl: int, unstranded: bool
                ) -> Tuple[torch.Tensor, ...]:
    """Hash lanes and tids of the n = borderpos - rl + 1 forward windows:
    codes [seqlength + 1] uint8, tidf [>= n] int32.  Returns (h1, h2, h3,
    tid), int32 [n]."""
    global LAUNCHES
    n = borderpos - rl + 1
    if not 0 < rl <= WORD_BASES * MAX_WORDS:
        raise ValueError(f"window_hash: read length {rl} outside "
                         f"[1, {WORD_BASES * MAX_WORDS}]")
    if n <= 0 or codes.shape[0] != seqlength + 1 or tidf.shape[0] < n:
        raise ValueError(f"window_hash: {n} windows need codes of "
                         f"{seqlength + 1} and tidf of >= {n} entries, got "
                         f"{codes.shape[0]} and {tidf.shape[0]}")
    if codes.device.type == "cpu":
        return window_hash_ref(codes, tidf, borderpos, seqlength, rl,
                               unstranded)
    if codes.device.type != "cuda":
        raise ValueError(f"window_hash: unsupported device {codes.device}")
    for name, t, dtype in (("codes", codes, torch.uint8),
                           ("tidf", tidf, torch.int32)):
        if (t.device != codes.device or t.dtype != dtype or t.dim() != 1
                or not t.is_contiguous()):
            raise ValueError(f"window_hash: {name} must be a contiguous 1-d "
                             f"{dtype} tensor on {codes.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = [torch.empty(n, dtype=torch.int32, device=codes.device)
           for _ in range(4)]
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    rc = _lib().emsar_window_hash(
        codes.data_ptr(), tidf.data_ptr(), _mult_on(codes.device).data_ptr(),
        n, seqlength, rl, int(bool(unstranded)),
        *(t.data_ptr() for t in out), stream)
    if rc != 0:
        raise RuntimeError(f"window_hash: kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return tuple(out)
