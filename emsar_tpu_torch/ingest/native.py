"""ctypes binding for the C++ ingest engine (csrc/ingest.cc).

Compiled on first use with g++ (cached next to the package); falls back to
the pure-Python path when no compiler / zlib is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import List, Optional

import numpy as np

from ..io.rsh import RshIndex
from .collapse import SampleCounts

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _find_csrc() -> str:
    """csrc/ directory of this package (shipped as package data)."""
    return os.path.join(_PKG_DIR, "csrc")


_CSRC = _find_csrc()
_SRCS = [os.path.join(_CSRC, "ingest.cc"), os.path.join(_CSRC, "solver.cc")]
_SO_DIR = os.path.join(_PKG_DIR, "_build")
_SO = os.path.join(_SO_DIR, "libemsar_ingest.so")

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _build() -> bool:
    os.makedirs(_SO_DIR, exist_ok=True)
    if (os.path.exists(_SO) and
            all(os.path.getmtime(_SO) >= os.path.getmtime(s)
                for s in _SRCS)):
        return True
    # one temporary file per process: test workers may build at once
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-std=c++20", "-shared", "-fPIC",
                        *_SRCS, "-o", tmp, "-lz"],
                       check=True, capture_output=True)
        os.replace(tmp, _SO)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        msg = getattr(e, "stderr", b"")
        print(f"[emsar] native ingest build failed, using Python path: "
              f"{msg[:500] if msg else e}", file=sys.stderr)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        if os.environ.get("EMSAR_TPU_NO_NATIVE"):
            _LIB_FAILED = True
            return None
        if not _build():
            _LIB_FAILED = True
            return None
        lib = ctypes.CDLL(_SO)
        lib.emsar_make_name_table.restype = ctypes.c_void_p
        lib.emsar_make_name_table.argtypes = [ctypes.c_char_p, _i64p,
                                              ctypes.c_int64]
        lib.emsar_free_name_table.argtypes = [ctypes.c_void_p]
        lib.emsar_make_sig_table.restype = ctypes.c_void_p
        lib.emsar_make_sig_table.argtypes = [_i64p, _i32p, ctypes.c_int64]
        lib.emsar_free_sig_table.argtypes = [ctypes.c_void_p]
        lib.emsar_ingest_last_error.restype = ctypes.c_char_p
        # trailing posbias block (nullable pointers): tlen, freq_len,
        # freq5, freq3, unavail-mark
        _pb = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p]
        lib.emsar_ingest_bowtie.restype = ctypes.c_int
        lib.emsar_ingest_bowtie.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            _u8p, _i64p, _i64p, _i64p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int] + _pb
        lib.emsar_ingest_bam.restype = ctypes.c_int
        lib.emsar_ingest_bam.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, _u8p, _i64p, _i64p, _i64p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int] + _pb
        _u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.emsar_group_rows.restype = ctypes.c_int64
        lib.emsar_group_rows.argtypes = [_u64p, _u64p, ctypes.c_void_p,
                                         ctypes.c_int64, _i64p, _i64p]
        lib.emsar_polish_squarem.restype = ctypes.c_int64
        lib.emsar_polish_squarem.argtypes = [
            _i32p, _i32p, _f64p, ctypes.c_int64, _f64p, _f64p,
            ctypes.c_int64, _f64p, ctypes.c_int64, _f64p, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int]
        _LIB = lib
        return _LIB


def group_rows(h1: np.ndarray, h2: np.ndarray,
               extra: Optional[np.ndarray] = None):
    """Group rows by exact (h1, h2[, extra]) equality via the C++
    open-addressing table.  Returns (perm, run_id, n_groups): ``perm``
    orders elements so groups are contiguous (first-appearance order),
    ``run_id`` is the group index per permuted position."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native grouping unavailable")
    n = len(h1)
    perm = np.empty(n, dtype=np.int64)
    run_id = np.empty(n, dtype=np.int64)
    h1 = np.ascontiguousarray(h1, dtype=np.uint64)
    h2 = np.ascontiguousarray(h2, dtype=np.uint64)
    if extra is not None:
        extra = np.ascontiguousarray(extra, dtype=np.uint64)
        eptr = extra.ctypes.data_as(ctypes.c_void_p)
    else:
        eptr = None
    ng = lib.emsar_group_rows(h1, h2, eptr, n, perm, run_id)
    if ng < 0:
        raise MemoryError("emsar_group_rows failed")
    return perm, run_id, int(ng)


def polish_squarem(e_cid: np.ndarray, e_tid: np.ndarray, mult: np.ndarray,
                   eumaps: np.ndarray, reads: np.ndarray,
                   inv_denom: np.ndarray, theta: np.ndarray,
                   epsilon: float, max_cycles: int,
                   skip_unread: bool = False) -> int:
    """In-place float64 SQUAREM polish (csrc/solver.cc); returns the
    number of cycles run.  ``skip_unread`` leaves the read term of a
    segment without reads out of the gain (the JAX package's library
    keeps it: see ``kernels.csr_cycle.gain_terms``).  Raises RuntimeError
    when the native library is unavailable (callers fall back to the NumPy
    implementation)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native polish unavailable")
    e_cid = np.ascontiguousarray(e_cid, dtype=np.int32)
    e_tid = np.ascontiguousarray(e_tid, dtype=np.int32)
    mult = np.ascontiguousarray(mult, dtype=np.float64)
    eumaps = np.ascontiguousarray(eumaps, dtype=np.float64)
    reads = np.ascontiguousarray(reads, dtype=np.float64)
    inv_denom = np.ascontiguousarray(inv_denom, dtype=np.float64)
    assert theta.dtype == np.float64 and theta.flags.c_contiguous
    return int(lib.emsar_polish_squarem(
        e_cid, e_tid, mult, len(e_cid), eumaps, reads, len(eumaps),
        inv_denom, len(inv_denom), theta, float(epsilon), int(max_cycles),
        int(bool(skip_unread))))


def available() -> bool:
    return _load() is not None


class NativeCollapser:
    """Holds the native name + signature tables for an index."""

    def __init__(self, index: RshIndex):
        lib = _load()
        if lib is None:
            raise RuntimeError("native ingest unavailable")
        self._lib = lib
        self.index = index
        blob = b"".join(n.encode("latin-1") + b"" for n in index.names)
        # offsets into the concatenated names
        lens = np.fromiter((len(n.encode("latin-1")) for n in index.names),
                           dtype=np.int64, count=len(index.names))
        offs = np.zeros(len(index.names) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        self._name_blob = blob  # keep alive
        self._name_table = lib.emsar_make_name_table(blob, offs,
                                                     len(index.names))
        self._sig_offsets = np.ascontiguousarray(index.sig_offsets,
                                                 dtype=np.int64)
        self._sig_tids = np.ascontiguousarray(index.sig_tids, dtype=np.int32)
        self._sig_table = lib.emsar_make_sig_table(
            self._sig_offsets, self._sig_tids, index.n_multi)
        self._has_single = np.ascontiguousarray(
            index.has_single.astype(np.uint8))

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            if getattr(self, "_name_table", None):
                lib.emsar_free_name_table(self._name_table)
            if getattr(self, "_sig_table", None):
                lib.emsar_free_sig_table(self._sig_table)

    def collapse_file(self, path: str, fmt: str, pe: bool, strand_code: int,
                      max_repeat: int, min_fraglength: int,
                      max_fraglength: int,
                      readlength_holder: Optional[List[int]] = None,
                      nthreads: int = 0, posbias=None) -> SampleCounts:
        """nthreads: bowtie-format files are split at read-group boundaries
        and parsed+collapsed by that many threads into private buffers
        (counts are exactly the sequential ones — unlike the reference's
        racy -p mode).  0 = one thread per CPU.

        ``posbias``: an ``ingest.collapse.PosBias`` to accumulate into
        (-m 1 path); the native code adds directly into its ``freq_5``/
        ``freq_3`` arrays and emits unavailability *marks* which are
        suffix-summed here (identical semantics to PosBias.add)."""
        idx = self.index
        hist_size = max(max_fraglength, idx.fraglen_max) + 1
        single = np.zeros(idx.n_transcripts, dtype=np.int64)
        multi = np.zeros(idx.n_multi, dtype=np.int64)
        hist = np.zeros(hist_size, dtype=np.int64)
        total = ctypes.c_int64(0)
        rl = ctypes.c_int64(readlength_holder[0] if readlength_holder else -1)

        if posbias is not None:
            pb_tlen = np.ascontiguousarray(posbias.tlen, dtype=np.int64)
            pb5 = posbias.freq_5
            pb3 = posbias.freq_3
            assert (pb5.dtype == np.float64 and pb5.flags.c_contiguous and
                    pb3.dtype == np.float64 and pb3.flags.c_contiguous)
            pb_mark = np.zeros(posbias.freq_len, dtype=np.float64)
            _p = ctypes.c_void_p
            pb_args = (_p(pb_tlen.ctypes.data), posbias.freq_len,
                       _p(pb5.ctypes.data), _p(pb3.ctypes.data),
                       _p(pb_mark.ctypes.data))
        else:
            pb_args = (None, 0, None, None, None)

        if nthreads <= 0:
            # cgroup/affinity-aware CPU count (os.cpu_count() reports the
            # physical host and oversubscribes in constrained containers)
            try:
                nthreads = len(os.sched_getaffinity(0))
            except (AttributeError, OSError):
                nthreads = os.cpu_count() or 1
        if fmt == "bowtie":
            rc = self._lib.emsar_ingest_bowtie(
                path.encode(), int(pe), strand_code, max_repeat,
                min_fraglength, max_fraglength, self._name_table,
                self._sig_table, self._has_single, single, multi, hist,
                hist_size, ctypes.byref(total), ctypes.byref(rl),
                int(nthreads), *pb_args)
        else:
            rc = self._lib.emsar_ingest_bam(
                path.encode(), int(fmt == "sam"), int(pe), strand_code,
                max_repeat, min_fraglength, max_fraglength, self._name_table,
                self._sig_table, self._has_single, single, multi, hist,
                hist_size, ctypes.byref(total), ctypes.byref(rl),
                int(nthreads), *pb_args)
        if rc != 0:
            err = self._lib.emsar_ingest_last_error().decode("latin-1")
            raise ValueError(f"native ingest failed ({rc}): {err}")
        if readlength_holder is not None:
            readlength_holder[0] = int(rl.value)
        if posbias is not None:
            # mark[t] = weight of transcripts with tlen == t; PosBias adds
            # that weight to every unavailable position >= tlen
            unavail = np.cumsum(pb_mark)
            posbias.unavail_5 += unavail
            posbias.unavail_3 += unavail
        return SampleCounts(single_counts=single, multi_counts=multi,
                            fraglength_counts=hist,
                            total_read_count=int(total.value))
