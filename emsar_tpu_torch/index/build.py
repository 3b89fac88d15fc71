"""rsh index construction: the backend dispatchers and the host NumPy
builders, without JAX.

``build_se_index`` and ``build_pe_index`` (``backend="auto"``) build on the
torch device (``index/device_build.py`` and ``index/device_build_pe.py``,
the ports of the JAX package's device-resident builders);
``backend="numpy"`` selects the host builders below, and so does
``-T``/``--print_sfa`` (the device builders never materialize the sfa).
Nothing else falls back: a device build that fails raises.

The NumPy builders are copies of the NumPy backends of
``emsar_tpu/index/build.py`` (and the NumPy branch of
``emsar_tpu/index/kernels.py::se_group``): that module imports
``jax.numpy`` when it loads.  Every backend writes the same bytes as
``emsar_tpu.index.build`` (``tests/test_torch_index_build.py``,
``tests/test_torch_device_build.py``, ``tests/test_torch_pe_build.py``).

SE semantics (reference preprocess_SE + construct_rshbucket_2,
src/emsar_functions.c:3243-3290, 1758-1819): for each read length, every
all-ACGT window of the forward half is keyed by its 2-bit packed words
(unstranded: the lexicographic min of the fw / rc window); windows are
grouped by full-key sort; each run of identical sequences of length L
contributes EUMA[sig, readlength] += 1 where sig is the sorted multiset of
the run's transcripts (L == 1 -> single-transcript segment; L >= MAX_REPEAT
dropped).

PE semantics (reference preprocess_PE + process_mate1_cluster_by_mate_3 +
construct_rshbucket_PE_3, src/emsar_functions.c:3294-3348, 2823-2934,
1902-1974): mate1 windows (both halves when unstranded) are grouped into
clusters of identical sequence; per cluster, every (position, d)
candidate with d in [Fmin-rl, Fmax-rl] yields a mate2 window at p+d
within the same transcript; unstranded candidates are kept only in
canonical pair orientation; candidates are grouped by (cluster, mate2
sequence); groups spanning several d are dropped, size-1 groups are
single-transcript segments, the others signatures at fragment length
d + readlength.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np

from ..config import BuildConfig
from ..io.fasta import Transcriptome
from ..io.rsh import RshIndex
from ..utils.timing import phase
from . import pack

_SIG_M1 = np.random.default_rng(0xC0FFEE).integers(
    1, 1 << 63, size=4096, dtype=np.uint64) | np.uint64(1)
_SIG_M2 = np.random.default_rng(0xFACade).integers(
    1, 1 << 63, size=4096, dtype=np.uint64) | np.uint64(1)


class SignatureAccumulator:
    """Accumulates EUMA counts per (signature, fraglen index).

    Single-transcript signatures go to a dense [ntid, nFraglen] array.
    Multi-transcript signatures (sorted int32 tid multisets) are buffered
    as flat CSR batches and merged at finalize() by 128-bit hash grouping
    with exact content verification.
    """

    def __init__(self, ntid: int, n_fraglen: int):
        self.ntid = ntid
        self.n_fraglen = n_fraglen
        self.single = np.zeros((ntid, n_fraglen), dtype=np.int64)
        self._flat: List[np.ndarray] = []
        self._sizes: List[np.ndarray] = []
        self._fl: List[np.ndarray] = []

    def add_single(self, tids: np.ndarray, fl_ind,
                   counts: Optional[np.ndarray] = None):
        if counts is None:
            counts = 1
        if np.isscalar(fl_ind):
            np.add.at(self.single[:, fl_ind], tids, counts)
        else:
            np.add.at(self.single, (tids, fl_ind), counts)

    def add_multi_batch(self, sig_flat: np.ndarray, sig_sizes: np.ndarray,
                        fl_inds: np.ndarray):
        """Buffer a batch of sorted-multiset signatures (CSR via sizes)."""
        if len(sig_sizes) == 0:
            return
        self._flat.append(np.ascontiguousarray(sig_flat, dtype=np.int32))
        self._sizes.append(np.ascontiguousarray(sig_sizes, dtype=np.int32))
        self._fl.append(np.ascontiguousarray(fl_inds, dtype=np.int32))

    def finalize(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Group identical signatures, return canonically ordered
        (sig_offsets, sig_tids, multi_euma)."""
        if not self._flat:
            return (np.zeros(1, dtype=np.int64), np.empty(0, dtype=np.int32),
                    np.zeros((0, self.n_fraglen), dtype=np.int64))
        flat = np.concatenate(self._flat)
        sizes = np.concatenate(self._sizes).astype(np.int64)
        fl = np.concatenate(self._fl)
        n = len(sizes)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(sizes, out=offsets[1:])

        # vectorized 128-bit multilinear hash of each signature
        sig_idx = np.repeat(np.arange(n), sizes)
        pos_in = np.arange(len(flat)) - np.repeat(offsets[:-1], sizes)
        vals = (flat.astype(np.uint64) + np.uint64(1))
        h1 = np.zeros(n, dtype=np.uint64)
        h2 = np.zeros(n, dtype=np.uint64)
        with np.errstate(over="ignore"):
            np.add.at(h1, sig_idx, vals * _SIG_M1[pos_in])
            np.add.at(h2, sig_idx, vals * _SIG_M2[pos_in])
            h1 += sizes.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
            h2 ^= sizes.astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)

        order = np.lexsort((h2, h1))
        hs1, hs2 = h1[order], h2[order]
        newgrp = np.concatenate([[True], (hs1[1:] != hs1[:-1]) |
                                 (hs2[1:] != hs2[:-1])])
        grp_of_sorted = np.cumsum(newgrp) - 1
        n_grp = int(grp_of_sorted[-1]) + 1
        rep_sorted_idx = np.flatnonzero(newgrp)  # first member per group
        rep = order[rep_sorted_idx]  # representative signature index

        # exact verification: every member must equal its representative
        grp_of = np.empty(n, dtype=np.int64)
        grp_of[order] = grp_of_sorted
        rep_of = rep[grp_of]
        ok = sizes == sizes[rep_of]
        if ok.all():
            # content comparison via flattened gathers
            mem_take = np.repeat(offsets[:-1], sizes) + pos_in
            rep_take = np.repeat(offsets[rep_of], sizes) + pos_in
            ok_flat = flat[mem_take] == flat[rep_take]
            mismatch = np.zeros(n, dtype=bool)
            np.logical_or.at(mismatch, sig_idx, ~ok_flat)
        else:
            mismatch = ~ok
        if mismatch.any():
            # hash collision (vanishingly rare): exact Python regroup of
            # the affected hash-groups
            bad_groups = np.unique(grp_of[mismatch])
            remap = {}
            for g in bad_groups:
                members = np.flatnonzero(grp_of == g)
                buckets = {}
                for m in members:
                    key = flat[offsets[m]:offsets[m + 1]].tobytes()
                    buckets.setdefault(key, []).append(m)
                items = list(buckets.items())
                for k, (key, ms) in enumerate(items):
                    gid = g if k == 0 else n_grp
                    if k > 0:
                        rep = np.append(rep, ms[0])
                        n_grp += 1
                    for m in ms:
                        remap[m] = (gid, ms[0])
            for m, (gid, r) in remap.items():
                grp_of[m] = gid
            rep_of = rep[grp_of]

        # canonical (size, tuple) order of the unique signatures
        rep_sizes = sizes[rep]
        max_sz = int(rep_sizes.max())
        padded = np.full((n_grp, max_sz), np.iinfo(np.int32).max,
                         dtype=np.int32)
        rep_rep = np.repeat(np.arange(n_grp), rep_sizes)
        rep_pos = (np.arange(rep_sizes.sum())
                   - np.repeat(np.cumsum(rep_sizes) - rep_sizes, rep_sizes))
        rep_take = np.repeat(offsets[rep], rep_sizes) + rep_pos
        padded[rep_rep, rep_pos] = flat[rep_take]
        keys = [padded[:, c] for c in range(max_sz - 1, -1, -1)] + [rep_sizes]
        canon_order = np.lexsort(tuple(keys))
        rank = np.empty(n_grp, dtype=np.int64)
        rank[canon_order] = np.arange(n_grp)

        # EUMA accumulation
        euma = np.zeros((n_grp, self.n_fraglen), dtype=np.int64)
        np.add.at(euma, (rank[grp_of], fl), 1)

        out_sizes = rep_sizes[canon_order]
        sig_offsets = np.zeros(n_grp + 1, dtype=np.int64)
        np.cumsum(out_sizes, out=sig_offsets[1:])
        pos_out = (np.arange(int(sig_offsets[-1]))
                   - np.repeat(sig_offsets[:-1], out_sizes))
        take = np.repeat(offsets[rep[canon_order]], out_sizes) + pos_out
        sig_tids = flat[take]
        return sig_offsets, sig_tids, euma


def _sorted_run_signatures(run_id: np.ndarray, tids: np.ndarray,
                           keep: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sorted tid multisets of the kept runs: (flat, sizes, kept_run_ids)."""
    mask = keep[run_id]
    rid = run_id[mask].astype(np.int64)
    t = tids[mask].astype(np.int64)
    # single composite radix sort beats a two-key lexsort
    ntid_bound = int(t.max()) + 1 if len(t) else 1
    order = np.argsort(rid * ntid_bound + t, kind="stable")
    rid = rid[order]
    t = t[order]
    kept_runs, counts = np.unique(rid, return_counts=True)
    return t.astype(np.int32), counts.astype(np.int32), kept_runs


def _radix_buckets(p16: np.ndarray, positions: np.ndarray, readlength: int,
                   prefix_bases: int) -> Tuple[np.ndarray, np.ndarray]:
    """Partition window positions by their first bases so identical windows
    always share a bucket (the reference's seqtag partitioning,
    generate_seqtag :1233, generalized)."""
    k = min(prefix_bases, readlength, pack.WORD_BASES)
    pref = p16[positions] >> np.uint32(2 * (pack.WORD_BASES - k))
    order = np.argsort(pref, kind="stable")
    positions = positions[order]
    pref = pref[order]
    diff = np.flatnonzero(pref[1:] != pref[:-1]) + 1
    bounds = np.concatenate([[0], diff, [len(positions)]])
    return positions, bounds


def _chunks(bounds: np.ndarray, budget: int):
    """Merge adjacent radix buckets into chunks of at most ~budget items."""
    start = 0
    while start < len(bounds) - 1:
        end = start + 1
        while (end < len(bounds) - 1 and
               bounds[end + 1] - bounds[start] <= budget):
            end += 1
        yield int(bounds[start]), int(bounds[end])
        start = end


def run_lengths(run_id: np.ndarray) -> np.ndarray:
    """Lengths of each run given 0-based increasing run ids."""
    if run_id.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    return np.bincount(run_id, minlength=int(run_id[-1]) + 1).astype(np.int64)


def se_group(p16: np.ndarray, positions: np.ndarray, seqlength: int,
             readlength: int, stranded: bool
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group window positions by (canonical) window sequence, on full keys.

    Returns (positions sorted by group, run_id, fw_is_canonical flags)."""
    N = positions.shape[0]
    if N == 0:
        z = np.zeros(0, dtype=np.int32)
        return positions, z, z
    W = pack.n_words(readlength)
    fw = pack.window_words_np(p16, positions, readlength)
    if stranded:
        words = fw
        canon = np.ones(N, dtype=bool)
    else:
        rc = pack.window_words_np(p16, seqlength - positions - readlength,
                                  readlength)
        cmp, words = pack.lexmin_words_np(fw, rc)
        canon = cmp <= 0
    order = np.lexsort(tuple(words[:, w] for w in range(W - 1, -1, -1)))
    sw = words[order]
    diff = np.any(sw[1:] != sw[:-1], axis=1)
    run_id = np.concatenate([np.zeros(1, np.int64),
                             np.cumsum(diff.astype(np.int64))])
    return positions[order].astype(np.int64), run_id, canon[order]


BACKENDS = ("device", "numpy")


def resolve_backend(backend: str = "auto") -> str:
    """'auto' is 'device'."""
    if backend == "auto":
        backend = "device"
    if backend not in BACKENDS:
        raise ValueError(f"unknown SE build backend {backend!r} "
                         f"(one of {', '.join(BACKENDS)})")
    return backend


def _host_for_sfa(backend: str, sfa_path: Optional[str],
                  cfg: BuildConfig) -> str:
    """-T/--print_sfa takes the host builder: the device builders never
    materialize the sfa."""
    if backend == "device" and sfa_path is not None:
        if cfg.verbose > 0:
            print("[emsar-build] falling back to the 'numpy' backend: "
                  "-T/--print_sfa requested (the device builder never "
                  "materializes the sfa)", file=sys.stderr, flush=True)
        return "numpy"
    return backend


def build_se_index(tx: Transcriptome, readlength_min: int,
                   readlength_max: int, cfg: BuildConfig,
                   backend: str = "auto", sfa_path: Optional[str] = None,
                   device=None) -> RshIndex:
    """Build an SE rsh index for a read-length range, on the torch device
    (``device``, else ``$EMSAR_TORCH_DEVICE``) or on the host."""
    backend = _host_for_sfa(resolve_backend(backend), sfa_path, cfg)
    if backend == "device":
        from ..device import resolve_device
        from .device_build import build_se_index_device
        return build_se_index_device(tx, readlength_min, readlength_max, cfg,
                                     resolve_device(device))
    fl_min, fl_max = readlength_min, readlength_max
    nfl = fl_max - fl_min + 1
    acc = SignatureAccumulator(tx.n_transcripts, nfl)

    p16 = pack.pack16(tx.codes)
    bad = pack.bad_prefix(tx.codes)
    stranded = cfg.strand.stranded

    for readlength in range(readlength_min, readlength_max + 1):
        fl_ind = readlength - fl_min
        with phase(f"SE l{readlength}: build", cfg.verbose):
            cand = np.arange(0, tx.borderpos - readlength + 1, dtype=np.int64)
            cand = cand[pack.valid_windows(bad, cand, readlength)]
            if cand.size == 0:
                continue
            prefix_bases = 0 if cand.size <= cfg.chunk_positions else 8
            if prefix_bases:
                cand, bounds = _radix_buckets(p16, cand, readlength,
                                              prefix_bases)
            else:
                bounds = np.array([0, cand.size], dtype=np.int64)
            sfa_chunks = [] if sfa_path else None
            for lo, hi in _chunks(bounds, cfg.chunk_positions):
                spos = _se_chunk(acc, tx, p16, cand[lo:hi], readlength,
                                 fl_ind, stranded, cfg.max_repeat)
                if sfa_chunks is not None:
                    sfa_chunks.append(spos)
            if sfa_chunks is not None:
                # the reference overwrites the .sfa per pass; last wins
                _write_sfa(sfa_path, np.concatenate(sfa_chunks))

    sig_offsets, sig_tids, multi_euma = acc.finalize()
    return RshIndex(names=list(tx.names), readlength=-1,
                    min_fraglength=fl_min, max_fraglength=fl_max,
                    single_euma=acc.single, sig_offsets=sig_offsets,
                    sig_tids=sig_tids, multi_euma=multi_euma)


def _se_chunk(acc: SignatureAccumulator, tx: Transcriptome, p16: np.ndarray,
              pos: np.ndarray, readlength: int, fl_ind: int, stranded: bool,
              max_repeat: int) -> None:
    spos, run_id, _ = se_group(p16, pos.astype(np.int32), tx.seqlength,
                               readlength, stranded)
    tids = tx.transcript_of(spos, readlength)
    lengths = run_lengths(run_id)

    singles = lengths == 1
    if singles.any():
        acc.add_single(tids[singles[run_id]], fl_ind)
    multi = (lengths > 1) & (lengths < max_repeat)
    if multi.any():
        sig_flat, sig_sizes, _ = _sorted_run_signatures(run_id, tids, multi)
        acc.add_multi_batch(sig_flat, sig_sizes,
                            np.full(len(sig_sizes), fl_ind, dtype=np.int32))
    return spos


def _write_sfa(path: str, positions: np.ndarray) -> None:
    """Debug dump of the grouped window positions (reference print_sfa,
    src/emsar_functions.c:1277-1295, format "i\\tpos"), as
    ``emsar_tpu/index/build.py::_write_sfa`` writes it."""
    with open(path, "w", buffering=1 << 20) as fh:
        for i, p in enumerate(positions):
            fh.write(f"{i}\t{p}\n")


# --------------------------------------------------------------------------
# PE build
# --------------------------------------------------------------------------


def build_pe_index(tx: Transcriptome, readlength: int, cfg: BuildConfig,
                   backend: str = "auto", sfa_path: Optional[str] = None,
                   shard=None, device=None) -> RshIndex:
    """Build a PE rsh index for one read length and a fragment-length
    range, on the torch device (``device``, else ``$EMSAR_TORCH_DEVICE``)
    or on the host.

    ``shard=(i, n)``: this process builds every n-th chunk of mate1
    clusters (device backend only); merge the partials with
    ``RshIndex.merge``."""
    backend = _host_for_sfa(resolve_backend(backend), sfa_path, cfg)
    if backend == "device":
        from ..device import resolve_device
        from .device_build_pe import build_pe_index_device
        return build_pe_index_device(tx, readlength, cfg,
                                     resolve_device(device), shard=shard)
    if shard is not None:
        raise ValueError("a sharded PE build (shard=) needs the device "
                         "backend")
    fl_min = max(cfg.min_fraglength, readlength)
    fl_max = max(cfg.max_fraglength, fl_min)
    nfl = fl_max - fl_min + 1
    acc = SignatureAccumulator(tx.n_transcripts, nfl)

    p16 = pack.pack16(tx.codes)
    bad = pack.bad_prefix(tx.codes)
    stranded = cfg.strand.stranded
    rl = readlength

    with phase("PE: mate1 windows", cfg.verbose):
        fwpos = np.arange(0, tx.borderpos - rl + 1, dtype=np.int64)
        fwpos = fwpos[pack.valid_windows(bad, fwpos, rl)]
        m1pos = fwpos if stranded else \
            np.concatenate([fwpos, tx.seqlength - fwpos - rl])

    with phase("PE: mate1 clustering", cfg.verbose):
        prefix_bases = 0 if m1pos.size <= cfg.chunk_positions else 8
        if prefix_bases:
            m1pos, bounds = _radix_buckets(p16, m1pos, rl, prefix_bases)
        else:
            bounds = np.array([0, m1pos.size], dtype=np.int64)
        pos_chunks, cl_chunks = [], []
        next_cluster = 0
        for lo, hi in _chunks(bounds, cfg.chunk_positions):
            if hi <= lo:
                continue
            # group by the mate1 window itself (no canonicalization)
            spos, rid, _ = se_group(p16, m1pos[lo:hi].astype(np.int32),
                                    tx.seqlength, rl, True)
            pos_chunks.append(spos)
            cl_chunks.append(rid.astype(np.int64) + next_cluster)
            next_cluster += int(rid[-1]) + 1
        m1_sorted = np.concatenate(pos_chunks) if pos_chunks else \
            np.zeros(0, np.int64)
        m1_cluster = np.concatenate(cl_chunks) if cl_chunks else \
            np.zeros(0, np.int64)
        if sfa_path:
            _write_sfa(sfa_path, m1_sorted)

    with phase("PE: mate2 expansion", cfg.verbose):
        _pe_expand(acc, tx, p16, bad, m1_sorted, m1_cluster, rl, fl_min,
                   fl_max, stranded, cfg)

    sig_offsets, sig_tids, multi_euma = acc.finalize()
    return RshIndex(names=list(tx.names), readlength=readlength,
                    min_fraglength=fl_min, max_fraglength=fl_max,
                    single_euma=acc.single, sig_offsets=sig_offsets,
                    sig_tids=sig_tids, multi_euma=multi_euma)


def _pe_expand(acc, tx: Transcriptome, p16, bad, m1pos, m1cluster, rl,
               fl_min, fl_max, stranded, cfg: BuildConfig):
    """Blocks of whole mate1 clusters, ``cfg.pe_chunk_candidates``
    candidates at most (a larger cluster is a block of its own)."""
    nfl = fl_max - fl_min + 1
    d0 = fl_min - rl  # >= 0 by clamping
    n = m1pos.shape[0]
    if n == 0:
        return
    budget = max(cfg.pe_chunk_candidates // max(nfl, 1), 1)
    cluster_starts = np.concatenate(
        [[0], np.flatnonzero(m1cluster[1:] != m1cluster[:-1]) + 1, [n]])
    bstart = 0
    while bstart < len(cluster_starts) - 1:
        bend = bstart + 1
        while (bend < len(cluster_starts) - 1 and
               cluster_starts[bend + 1] - cluster_starts[bstart] <= budget):
            bend += 1
        lo, hi = int(cluster_starts[bstart]), int(cluster_starts[bend])
        _pe_block_np(acc, tx, p16, bad, m1pos[lo:hi], m1cluster[lo:hi], d0,
                     nfl, rl, fl_min, stranded, cfg.max_repeat)
        bstart = bend


def _accumulate_pe_runs(acc, d_sorted, tid_sorted, run_id, rl, fl_min,
                        max_repeat):
    """Sorted PE candidate runs into the accumulator: size-1 runs are
    singles, runs of 1 < size < max_repeat at one d are signatures, runs
    over several d are dropped (src/emsar_functions.c:1926)."""
    lengths = run_lengths(run_id)
    first_mask = np.concatenate([[True], run_id[1:] != run_id[:-1]])
    run_first = np.zeros(len(lengths), dtype=np.int64)
    run_first[run_id[first_mask]] = np.flatnonzero(first_mask)
    fl_of_run = d_sorted[run_first] + rl - fl_min

    singles = lengths == 1
    if singles.any():
        smask = singles[run_id]
        acc.add_single(tid_sorted[smask], fl_of_run[run_id[smask]])
    d_min = np.full(len(lengths), np.iinfo(np.int64).max)
    d_max = np.full(len(lengths), np.iinfo(np.int64).min)
    np.minimum.at(d_min, run_id, d_sorted)
    np.maximum.at(d_max, run_id, d_sorted)
    multi = (lengths > 1) & (lengths < max_repeat) & (d_min == d_max)
    if multi.any():
        sig_flat, sig_sizes, kept = _sorted_run_signatures(run_id, tid_sorted,
                                                           multi)
        acc.add_multi_batch(sig_flat, sig_sizes, fl_of_run[kept])


def _pe_block_np(acc, tx: Transcriptome, p16, bad, pos, cluster, d0, nfl,
                 rl, fl_min, stranded, max_repeat):
    """The candidates of one block of whole mate1 clusters."""
    B = pos.shape[0]
    ds = d0 + np.arange(nfl, dtype=np.int64)
    cand = pos[:, None] + ds[None, :]
    in_range = cand <= tx.seqlength - rl
    cand_c = np.minimum(cand, tx.seqlength - rl)
    valid = in_range & (pack.valid_windows(bad, cand_c.ravel(), rl)
                        .reshape(B, nfl))
    tid1 = tx.transcript_of(pos, rl)
    tid2 = tx.transcript_of(cand_c.ravel(), rl).reshape(B, nfl)
    same_half = ~((pos[:, None] < tx.borderpos) & (cand_c > tx.borderpos))
    valid &= (tid2 == tid1[:, None]) & same_half

    if not stranded:
        flat = cand_c.ravel()
        keep = np.zeros(B * nfl, dtype=bool)
        vmask = valid.ravel()
        if vmask.any():
            p_rep = np.repeat(pos, nfl)[vmask]
            c_sel = flat[vmask]
            k_m1 = pack.window_words_np(p16, p_rep, rl)
            k_m1f = pack.window_words_np(p16, tx.seqlength - c_sel - rl, rl)
            cmp = pack.lexcmp_words_np(k_m1, k_m1f)
            tie = cmp == 0
            if tie.any():
                k_m2 = pack.window_words_np(p16, c_sel[tie], rl)
                k_m2f = pack.window_words_np(
                    p16, tx.seqlength - p_rep[tie] - rl, rl)
                cmp = cmp.copy()
                cmp[tie] = pack.lexcmp_words_np(k_m2, k_m2f)
            fwhalf = p_rep < tx.borderpos
            keep[np.flatnonzero(vmask)] = np.where(fwhalf, cmp <= 0, cmp < 0)
        valid = keep.reshape(B, nfl)

    vmask = valid.ravel()
    if not vmask.any():
        return
    m2sel = cand_c.ravel()[vmask]
    cl_sel = np.repeat(cluster, nfl)[vmask].astype(np.int64)
    d_sel = np.repeat(ds[None, :], B, axis=0).ravel()[vmask]
    tid_sel = np.repeat(tid1, nfl)[vmask]

    m2w = pack.window_words_np(p16, m2sel, rl)
    cl_lo = (cl_sel - cl_sel.min()).astype(np.uint32)
    words = np.concatenate([cl_lo[:, None], m2w], axis=1)
    order = np.lexsort(tuple(words[:, w]
                             for w in range(words.shape[1] - 1, -1, -1)))
    sw = words[order]
    diff = np.any(sw[1:] != sw[:-1], axis=1)
    run_id = np.concatenate([np.zeros(1, np.int64),
                             np.cumsum(diff.astype(np.int64))])
    _accumulate_pe_runs(acc, d_sel[order], tid_sel[order], run_id, rl,
                        fl_min, max_repeat)
