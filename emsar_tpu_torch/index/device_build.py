"""Device-resident SE rsh index construction, in PyTorch.

The port of ``emsar_tpu/index/device_build.py::build_se_index_device``: the
same ``.rsh`` bytes as ``emsar_tpu.index.build.build_se_index``, with the
window grouping, the run accumulation and the signature merge on the
device; the host receives one row per distinct signature.

Per read length l (reference preprocess_SE + construct_rshbucket_2,
src/emsar_functions.c:3243-3290, 1758-1819):

1. hash: ``kernels.window_hash`` gives every forward window start its
   96-bit canonical-window identity (h1, h2, h3) and tid, -1 when the
   window holds a non-ACGT base;
2. sort: the valid rows are ordered by the identity with two stable sorts
   (h3, then the 64-bit key of h1 and h2); a run is a maximal block of
   equal identities;
3. accumulate: a run of one window adds 1 to ``single[tid, l]``; a run
   of 1 < size < max_repeat is one record of its sorted tid multiset at
   l; longer runs are dropped.  The records of l are merged into distinct
   signatures on the device (``_group_signatures``: multiset hash lanes,
   sort, exact check of every member against its group's exemplar).

Then the per-length tables are merged the same way across read lengths,
and the host puts the distinct signatures into the canonical (size,
tuple) order (``emsar_tpu/index/build.py`` ``SignatureAccumulator``).

What the JAX module needs and this port does not: the TPU's static shapes,
16 GB of HBM and slow host link made it keep claim tables and exemplar
extraction, fixed-capacity record tables with drains and folds
(``_maintain``, ``_tab_fold``/``_tab_finalize``), demand probes and a radix
partition by hash bits.  PyTorch has dynamic shapes (``nonzero``, boolean
masks, ``unique_consecutive``) and the H100 80 GB, so one global sort per
read length holds a human-scale transcriptome (~338 M windows at 16 B of
payload each).  Every scatter here has in-range indices by construction
(the JAX code relies on ``mode="drop"`` for its pad rows).

Windows are grouped by their 96-bit hash, as in the JAX package, not by
the bases themselves; signatures are grouped by a 96-bit multiset hash
plus size and then checked exactly.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from emsar_tpu.config import BuildConfig
from emsar_tpu.io.fasta import Transcriptome
from emsar_tpu.io.rsh import RshIndex
from emsar_tpu.utils.timing import phase

from ..kernels.window_hash import MAX_WORDS, WORD_BASES, mul32, window_hash

_MASK = 0xFFFFFFFF
# multiset-hash lanes of a tid (emsar_tpu/index/device_build.py _LANE_MUL,
# _LANE_ADD and _mix32)
_LANE_MUL = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D)
_LANE_ADD = (0x27D4EB2F, 0x165667B1, 0x9E3779B9)


class DeviceRef:
    """The transcriptome on the device: its codes (uint8, 0-3 for ACGT and
    4 for every other character, fw half, '$', rc half, '$'), uploaded
    once, and the transcript start positions."""

    def __init__(self, tx: Transcriptome, device: torch.device):
        self.tx = tx
        self.borderpos = int(tx.borderpos)
        self.seqlength = int(tx.seqlength)
        self.codes = torch.as_tensor(
            np.ascontiguousarray(tx.codes, dtype=np.uint8)).to(device)
        self.cuml = torch.as_tensor(tx.cuml.astype(np.int64)).to(device)

    def tid_forward(self, n: int) -> torch.Tensor:
        """int32 [n]: the tid of every forward position in [0, n), a cumsum
        over transcript-start marks (``_tid_forward``).  Starts at or past
        n are masked out rather than dropped by the scatter."""
        marks = torch.zeros(n, dtype=torch.int32, device=self.codes.device)
        marks[self.cuml[self.cuml < n]] = 1
        return torch.cumsum(marks, 0, dtype=torch.int32) - 1


def _sync(device: torch.device) -> None:
    """Finish the device's queued work, so a phase timer holds it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _lex_order(keys: List[torch.Tensor]) -> torch.Tensor:
    """The permutation that sorts rows lexicographically by ``keys``
    (primary first): stable sorts from the last key to the first."""
    order = None
    for k in reversed(keys):
        o = torch.sort(k if order is None else k[order], stable=True).indices
        order = o if order is None else order[o]
    return order


def _run_starts(sorted_keys: List[torch.Tensor]) -> torch.Tensor:
    """bool [N]: row i starts a run (any key differs from row i - 1)."""
    n = sorted_keys[0].shape[0]
    start = torch.ones(n, dtype=torch.bool, device=sorted_keys[0].device)
    if n > 1:
        diff = sorted_keys[0][1:] != sorted_keys[0][:-1]
        for k in sorted_keys[1:]:
            diff |= k[1:] != k[:-1]
        start[1:] = diff
    return start


def _key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key of two 32-bit lanes (int32 bit patterns or int64 values
    in [0, 2^32)): (hi - 2^31) << 32 | lo, exact in int64."""
    hi = hi.to(torch.int64) & _MASK
    lo = lo.to(torch.int64) & _MASK
    return ((hi - (1 << 31)) << 32) | lo


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _offsets(sizes: torch.Tensor) -> torch.Tensor:
    off = torch.zeros(sizes.shape[0] + 1, dtype=torch.int64,
                      device=sizes.device)
    torch.cumsum(sizes, 0, out=off[1:])
    return off


def _signature_keys(flat: torch.Tensor, sizes: torch.Tensor
                    ) -> List[torch.Tensor]:
    """Two int64 keys per signature: its three multiset-hash lanes (sums of
    per-tid lanes mod 2^32, as ``_sig_lanes``) and its size."""
    t = flat.to(torch.int64)
    off = _offsets(sizes)
    sums = []
    for m, a in zip(_LANE_MUL, _LANE_ADD):
        lane = _mix32((mul32(t, m) + a) & _MASK)
        cs = torch.zeros(t.shape[0] + 1, dtype=torch.int64, device=t.device)
        torch.cumsum(lane, 0, out=cs[1:])
        sums.append((cs[off[1:]] - cs[off[:-1]]) & _MASK)
    return [_key64(sums[0], sums[1]), (sizes << 32) | sums[2]]


def _group_signatures(flat: torch.Tensor, sizes: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group identical signatures (sorted tid lists, CSR by ``sizes``).
    Returns (group of every signature [n], exemplar signature of every
    group [G]): groups come from the multiset hash and size, and every
    member is then compared with its exemplar element by element; a hash
    collision (not met in practice) is split exactly on the host."""
    n = sizes.shape[0]
    keys = _signature_keys(flat, sizes)
    order = _lex_order(keys)
    start = _run_starts([k[order] for k in keys])
    group = torch.empty(n, dtype=torch.int64, device=flat.device)
    group[order] = torch.cumsum(start, 0) - 1
    rep = order[start]
    off = _offsets(sizes)
    sig_of = torch.repeat_interleave(
        torch.arange(n, device=flat.device), sizes)
    pos = torch.arange(flat.shape[0], device=flat.device) - off[sig_of]
    same = flat == flat[off[rep[group]][sig_of] + pos]
    if not bool(same.all()):
        group, rep = _split_collisions(flat, off, group, rep,
                                       torch.unique(sig_of[~same]))
    return group, rep


def _split_collisions(flat, off, group, rep, bad_sigs):
    """Exact regrouping, on the host, of the groups holding a signature
    that differs from its exemplar."""
    group_h = group.cpu().numpy()
    rep_h = list(rep.cpu().numpy())
    flat_h = flat.cpu().numpy()
    off_h = off.cpu().numpy()
    for g in np.unique(group_h[bad_sigs.cpu().numpy()]):
        buckets = {}
        for s in np.flatnonzero(group_h == g):
            key = flat_h[off_h[s]:off_h[s + 1]].tobytes()
            buckets.setdefault(key, []).append(s)
        for k, members in enumerate(buckets.values()):
            gid = g if k == 0 else len(rep_h)
            if k == 0:
                rep_h[g] = members[0]
            else:
                rep_h.append(members[0])
            group_h[members] = gid
    dev = group.device
    return (torch.as_tensor(group_h).to(dev),
            torch.as_tensor(np.asarray(rep_h, dtype=np.int64)).to(dev))


def _take(flat: torch.Tensor, sizes: torch.Tensor, rows: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The signatures ``rows`` of a CSR table, as (flat, sizes)."""
    sz = sizes[rows]
    src_off = _offsets(sizes)[rows]
    dst_off = _offsets(sz)
    src = (torch.repeat_interleave(src_off - dst_off[:-1], sz)
           + torch.arange(int(dst_off[-1]), device=flat.device))
    return flat[src], sz


def _merge(flat: torch.Tensor, sizes: torch.Tensor, counts: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distinct signatures of a table with their summed counts [G, nfl]."""
    group, rep = _group_signatures(flat, sizes)
    merged = counts.new_zeros((rep.shape[0], counts.shape[1]))
    merged.index_add_(0, group, counts)
    return (*_take(flat, sizes, rep), merged)


def _window_runs(ref: DeviceRef, tidf: torch.Tensor, rl: int,
                 unstranded: bool, verbose: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hash and sort the windows of read length ``rl``: (tid of every valid
    window in identity order, run-start flags)."""
    dev = ref.codes.device
    with phase(f"SE dev: l{rl} hash", verbose):
        h1, h2, h3, tid = window_hash(ref.codes, tidf, ref.borderpos,
                                      ref.seqlength, rl, unstranded)
        keep = tid >= 0
        key = _key64(h1[keep], h2[keep])
        del h1, h2
        h3, tid = h3[keep], tid[keep]
        del keep
        _sync(dev)
    with phase(f"SE dev: l{rl} sort ({key.shape[0]} windows)", verbose):
        order = _lex_order([key, h3])
        keys = [key[order], h3[order]]
        del key, h3
        tid = tid[order]
        del order
        start = _run_starts(keys)
        del keys
        _sync(dev)
    return tid, start


def _accumulate(tid: torch.Tensor, start: torch.Tensor, ntid: int,
                max_repeat: int, single_col: torch.Tensor):
    """Runs of one read length: singles into ``single_col`` (int64
    [ntid], in place); returns the records of 1 < size < max_repeat as
    (sorted tids, sizes)."""
    n = tid.shape[0]
    run = torch.cumsum(start, 0) - 1
    starts = torch.nonzero(start).squeeze(1)
    lengths = torch.diff(starts, append=starts.new_tensor([n]))
    len_row = lengths[run]
    del starts, lengths
    single_col += torch.bincount(tid[len_row == 1].to(torch.int64),
                                 minlength=ntid)
    multi = (len_row > 1) & (len_row < max_repeat)
    del len_row
    mrun = run[multi]
    mtid = tid[multi].to(torch.int64)
    del run, multi
    order = torch.sort(mrun * ntid + mtid).indices
    flat = mtid[order]
    _, sizes = torch.unique_consecutive(mrun[order], return_counts=True)
    return flat, sizes


def _canonical(flat: np.ndarray, sizes: np.ndarray, counts: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Distinct signatures in the canonical (size, tuple) order
    (``SignatureAccumulator.finalize``): (sig_offsets, sig_tids,
    multi_euma)."""
    n = len(sizes)
    nfl = counts.shape[1]
    if n == 0:
        return (np.zeros(1, dtype=np.int64), np.empty(0, dtype=np.int32),
                np.zeros((0, nfl), dtype=np.int64))
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(sizes, out=off[1:])
    padded = np.full((n, int(sizes.max())), np.iinfo(np.int32).max,
                     dtype=np.int32)
    row = np.repeat(np.arange(n), sizes)
    col = np.arange(len(flat)) - off[row]
    padded[row, col] = flat
    keys = [padded[:, c] for c in range(padded.shape[1] - 1, -1, -1)]
    canon = np.lexsort(tuple(keys) + (sizes,))
    out_sizes = sizes[canon]
    sig_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(out_sizes, out=sig_offsets[1:])
    sig_tids = padded[canon][np.arange(out_sizes.max())[None, :]
                             < out_sizes[:, None]]
    return sig_offsets, sig_tids.astype(np.int32), counts[canon]


def build_se_index_device(tx: Transcriptome, readlength_min: int,
                          readlength_max: int, cfg: BuildConfig,
                          device: torch.device) -> RshIndex:
    """SE rsh index over a read-length range, built on ``device`` (see the
    module note).  Raises when a step fails; on CUDA an allocation the
    card cannot hold raises with the build's size."""
    lmin, lmax = int(readlength_min), int(readlength_max)
    if not 0 < lmin <= lmax:
        raise ValueError(f"invalid read-length range {lmin}-{lmax}")
    if lmax > WORD_BASES * MAX_WORDS:
        raise ValueError(f"read length {lmax} > {WORD_BASES * MAX_WORDS}")
    try:
        return _build_se(tx, lmin, lmax, cfg, device)
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(
            f"the SE device build of {tx.borderpos} bp does not fit the "
            f"memory of {device}: {e}") from e


def _build_se(tx, lmin, lmax, cfg, device) -> RshIndex:
    ntid = tx.n_transcripts
    nfl = lmax - lmin + 1
    unstranded = not cfg.strand.stranded
    with phase("SE dev: reference upload", cfg.verbose):
        ref = DeviceRef(tx, device)
        n0 = max(ref.borderpos - lmin + 1, 0)
        tidf = ref.tid_forward(n0)
        _sync(device)
    single = torch.zeros((nfl, ntid), dtype=torch.int64, device=device)
    tables = []
    for rl in range(lmin, lmax + 1):
        if ref.borderpos - rl + 1 <= 0:
            continue
        tid, start = _window_runs(ref, tidf, rl, unstranded, cfg.verbose)
        with phase(f"SE dev: l{rl} accumulate", cfg.verbose):
            flat, sizes = _accumulate(tid, start, ntid, int(cfg.max_repeat),
                                      single[rl - lmin])
            del tid, start
            if sizes.shape[0]:
                counts = torch.zeros((sizes.shape[0], nfl),
                                     dtype=torch.int64, device=device)
                counts[:, rl - lmin] = 1
                tables.append(_merge(flat, sizes, counts))
            del flat, sizes
            _sync(device)
    del ref, tidf
    with phase("SE dev: finalize", cfg.verbose):
        if len(tables) > 1:
            tables = [_merge(*(torch.cat(parts) for parts in zip(*tables)))]
        if tables:
            flat, sizes, counts = (t.cpu().numpy() for t in tables[0])
        else:
            flat, sizes = np.empty(0, np.int64), np.empty(0, np.int64)
            counts = np.zeros((0, nfl), np.int64)
        sig_offsets, sig_tids, multi_euma = _canonical(flat, sizes, counts)
        index = RshIndex(names=list(tx.names), readlength=-1,
                         min_fraglength=lmin, max_fraglength=lmax,
                         single_euma=np.ascontiguousarray(
                             single.T.cpu().numpy()),
                         sig_offsets=sig_offsets, sig_tids=sig_tids,
                         multi_euma=multi_euma)
    return index
