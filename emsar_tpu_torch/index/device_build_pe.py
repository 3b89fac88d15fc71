"""Device-resident PE rsh index construction, in PyTorch.

The port of ``emsar_tpu/index/device_build.py::build_pe_index_device``:
the same ``.rsh`` bytes as ``emsar_tpu.index.build.build_pe_index``, with
the mate1 grouping, the candidate expansion, the run accumulation and the
signature merge on the device; the host receives one row per distinct
signature.  Reference semantics: preprocess_PE +
process_mate1_cluster_by_mate_3 + construct_rshbucket_PE_3
(src/emsar_functions.c:3294-3348, 2823-2934, 1902-1974).

1. rank pass: ``kernels.window_hash`` in its literal (stranded) mode hashes
   every mate1 window (the forward half; both halves when unstranded, by
   hashing [0, seqlength - rl] with the central '$' as an ordinary
   non-ACGT code); one sort by the 96-bit identity gives every valid
   window a rank, equal windows one rank, so R[pos] is the window's
   cluster and the rank-sorted positions hold each cluster's members
   together.  Unstranded builds also take RF[p] = R[seqlength - rl - p],
   the rank of the window's reverse complement.
2. chunks: runs of whole clusters of the rank-sorted positions, each
   weighing at most a candidate budget sized from the card's free memory
   at the start of the build (a fixed budget for a sharded build, so that
   every process plans the same chunks): a member of a multi-member
   cluster weighs its nfl candidates, a singleton member one.
3. per chunk, ``kernels.pe_candidates`` (CUDA) expands every (member, dd)
   candidate: a singleton member's row is resolved in the kernel (a slot
   whose mate2 rank is unique among the row's valid slots adds 1 to
   ``single[tid, dd]``, the others are the multi-d drop), and only the
   valid candidates of the other members are written, each with its key,
   mate1 rank << 30 | mate2 rank, and its payload tid << 9 | dd; one
   ``torch.sort`` of those keys groups the reference's (mate1 sequence,
   mate2 sequence) runs.
4. accumulate: a run of one adds 1 to ``single[tid, dd]``; a run of
   1 < size < max_repeat whose members share one dd is one record of its
   sorted tid multiset at dd; runs over several dd are dropped (the
   reference's multi-d drop, src/emsar_functions.c:1926).  Records become
   distinct signatures (``_group_signatures`` of the SE build) with
   sparse (signature, dd, count) cells, merged into a running table.

Orientation and canonical pairs are decided on ranks instead of string
order: any total order with exact equality gives the same kept-candidate
multiset per group, so ranks need not equal the JAX package's.

What the JAX module needs and this port does not: the TPU's static shapes
and 16 GB of HBM made it keep a slab singleton pass over a neighbour-gap
table (``_pe_single_slabs``, ``_dd_pack``, ``_dd_from_stream``: a speed
device for XLA's slow gathers), HBM trimming
(``_pe_partition_clusters``, ``_pe_compact_multi``, ``_shrink``,
``_resize_table``), fixed-capacity record tables (``_caps_partitioned``,
``_maintain``, the ``_tab_*`` folds, claim tables, ``_extract_members``,
``_finalize_host``'s exemplar resolution and the ``EMSAR_SIG_TABLE``
signature table), the rank radix partition (``_pe_bucket_rank``,
``_radix_*``, ``_scatter_one``) and the delta-shift global pipeline
(``_pe_stream_gen``, ``_pe_stream_stats``, ``_pe_stream_chunk``), which is
the one-chunk case here.  torch has dynamic shapes and the H100 80 GB: one
global rank sort holds both halves of a human-scale transcriptome
(~675 M windows).  Its row-local singleton pass (``_pe_single_chunk``)
is kept, inside the candidate kernel: a singleton cluster's candidates
need no global sort.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import BuildConfig
from ..io.fasta import Transcriptome
from ..io.rsh import RshIndex
from ..kernels.pe_candidates import (BIG_RANK, MAX_CANDIDATES, MAX_NFL,
                                     pack_tables, pe_candidates)
from ..kernels.window_hash import MAX_WORDS, WORD_BASES, window_hash
from ..utils.timing import phase
from .device_build import (DeviceRef, _canonical, _group_signatures,
                           _key64, _lex_order, _run_starts, _sync, _take)

# The candidate budget (weight) of a chunk.  None: sized at the start of a
# build from the card's free memory (BYTES_PER_CANDIDATE each, half of
# it); a sharded build and a CPU build take FIXED_CHUNK_CANDIDATES.
CHUNK_CANDIDATES: Optional[int] = None
FIXED_CHUNK_CANDIDATES = 1 << 26
# a chunk's peak per candidate a multi-cluster member may write: the
# candidate buffers (12 B, sized from the chunk's weight) beside the
# sort's input indices, values, indices and buffers (~40 B); then, the
# sorted keys and payloads beside the run accumulation's temporaries
# (~75 B: with the singleton clusters resolved in the kernel, more of the
# written candidates belong to runs of several, whose records take int64
# temporaries).  A singleton member weighs one candidate: it costs its
# 12 B of the buffers and nothing after.
BYTES_PER_CANDIDATE = 88
SINGLETON_WEIGHT = 1
# pending chunk records merged into the running table past this many
MERGE_RECORDS = 1 << 24
MAX_TRANSCRIPTS = 1 << 23  # the tid rides in the payload above 9 bits of dd


def build_pe_index_device(tx: Transcriptome, readlength: int,
                          cfg: BuildConfig, device: torch.device,
                          shard: Optional[Tuple[int, int]] = None
                          ) -> RshIndex:
    """PE rsh index for one read length, built on ``device`` (see the
    module note).  ``shard=(i, n)``: this process builds every n-th chunk
    of mate1 clusters; ``RshIndex.merge`` sums the partials.  Raises on a
    configuration it cannot build; on CUDA an allocation the card cannot
    hold raises with the build's size."""
    rl = int(readlength)
    fl_min = max(cfg.min_fraglength, rl)
    fl_max = max(cfg.max_fraglength, fl_min)
    nfl = fl_max - fl_min + 1
    if nfl >= MAX_NFL:
        raise ValueError(f"PE build: {nfl} fragment lengths, the device "
                         f"build takes fewer than {MAX_NFL}")
    if rl > WORD_BASES * MAX_WORDS:
        raise ValueError(f"PE build: read length {rl} > "
                         f"{WORD_BASES * MAX_WORDS}")
    if tx.n_transcripts >= MAX_TRANSCRIPTS:
        raise ValueError(f"PE build: {tx.n_transcripts} transcripts, the "
                         f"device build takes fewer than {MAX_TRANSCRIPTS}")
    if tx.borderpos - rl + 1 <= 0:
        raise ValueError(f"PE build: read length {rl} exceeds the "
                         f"transcriptome")
    if tx.seqlength >= (1 << 31) - 1:
        raise ValueError(f"PE build: {tx.seqlength} positions exceed int32")
    if shard is not None and not 0 <= shard[0] < shard[1]:
        raise ValueError(f"PE build: invalid shard {shard}")
    try:
        return _build_pe(tx, rl, fl_min, fl_max, cfg, device, shard)
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(
            f"the PE device build of {tx.borderpos} bp (l{rl}, fragment "
            f"lengths {fl_min}-{fl_max}) does not fit the memory of "
            f"{device}: {e}") from e


def chunk_budget(device: torch.device, n_positions: int,
                 shard: Optional[Tuple[int, int]] = None) -> int:
    """A chunk's candidate budget: ``CHUNK_CANDIDATES`` when set; fixed for a
    sharded build (every process plans the same chunks) and on the CPU;
    else half the card's free memory, less ~24 B for each of the build's
    ``n_positions`` (R, RF, the packed t32 and nsep, and the rank-sorted
    members), over
    ``BYTES_PER_CANDIDATE``."""
    if CHUNK_CANDIDATES is not None:
        budget = CHUNK_CANDIDATES
    elif shard is not None or device.type != "cuda":
        budget = FIXED_CHUNK_CANDIDATES
    else:
        free, _ = torch.cuda.mem_get_info(device)
        budget = (free - 24 * n_positions) // (2 * BYTES_PER_CANDIDATE)
    return int(min(max(budget, 1), MAX_CANDIDATES))


def rank_pass(ref: DeviceRef, t32: torch.Tensor, rl: int, unstranded: bool,
              verbose: int) -> Tuple[torch.Tensor, ...]:
    """Ranks of the literal mate1 windows: (R, spos, srank).  R int32
    [seqlength - rl + 1] holds the rank of every valid window (BIG_RANK
    elsewhere, and in the rc half of a stranded build); spos and srank
    (int32) are the valid positions sorted by rank and their ranks."""
    dev = ref.codes.device
    n_rank = ref.seqlength - rl + 1
    with phase("PE dev: rank hash", verbose):
        # unstranded: the whole sequence as one literal "forward half"
        bp = ref.seqlength if unstranded else ref.borderpos
        h1, h2, h3, tid = window_hash(ref.codes, t32, bp, ref.seqlength, rl,
                                      False)
        keep = tid >= 0
        del tid
        pos = torch.nonzero(keep).squeeze(1).to(torch.int32)
        key = _key64(h1[keep], h2[keep])
        del h1, h2
        h3 = h3[keep]
        del keep
        _sync(dev)
    if pos.shape[0] >= BIG_RANK:
        raise ValueError(f"PE build: {pos.shape[0]} mate1 windows, ranks "
                         f"take fewer than {BIG_RANK}")
    with phase("PE dev: rank sort", verbose):
        order = _lex_order([key, h3])
        keys = [key[order], h3[order]]
        del key, h3
        spos = pos[order]
        del pos, order
        start = _run_starts(keys)
        del keys
        srank = torch.cumsum(start, 0, dtype=torch.int32) - 1
        del start
        R = torch.full((n_rank,), BIG_RANK, dtype=torch.int32, device=dev)
        R[spos] = srank
        _sync(dev)
    return R, spos, srank


def plan_chunks(srank: torch.Tensor, nfl: int, budget: int
                ) -> List[Tuple[int, int, int]]:
    """(lo, hi, weight) over the rank-sorted members: runs [lo, hi) of
    whole clusters weighing at most ``budget`` in all, a member of a
    multi-member cluster nfl (its candidates), a singleton member
    SINGLETON_WEIGHT.  A chunk's weight bounds the candidates it writes.
    Raises when one cluster alone weighs more than the budget."""
    n = srank.shape[0]
    if n == 0:
        return []
    first = torch.ones(n, dtype=torch.bool, device=srank.device)
    first[1:] = srank[1:] != srank[:-1]
    starts = torch.nonzero(first).squeeze(1)
    del first
    # members of each cluster, then its weight, then the running weight
    cw = torch.diff(starts, append=starts.new_tensor([n]))
    largest = int(cw.max())
    if largest > 1 and largest * nfl > budget:
        raise ValueError(
            f"PE build: a mate1 cluster of {largest} members has "
            f"{largest * nfl} candidates, more than the chunk budget of "
            f"{budget}")
    cw.mul_(nfl)
    cw.masked_fill_(cw == nfl, SINGLETON_WEIGHT)
    cw.cumsum_(0)
    n_clusters = starts.shape[0]
    bounds, c0, lo, done = [], 0, 0, 0
    while c0 < n_clusters:
        c1 = int(torch.searchsorted(cw, cw.new_tensor([done + budget]),
                                    right=True))
        hi = int(starts[c1]) if c1 < n_clusters else n
        total = int(cw[c1 - 1])
        bounds.append((lo, hi, total - done))
        c0, lo, done = c1, hi, total
    return bounds


def _sort_candidates(keys: torch.Tensor, pay: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A chunk's written candidates sorted by key: (sorted keys, their
    payloads)."""
    sk, order = torch.sort(keys)
    return sk, pay[order]


def _accumulate(sk: torch.Tensor, spay: torch.Tensor, nfl: int, ntid: int,
                max_repeat: int, single: torch.Tensor):
    """Runs of equal keys of one chunk: singles into ``single`` (int64
    [ntid * nfl], in place); returns the records (sorted tids, sizes, dd)
    of 1 < size < max_repeat at one dd."""
    n = sk.shape[0]
    empty = sk.new_zeros(0)
    if n == 0:
        return empty, empty, empty
    start = _run_starts([sk])
    starts = torch.nonzero(start).squeeze(1)
    lengths = torch.diff(starts, append=starts.new_tensor([n])).to(
        torch.int32)
    run = torch.cumsum(start, 0, dtype=torch.int32) - 1
    del start
    dd = spay & 0x1FF
    tid = (spay >> 9) & (MAX_TRANSCRIPTS - 1)
    first_dd = dd[starts]
    del starts
    mixed = torch.zeros(lengths.shape[0], dtype=torch.bool,
                        device=sk.device)
    mixed[run[dd != first_dd[run]]] = True
    len_row = lengths[run]
    one = len_row == 1
    single += torch.bincount(tid[one].to(torch.int64) * nfl + dd[one],
                             minlength=ntid * nfl)
    del one
    keep_run = (lengths > 1) & (lengths < max_repeat) & ~mixed
    rows = keep_run[run]
    del len_row, mixed, keep_run
    mrun = run[rows].to(torch.int64)
    mtid = tid[rows].to(torch.int64)
    del run, rows, tid, dd
    order = torch.sort(mrun * ntid + mtid).indices
    flat = mtid[order]
    kept, sizes = torch.unique_consecutive(mrun[order], return_counts=True)
    return flat, sizes, first_dd[kept].to(torch.int64)


def _merge_cells(tables, nfl: int):
    """One table of distinct signatures from several: (flat, sizes, sig,
    dd, count) with one cell per (signature, dd)."""
    flat = torch.cat([t[0] for t in tables])
    sizes = torch.cat([t[1] for t in tables])
    base, sig = 0, []
    for t in tables:
        sig.append(t[2] + base)
        base += t[1].shape[0]
    sig = torch.cat(sig)
    dd = torch.cat([t[3] for t in tables])
    cnt = torch.cat([t[4] for t in tables])
    group, rep = _group_signatures(flat, sizes)
    flat, sizes = _take(flat, sizes, rep)
    cell, inv = torch.unique(group[sig] * nfl + dd, return_inverse=True)
    total = torch.zeros(cell.shape[0], dtype=torch.int64, device=flat.device)
    total.index_add_(0, inv, cnt)
    return flat, sizes, cell // nfl, cell % nfl, total


def _build_pe(tx, rl, fl_min, fl_max, cfg, device, shard) -> RshIndex:
    ntid = tx.n_transcripts
    nfl = fl_max - fl_min + 1
    d0 = fl_min - rl
    unstranded = not cfg.strand.stranded
    budget = chunk_budget(device, int(tx.seqlength) + 1, shard)
    with phase("PE dev: reference upload", cfg.verbose):
        ref = DeviceRef(tx, device)
        t32 = ref.t32(rl)
        _sync(device)
    R, spos, srank = rank_pass(ref, t32, rl, unstranded, cfg.verbose)
    with phase("PE dev: tables", cfg.verbose):
        # each position's tid and next separator in one entry, in place of
        # the two tables
        tn = pack_tables(t32, ref.nsep())
        del ref, t32
        RF = R.flip(0) if unstranded else None
        _sync(device)
    bounds = plan_chunks(srank, nfl, budget)
    mine = (range(len(bounds)) if shard is None
            else range(shard[0], len(bounds), shard[1]))
    single = torch.zeros(ntid * nfl, dtype=torch.int64, device=device)
    table, pending, n_pending = None, [], 0
    for k in mine:
        lo, hi, weight = bounds[k]
        with phase("PE dev: candidates", cfg.verbose):
            keys, pay = pe_candidates(
                spos, srank, lo, hi, R, RF, tn, d0, nfl, rl, tx.borderpos,
                tx.seqlength, unstranded, single, capacity=weight)
            _sync(device)
        with phase("PE dev: sort", cfg.verbose):
            sk, spay = _sort_candidates(keys, pay)
            del keys, pay
            _sync(device)
        with phase("PE dev: accumulate", cfg.verbose):
            flat, sizes, dd = _accumulate(sk, spay, nfl, ntid,
                                          int(cfg.max_repeat), single)
            del sk, spay
            if sizes.shape[0]:
                pending.append((flat, sizes, torch.arange(
                    sizes.shape[0], device=device), dd,
                    torch.ones_like(dd)))
                n_pending += int(sizes.shape[0])
            if n_pending > MERGE_RECORDS:
                table = _merge_cells(
                    pending + ([table] if table is not None else []), nfl)
                pending, n_pending = [], 0
            _sync(device)
    del R, RF, tn, spos, srank
    with phase("PE dev: finalize", cfg.verbose):
        if pending:
            table = _merge_cells(
                pending + ([table] if table is not None else []), nfl)
        if table is not None:
            flat, sizes, sig, dd, cnt = (t.cpu().numpy() for t in table)
            counts = np.zeros((sizes.shape[0], nfl), dtype=np.int64)
            counts[sig, dd] = cnt
        else:
            flat, sizes = np.empty(0, np.int64), np.empty(0, np.int64)
            counts = np.zeros((0, nfl), np.int64)
        sig_offsets, sig_tids, multi_euma = _canonical(flat, sizes, counts)
        index = RshIndex(names=list(tx.names), readlength=rl,
                         min_fraglength=fl_min, max_fraglength=fl_max,
                         single_euma=single.reshape(ntid, nfl).cpu().numpy(),
                         sig_offsets=sig_offsets, sig_tids=sig_tids,
                         multi_euma=multi_euma)
    return index
