"""Collapse per-read alignment groups into mapping-signature counts.

Semantics follow the reference exactly (add_alignment_to_list,
src/alignment.c:29-59; update_ReadCounts, src/emsar_functions.c:838-943):

* within a read, identical (tid, pos, fraglen) alignments are deduplicated;
* only minimum-mismatch alignments are kept (a better mm flushes the list);
* reads with more than ``max_repeat`` surviving alignments are discarded;
* PE reads whose alignments disagree on fragment length are discarded;
* the surviving multiset of tids (duplicates kept — internal repeats) is
  the read's signature; the read is counted only if the signature exists
  in the rsh index, but it always enters TotalReadCount and the
  fragment-length histogram when within the length filter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..io.rsh import RshIndex

# One alignment: (tid, mm, fraglen, pos)
Alignment = Tuple[int, int, int, int]


@dataclasses.dataclass
class SampleCounts:
    """Per-sample signature counts + fragment-length histogram."""

    single_counts: np.ndarray  # int64 [ntid]
    multi_counts: np.ndarray  # int64 [n_multi]
    fraglength_counts: np.ndarray  # int64 [max_fraglength + 1]
    total_read_count: int

    def readcount_per_cid(self) -> np.ndarray:
        """ReadCount in cid order (singles then multis)."""
        return np.concatenate([self.single_counts, self.multi_counts])


class PosBias:
    """Positional fragment-frequency accumulator (reference C22 surface:
    update_ReadCounts -m 1 blocks, src/emsar_functions.c:852-934 +
    normalize_perpos_freq :2544-2556).  Requires transcript lengths, so it
    is only available on the -x (fasta) path, like the reference."""

    def __init__(self, transcript_lengths: np.ndarray, freq_len: int):
        self.tlen = transcript_lengths
        self.freq_len = freq_len
        self.freq_5 = np.zeros(freq_len)
        self.freq_3 = np.zeros(freq_len)
        self.unavail_5 = np.zeros(freq_len)
        self.unavail_3 = np.zeros(freq_len)

    def add(self, tid: int, pos: int, fraglen: int, weight: float) -> None:
        tlen = int(self.tlen[tid])
        if pos < self.freq_len:
            self.freq_5[pos] += weight
        d3 = tlen - (pos + fraglen - 1)
        if d3 < self.freq_len:
            self.freq_3[max(d3, -self.freq_len)] += weight
        if tlen < self.freq_len:
            self.unavail_5[tlen:] += weight
            self.unavail_3[tlen:] += weight

    def normalized(self):
        s5 = self.freq_5.sum()
        s3 = self.freq_3.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            n5 = self.freq_5 / (s5 - self.unavail_5)
            n3 = self.freq_3 / (s3 - self.unavail_3)
        return n5, n3


class ReadCollapser:
    """Streaming collapser: feed alignment groups, get SampleCounts."""

    def __init__(self, index: RshIndex, min_fraglength: int,
                 max_fraglength: int, max_repeat: int, pe: bool,
                 posbias: Optional[PosBias] = None):
        self.index = index
        self.min_fraglength = min_fraglength
        self.max_fraglength = max_fraglength
        self.max_repeat = max_repeat
        self.pe = pe
        self.posbias = posbias
        self._has_single = index.has_single
        self._lookup = index.sig_lookup()
        self.single_counts = np.zeros(index.n_transcripts, dtype=np.int64)
        self.multi_counts = np.zeros(index.n_multi, dtype=np.int64)
        # sized to cover the effective fraglen range even when it exceeds
        # max_fraglength (the reference reads out of bounds there)
        hist_size = max(max_fraglength, index.fraglen_max) + 1
        self.fraglength_counts = np.zeros(hist_size, dtype=np.int64)
        self.total_read_count = 0

    # -- group-level API ------------------------------------------------------

    def add_group(self, alignments: List[Alignment]) -> None:
        """Process one read's alignments (already min-mm filtered + deduped)."""
        n = len(alignments)
        if n == 0 or n > self.max_repeat:
            return
        if self.pe and n > 1:
            fl0 = alignments[0][2]
            for a in alignments[1:]:
                if a[2] != fl0:
                    return  # fraglen discrepancy (check_fraglen_discrepancy)
        fraglength = alignments[0][2]
        if not (self.min_fraglength <= fraglength <= self.max_fraglength):
            return
        if n == 1:
            tid = alignments[0][0]
            if self.posbias is not None:
                self.posbias.add(tid, alignments[0][3], alignments[0][2], 1.0)
            if self._has_single[tid]:
                self.single_counts[tid] += 1
        else:
            if self.posbias is not None:
                for a in alignments:
                    self.posbias.add(a[0], a[3], a[2], 1.0 / n)
            tids = np.sort(np.fromiter((a[0] for a in alignments),
                                       dtype=np.int32, count=n))
            row = self._lookup.get(tids.tobytes())
            if row is not None:
                self.multi_counts[row] += 1
        self.fraglength_counts[fraglength] += 1
        self.total_read_count += 1

    def consume(self, groups: Iterable[List[Alignment]]) -> None:
        for g in groups:
            self.add_group(g)

    def finish(self) -> SampleCounts:
        return SampleCounts(single_counts=self.single_counts,
                            multi_counts=self.multi_counts,
                            fraglength_counts=self.fraglength_counts,
                            total_read_count=self.total_read_count)


def group_alignments(records: Iterable[Tuple[str, Optional[Alignment]]]
                     ) -> Iterator[List[Alignment]]:
    """Group a (read_id, alignment) stream by adjacent read id, applying the
    reference's per-read filtering: exact-duplicate removal and
    minimum-mismatch selection.  ``alignment`` may be None (filtered at
    parse time); such records are skipped without breaking the group.
    """
    cur_id: Optional[str] = None
    cur: List[Alignment] = []
    cur_min_mm = 10000

    for read_id, aln in records:
        if aln is None:
            continue
        if read_id != cur_id:
            if cur_id is not None and cur:
                yield cur
            cur_id = read_id
            cur = []
            cur_min_mm = 10000
        # duplicate (tid, pos, fraglen) -> drop (reference alignment.c:37-41)
        dup = False
        for a in cur:
            if a[0] == aln[0] and a[3] == aln[3] and a[2] == aln[2]:
                dup = True
                break
        if dup:
            continue
        mm = aln[1]
        if mm > cur_min_mm:
            continue
        if mm < cur_min_mm:
            cur = []
            cur_min_mm = mm
        cur.append(aln)

    if cur_id is not None and cur:
        yield cur
