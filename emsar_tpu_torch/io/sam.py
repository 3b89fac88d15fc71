"""SAM text alignment reader.

Produces the same (read_id, alignment) stream as the BAM reader
(reference semantics: read_BAM_SE/PE + convert_bam_alignment_2_alignment*,
src/emsar_functions.c:323-548; mm from the MD aux tag via
parse_SAM_mmstr :418-424 — every non-digit character counts).
"""

from __future__ import annotations

from typing import Dict, IO, Iterator, List, Optional, Tuple

from ..ingest.collapse import Alignment


def _mm_from_md(md: Optional[str]) -> int:
    if not md:
        return 0
    return sum(0 if c.isdigit() else 1 for c in md)


class SamRecord:
    __slots__ = ("qname", "flag", "rname", "pos", "l_seq", "md")

    def __init__(self, qname, flag, rname, pos, l_seq, md):
        self.qname = qname
        self.flag = flag
        self.rname = rname
        self.pos = pos
        self.l_seq = l_seq
        self.md = md

    @property
    def mapped(self) -> bool:
        return self.rname != "*" and not (self.flag & 0x4)


def read_sam_records(path_or_stream) -> Iterator[SamRecord]:
    fh = path_or_stream if hasattr(path_or_stream, "read") else \
        open(path_or_stream, "r", buffering=1 << 20)
    try:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            md = None
            for tag in f[11:]:
                if tag.startswith("MD:Z:"):
                    md = tag[5:]
                    break
            yield SamRecord(f[0], int(f[1]), f[2], int(f[3]) - 1,
                            len(f[9]) if f[9] != "*" else 0, md)
    finally:
        if fh is not path_or_stream:
            fh.close()


def _se_alignment(rec: SamRecord, name_to_tid: Dict[str, int],
                  strand_code: int) -> Optional[Alignment]:
    tid = name_to_tid.get(rec.rname)
    if tid is None:
        raise ValueError(f"unexisting transcript {rec.rname!r} in alignment file")
    strand = ord("-") if rec.flag & 0x10 else ord("+")
    if strand_code != 0 and strand_code != strand:
        return None
    return (tid, _mm_from_md(rec.md), rec.l_seq, rec.pos)


def _pe_alignment(r1: SamRecord, r2: SamRecord, name_to_tid: Dict[str, int],
                  strand_code: int, readlength_holder: List[int]
                  ) -> Optional[Alignment]:
    """Reference convert_bam_alignment_2_alignment_PE (:426-469)."""
    tid = name_to_tid.get(r1.rname)
    if tid is None:
        raise ValueError(f"unexisting transcript {r1.rname!r} in alignment file")
    rl = readlength_holder[0]
    if rl == -1:
        rl = r1.l_seq
        readlength_holder[0] = rl
    if rl != r1.l_seq or rl != r2.l_seq:
        raise ValueError("paired-end data with variable read length is not "
                         "supported")
    if (r1.flag & 0x40) and (r2.flag & 0x80):
        b1, b2 = r1, r2
    elif (r2.flag & 0x40) and (r1.flag & 0x80):
        b1, b2 = r2, r1
    else:
        raise ValueError("mates are not grouped in the BAM/SAM file")
    mm = _mm_from_md(b1.md) + _mm_from_md(b2.md)
    s1 = "-" if b1.flag & 0x10 else "+"
    s2 = "-" if b2.flag & 0x10 else "+"
    if b2.pos > b1.pos:  # mate1(f)...mate2(r)
        fraglen = b2.pos - b1.pos + rl
        pos = b1.pos
        if strand_code == ord("-") or not (s1 == "+" and s2 == "-"):
            return None
    else:
        fraglen = b1.pos - b2.pos + rl
        pos = b2.pos
        if strand_code == ord("+") or not (s1 == "-" and s2 == "+"):
            return None
    return (tid, mm, fraglen, pos)


def stream_alignments_se(records: Iterator[SamRecord],
                         name_to_tid: Dict[str, int], strand_code: int
                         ) -> Iterator[Tuple[str, Optional[Alignment]]]:
    for rec in records:
        if not rec.mapped:
            continue
        yield rec.qname, _se_alignment(rec, name_to_tid, strand_code)


def stream_alignments_pe(records: Iterator[SamRecord],
                         name_to_tid: Dict[str, int], strand_code: int,
                         readlength_holder: Optional[List[int]] = None
                         ) -> Iterator[Tuple[str, Optional[Alignment]]]:
    """Mates must be adjacent, first-mapped record starts a pair (the
    reference reads the second record unconditionally :517; we skip the
    pair if the second is unmapped instead of reading garbage)."""
    holder = readlength_holder if readlength_holder is not None else [-1]
    it = iter(records)
    for r1 in it:
        if not r1.mapped:
            continue
        r2 = next(it, None)
        if r2 is None:
            break
        if not r2.mapped:
            continue
        yield r1.qname, _pe_alignment(r1, r2, name_to_tid, strand_code, holder)


def probe_readlength_sam_bam(records: Iterator[SamRecord]) -> int:
    for rec in records:
        if rec.mapped:
            return rec.l_seq
    raise ValueError("no mapped records in alignment file")


def probe_readlength_range_sam_bam(records: Iterator[SamRecord]
                                   ) -> Tuple[int, int]:
    lo, hi = 30000, 0
    for rec in records:
        if rec.mapped:
            lo = min(lo, rec.l_seq)
            hi = max(hi, rec.l_seq)
    if hi == 0:
        raise ValueError("no mapped records in alignment file")
    return lo, hi
