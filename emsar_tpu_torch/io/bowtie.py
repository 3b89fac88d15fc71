"""Bowtie1 default-output parser (SE and PE).

Reference semantics: parse_bowtieline / parse_bowtieline_PE / read_bowtie_*
(src/emsar_functions.c:552-836) and parse_mmstr (src/alignment.c:101-108).

Bowtie default columns: read_id, strand, tname, 0-based pos, sequence,
quality, reserved, mismatch-descriptor.  At least 7 tab-separated fields
are required; the mismatch field may be absent or empty.
"""

from __future__ import annotations

from typing import Dict, IO, Iterator, List, Optional, Tuple

from ..ingest.collapse import Alignment


def _mm_from_mmstr(mmstr: str) -> int:
    """Number of mismatches: (non-empty) + count of ','
    (reference parse_mmstr, src/alignment.c:101-108)."""
    if not mmstr:
        return 0
    return 1 + mmstr.count(",")


def _parse_line(line: str) -> Tuple[str, str, str, int, int, str]:
    fields = line.split("\t")
    if len(fields) < 7:
        raise ValueError(
            "input alignment file doesn't look like bowtieout file")
    read_id = fields[0]
    strand = fields[1][:1]
    tname = fields[2]
    pos = int(fields[3])
    readlen = len(fields[4])
    mmstr = fields[7] if len(fields) > 7 else ""
    return read_id, strand, tname, pos, readlen, mmstr


def probe_readlength(path_or_stream) -> int:
    """Read length from the first line (reference
    read_bowtie_get_readlength)."""
    close, fh = _open(path_or_stream)
    try:
        for line in fh:
            return _parse_line(line.rstrip("\n"))[4]
    finally:
        if close:
            fh.close()
    raise ValueError("empty bowtie file")


def probe_readlength_range(path: str) -> Tuple[int, int]:
    """(min, max) read length over the whole file (reference
    read_bowtie_get_readlengths_se; incompatible with stdin streaming)."""
    lo, hi = 30000, 0
    with open(path) as fh:
        for line in fh:
            rl = _parse_line(line.rstrip("\n"))[4]
        # match the reference: scan every line
            lo = min(lo, rl)
            hi = max(hi, rl)
    if hi == 0:
        raise ValueError("empty bowtie file")
    return lo, hi


def _open(path_or_stream) -> Tuple[bool, IO[str]]:
    if hasattr(path_or_stream, "read"):
        return False, path_or_stream
    return True, open(path_or_stream, "r", buffering=1 << 20)


def _mate_id_match(id1: str, id2: str) -> int:
    """Return the matching-prefix length, 0 if the ids don't pair
    (reference check_mate_readid_matching, src/alignment.c:113-126)."""
    if len(id1) != len(id2):
        return 0
    n = len(id1)
    if (n >= 2 and id1[n - 2] == "/" and id2[n - 2] == "/" and
            ((id1[n - 1] == "1" and id2[n - 1] == "2") or
             (id1[n - 1] == "2" and id2[n - 1] == "1" and
              id1[:n - 2] == id2[:n - 2]))):
        return n - 2
    for i in range(n):
        if id1[i] == " " and id2[i] == " ":
            return i  # Casava: equal up to the first blank
        if id1[i] != id2[i]:
            return 0
    return n


def read_bowtie_se(path_or_stream, name_to_tid: Dict[str, int],
                   strand_code: int) -> Iterator[Tuple[str, Optional[Alignment]]]:
    """Yield (read_id, alignment-or-None) for each SE bowtie line."""
    close, fh = _open(path_or_stream)
    try:
        for line in fh:
            read_id, strand, tname, pos, readlen, mmstr = \
                _parse_line(line.rstrip("\n"))
            if strand_code != 0 and ord(strand) != strand_code:
                yield read_id, None
                continue
            tid = name_to_tid.get(tname)
            if tid is None:
                raise ValueError(
                    f"unexisting transcript {tname!r} in the bowtie output file")
            yield read_id, (tid, _mm_from_mmstr(mmstr), readlen, pos)
    finally:
        if close:
            fh.close()


def read_bowtie_pe(path_or_stream, name_to_tid: Dict[str, int],
                   strand_code: int,
                   readlength_holder: Optional[List[int]] = None
                   ) -> Iterator[Tuple[str, Optional[Alignment]]]:
    """Yield (read_id, alignment-or-None) per PE line pair.

    Faithful to the reference including its mate-order handling: the
    reference swaps mate roles unless the read id's last char is the byte
    0x01 (parse_bowtieline_PE, src/emsar_functions.c:652), so line 2 is
    effectively treated as mate 1.  This is symmetric for unstranded data
    and reproduced exactly for stranded golden parity.
    """
    close, fh = _open(path_or_stream)
    readlength = readlength_holder[0] if readlength_holder else -1
    try:
        it = iter(fh)
        for line1 in it:
            try:
                line2 = next(it)
            except StopIteration:
                break
            id1, strand1, tname1, pos1, rlen1, mm1 = \
                _parse_line(line1.rstrip("\n"))
            id2, strand2, tname2, pos2, rlen2, mm2 = \
                _parse_line(line2.rstrip("\n"))

            matched = _mate_id_match(id1, id2)
            if matched == 0:
                raise ValueError("mate read IDs don't match; check bowtie "
                                 "out format")
            order_reversed = id1[-1] != "\x01"  # reference quirk :652
            read_id = id1[:matched]
            if order_reversed:
                pos1, pos2 = pos2, pos1
                strand1, strand2 = strand2, strand1
                mm1, mm2 = mm2, mm1

            if tname1 != tname2:
                yield read_id, None
                continue
            if readlength == -1:
                readlength = rlen1
                if readlength_holder is not None:
                    readlength_holder[0] = readlength
            if readlength != rlen1 or readlength != rlen2:
                raise ValueError("paired-end data with variable read length "
                                 "is not supported")
            tid = name_to_tid.get(tname1)
            if tid is None:
                raise ValueError(
                    f"unexisting transcript {tname1!r} in the bowtie output file")
            mm = _mm_from_mmstr(mm1) + _mm_from_mmstr(mm2)

            if pos2 > pos1:  # mate1(f) ... mate2(r)
                fraglen = pos2 - pos1 + readlength
                pos = pos1
                ok = (strand_code != ord("-")) and strand1 == "+" and strand2 == "-"
            else:  # mate2(f) ... mate1(r)
                fraglen = pos1 - pos2 + readlength
                pos = pos2
                ok = (strand_code != ord("+")) and strand1 == "-" and strand2 == "+"
            yield read_id, ((tid, mm, fraglen, pos) if ok else None)
    finally:
        if close:
            fh.close()
