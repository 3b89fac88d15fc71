"""BAM reader: BGZF block-gzip + binary BAM records.

A from-scratch minimal reader of the subset the quantifier needs (qname,
flag, refID, pos, l_seq, MD aux tag), replacing the reference's vendored
samtools-0.1.x (bgzf.c / bam.c / bam_import.c / bam_aux.c).  Pure Python
over zlib with batched block decompression; a C++ fast path can be swapped
in behind the same record iterator.

Also includes a minimal BAM writer (used by tests and the read simulator
to fabricate qname-grouped fixtures).
"""

from __future__ import annotations

import struct
import zlib
from typing import IO, Iterator, List, Optional, Tuple

from .sam import SamRecord

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def bgzf_blocks(fh: IO[bytes]) -> Iterator[bytes]:
    """Yield decompressed BGZF blocks."""
    while True:
        header = fh.read(12)
        if len(header) == 0:
            return
        if len(header) < 12:
            raise ValueError("truncated BGZF header")
        magic1, magic2, method, flags, _mtime, _xfl, _os, xlen = \
            struct.unpack("<BBBBIBBH", header)
        if magic1 != 0x1F or magic2 != 0x8B:
            raise ValueError("not a BGZF/gzip file")
        extra = fh.read(xlen)
        bsize = None
        off = 0
        while off + 4 <= len(extra):
            si1, si2, slen = struct.unpack_from("<BBH", extra, off)
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, off + 4)[0]
            off += 4 + slen
        if bsize is None:
            raise ValueError("missing BGZF BC subfield")
        cdata_len = bsize - xlen - 19
        cdata = fh.read(cdata_len)
        fh.read(8)  # crc32 + isize
        data = zlib.decompress(cdata, wbits=-15)
        if data:
            yield data


def read_bam_records(path_or_stream) -> Iterator[SamRecord]:
    """Iterate BAM alignment records as SamRecord objects (0-based pos)."""
    fh = path_or_stream if hasattr(path_or_stream, "read") else \
        open(path_or_stream, "rb", buffering=1 << 20)
    own = fh is not path_or_stream
    try:
        stream = _ByteStream(bgzf_blocks(fh))
        magic = stream.read(4)
        if magic != b"BAM\x01":
            raise ValueError("not a BAM file (bad magic)")
        l_text = struct.unpack("<i", stream.read(4))[0]
        stream.read(l_text)
        n_ref = struct.unpack("<i", stream.read(4))[0]
        ref_names: List[str] = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", stream.read(4))[0]
            name = stream.read(l_name)[:-1].decode("latin-1")
            stream.read(4)  # l_ref
            ref_names.append(name)

        while True:
            szb = stream.read(4)
            if len(szb) == 0:
                return
            if len(szb) < 4:
                raise ValueError("truncated BAM record")
            block_size = struct.unpack("<i", szb)[0]
            rec = stream.read(block_size)
            if len(rec) < block_size:
                raise ValueError("truncated BAM record body")
            (ref_id, pos, l_read_name, _mapq, _bin, n_cigar, flag,
             l_seq, _next_ref, _next_pos, _tlen) = struct.unpack_from(
                "<iiBBHHHiiii", rec, 0)
            qname = rec[32:32 + l_read_name - 1].decode("latin-1")
            aux_off = 32 + l_read_name + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
            md = _find_md(rec, aux_off, block_size)
            yield SamRecord(qname, flag,
                            ref_names[ref_id] if ref_id >= 0 else "*",
                            pos, l_seq, md)
    finally:
        if own:
            fh.close()


class _ByteStream:
    """Concatenate an iterator of byte blocks into a read(n) interface."""

    def __init__(self, blocks: Iterator[bytes]):
        self._blocks = blocks
        self._buf = bytearray()
        self._pos = 0

    def read(self, n: int) -> bytes:
        while len(self._buf) - self._pos < n:
            try:
                self._buf += next(self._blocks)
            except StopIteration:
                break
            if self._pos > (1 << 20):
                del self._buf[:self._pos]
                self._pos = 0
        out = bytes(self._buf[self._pos:self._pos + n])
        self._pos += len(out)
        return out


_AUX_SIZES = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
              ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4}


def _find_md(rec: bytes, off: int, end: int) -> Optional[str]:
    while off + 3 <= end:
        tag = rec[off:off + 2]
        vtype = rec[off + 2]
        off += 3
        if vtype in (ord("Z"), ord("H")):
            zend = rec.index(b"\x00", off)
            if tag == b"MD":
                return rec[off:zend].decode("latin-1")
            off = zend + 1
        elif vtype == ord("B"):
            sub = rec[off]
            count = struct.unpack_from("<i", rec, off + 1)[0]
            off += 5 + _AUX_SIZES[sub] * count
        else:
            off += _AUX_SIZES[vtype]
    return None


# --------------------------------------------------------------------------
# Minimal writer (test fixtures / simulator output)
# --------------------------------------------------------------------------

def _bgzf_compress(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 25 + 1
    header = struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF,
                         6, 66, 67, 2, bsize - 1)
    footer = struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)
    return header + cdata + footer


_SEQ_CODE = {ord("A"): 1, ord("C"): 2, ord("G"): 4, ord("T"): 8,
             ord("N"): 15}


def write_bam(path: str, ref_names: List[str], ref_lengths: List[int],
              records: Iterator[Tuple[str, int, int, int, bytes, Optional[str]]]
              ) -> None:
    """records: (qname, flag, ref_id, pos0, seq, md)."""
    body = bytearray()
    text = "".join(f"@SQ\tSN:{n}\tLN:{l}\n"
                   for n, l in zip(ref_names, ref_lengths)).encode()
    body += b"BAM\x01" + struct.pack("<i", len(text)) + text
    body += struct.pack("<i", len(ref_names))
    for n, l in zip(ref_names, ref_lengths):
        nb = n.encode() + b"\x00"
        body += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)

    for qname, flag, ref_id, pos, seq, md in records:
        qn = qname.encode() + b"\x00"
        l_seq = len(seq)
        packed = bytearray((l_seq + 1) // 2)
        for i, ch in enumerate(seq):
            code = _SEQ_CODE.get(ch, 15)
            if i % 2 == 0:
                packed[i // 2] = code << 4
            else:
                packed[i // 2] |= code
        cigar = struct.pack("<I", (l_seq << 4) | 0)  # <l_seq>M
        aux = b""
        if md is not None:
            aux = b"MDZ" + md.encode() + b"\x00"
        rec = (struct.pack("<iiBBHHHiiii", ref_id, pos, len(qn), 0, 0, 1,
                           flag, l_seq, -1, -1, 0)
               + qn + cigar + bytes(packed) + b"\xff" * l_seq + aux)
        body += struct.pack("<i", len(rec)) + rec

    with open(path, "wb") as fh:
        chunk = 60000
        for i in range(0, len(body), chunk):
            fh.write(_bgzf_compress(bytes(body[i:i + chunk])))
        fh.write(_BGZF_EOF)
