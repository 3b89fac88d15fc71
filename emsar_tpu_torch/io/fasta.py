"""Transcriptome reference model.

Parses a transcriptome FASTA into the concatenated representation used by the
whole framework: ``f0@f1@..@fn$rc(fn)@..@rc(f0)$`` — every transcript joined
with ``@`` separators, a ``$`` border, then the reverse complement of the
entire forward half, then a final ``$``.  (Reference semantics:
src/emsar_functions.c:31-188 ``read_raw_fasta``.)

Everything is stored as NumPy arrays so the index builder can move packed
2-bit windows straight to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

# ASCII translation: acgtACGT -> ACGT, '@' and '$' kept, everything else -> 'N'
# (reference: uc(), src/emsar_functions.c:2750-2773)
_UC = np.full(256, ord("N"), dtype=np.uint8)
for lo, hi in zip(b"acgt", b"ACGT"):
    _UC[lo] = hi
    _UC[hi] = hi
for ch in b"@$":
    _UC[ch] = ch

# base codes: A=0 C=1 G=2 T=3, non-ACGT (N/@/$) = 4.  The 2-bit code order
# matches lexicographic ACGT order so packed-word comparisons equal string
# comparisons.
_CODE = np.full(256, 4, dtype=np.uint8)
for i, ch in enumerate(b"ACGT"):
    _CODE[ch] = i

# complement on codes: A<->T, C<->G; non-canonical stays non-canonical
_COMP_CODE = np.array([3, 2, 1, 0, 4], dtype=np.uint8)

_COMP_ASCII = np.full(256, ord("N"), dtype=np.uint8)
for a, b in zip(b"ACGT", b"TGCA"):
    _COMP_ASCII[a] = b
for ch in b"@$":
    _COMP_ASCII[ch] = ch


def parse_header(line: str, header_fmt: str) -> str:
    """Extract the transcript name from a FASTA header (without '>').

    'E' (Ensembl): name is everything up to the first space/tab.
    'R' (RefSeq): name is the field between the 3rd and 4th '|'.
    (Reference: parse_ensembl_header / parse_refseq_header,
    src/emsar_functions.c:2705-2725.)
    """
    if header_fmt == "R":
        out = []
        npipe = 0
        for ch in line:
            if ch == "|":
                npipe += 1
                if npipe == 4:
                    break
            elif npipe == 3:
                out.append(ch)
        return "".join(out)
    # Ensembl
    for i, ch in enumerate(line):
        if ch in (" ", "\t"):
            return line[:i]
    return line


@dataclasses.dataclass
class Transcriptome:
    """Concatenated transcriptome with fw+rc halves.

    Attributes
    ----------
    names : transcript names, index = tid.
    seq : uint8 ASCII array of length ``seqlength + 1``; layout
        ``f0@f1@..$..rc(f0)$``.
    codes : uint8 array, same length; 0-3 for ACGT, 4 otherwise.
    cuml : int64 array of length ``n_transcripts + 1``; ``cuml[t]`` is the
        first position of transcript ``t``; ``cuml[n] = borderpos + 1``
        (reference convention, src/emsar_functions.c:159-170).
    borderpos : position of the central '$' (== length of the fw half).
    seqlength : position of the final '$'.
    """

    names: List[str]
    seq: np.ndarray
    codes: np.ndarray
    cuml: np.ndarray
    borderpos: int
    seqlength: int

    _name_to_tid: Dict[str, int] = dataclasses.field(default=None, repr=False)

    @property
    def n_transcripts(self) -> int:
        return len(self.names)

    @property
    def max_tid(self) -> int:
        return len(self.names) - 1

    @property
    def name_to_tid(self) -> Dict[str, int]:
        if self._name_to_tid is None:
            self._name_to_tid = {n: i for i, n in enumerate(self.names)}
        return self._name_to_tid

    def transcript_length(self, tid: int) -> int:
        return int(self.cuml[tid + 1] - self.cuml[tid] - 1)

    def transcript_lengths(self) -> np.ndarray:
        return np.diff(self.cuml) - 1

    def flip_positions(self, k, readlength: int):
        """Map window-start positions to their reverse-complement windows.

        (Reference: flip(), src/emsar_functions.c:2604-2606.)"""
        return self.seqlength - np.asarray(k) - readlength

    def transcript_of(self, k, readlength: int) -> np.ndarray:
        """Transcript index for window-start positions ``k`` on the
        concatenated sequence; rc-half windows are flipped first.

        (Reference: sf_i(), src/emsar_functions.c:2619-2627.)"""
        k = np.asarray(k, dtype=np.int64)
        flipped = np.where(k + readlength > self.borderpos,
                           self.seqlength - k - readlength, k)
        return (np.searchsorted(self.cuml, flipped, side="right") - 1).astype(np.int32)

    def position_in_transcript(self, k, tid, readlength: int) -> np.ndarray:
        """Transcript-relative position (reference: sf_p,
        src/emsar_functions.c:2635-2638)."""
        k = np.asarray(k, dtype=np.int64)
        flipped = np.where(k + readlength > self.borderpos,
                           self.seqlength - k - readlength, k)
        return flipped - self.cuml[np.asarray(tid)]


def read_fasta(path: str, header_fmt: str = "E") -> Transcriptome:
    """Read a transcriptome FASTA into a :class:`Transcriptome`.

    Sequence characters are uppercased, non-ACGT characters become 'N',
    whitespace inside sequence lines is dropped (reference:
    read_raw_fasta, src/emsar_functions.c:104-138).
    """
    names: List[str] = []
    chunks: List[bytes] = []  # per-transcript sequences (ASCII, cleaned)
    cur: List[bytes] = []

    with open(path, "rb") as fh:
        first = True
        for raw in fh:
            line = raw.rstrip(b"\r\n")
            if first:
                if not line.startswith(b">"):
                    raise ValueError("wrong fasta file format: first line must start with '>'")
                first = False
            if line.startswith(b">"):
                if names:
                    chunks.append(b"".join(cur))
                    cur = []
                names.append(parse_header(line[1:].decode("latin-1"), header_fmt))
            else:
                cur.append(line.replace(b" ", b"").replace(b"\t", b""))
        if not names:
            raise ValueError("empty fasta file")
        chunks.append(b"".join(cur))

    return build_transcriptome(names, chunks)


def build_transcriptome(names: List[str], seqs: List[bytes]) -> Transcriptome:
    """Assemble the concatenated fw+rc representation from raw sequences."""
    n = len(names)
    assert n == len(seqs)
    fw = _UC[np.frombuffer(b"@".join(seqs), dtype=np.uint8)]
    borderpos = fw.shape[0]
    rc = _COMP_ASCII[fw[::-1]]
    seq = np.concatenate([
        fw,
        np.frombuffer(b"$", dtype=np.uint8),
        rc,
        np.frombuffer(b"$", dtype=np.uint8),
    ])
    seqlength = seq.shape[0] - 1  # position of final '$'

    lengths = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=n)
    cuml = np.empty(n + 1, dtype=np.int64)
    cuml[0] = 0
    np.cumsum(lengths + 1, out=cuml[1:])  # +1 for the '@' separator / border
    # cuml[n] == borderpos + 1, matching the reference convention
    assert cuml[n] == borderpos + 1

    codes = _CODE[seq]
    return Transcriptome(names=names, seq=seq, codes=codes, cuml=cuml,
                         borderpos=borderpos, seqlength=seqlength)


def revcomp_bytes(s: bytes) -> bytes:
    """Reverse complement of an ASCII sequence (non-ACGT -> 'N')."""
    arr = _COMP_ASCII[_UC[np.frombuffer(s, dtype=np.uint8)]][::-1]
    return arr.tobytes()
