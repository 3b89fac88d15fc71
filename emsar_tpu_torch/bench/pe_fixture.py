"""The PE workloads of ``chip_smoke.py``: bench.py's PE shape (1000 genes,
l101, F290-300, 500,000 fragments, ssfr; bench.py:42-45) as exact-match
alignments in a BAM file, written with the port's own code, and the
transcriptomes of the PE build checks.

The alignments follow bench.py's ``ensure_pe_fixture``: fragments are
drawn on the forward strand of transcripts at least F_max long, and every
pair of positions whose mate1 and mate2 windows equal the fragment's, in
one transcript at the fragment's length, is one alignment (mate1 forward,
mate2 reverse)."""

from __future__ import annotations

import os
import struct
from typing import List, Tuple

import numpy as np

from ..index import pack
from ..index.build import se_group
from ..io.bam import _BGZF_EOF, _bgzf_compress
from ..io.fasta import Transcriptome

PE_GENES = 1000
PE_READLEN = 101
PE_FMIN, PE_FMAX = 290, 300
PE_PAIRS = 500_000
PE_SEED = 1235


def pe_alignments(tx: Transcriptome, rl: int, fmin: int, fmax: int,
                  n_pairs: int, rng: np.random.Generator
                  ) -> Tuple[np.ndarray, ...]:
    """Every exact-match alignment of ``n_pairs`` simulated fragments:
    (pair, tid, mate1 position, mate2 position), positions within the
    transcript, in pair order."""
    pos = np.arange(0, tx.borderpos - rl + 1, dtype=np.int64)
    pos = pos[pack.valid_windows(pack.bad_prefix(tx.codes), pos, rl)]
    spos, run_id, _ = se_group(pack.pack16(tx.codes), pos, tx.seqlength, rl,
                               True)
    run_of = np.full(tx.borderpos, -1, dtype=np.int64)
    run_of[spos] = run_id
    counts = np.bincount(run_id)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    lens = np.diff(tx.cuml) - 1
    ok_t = np.flatnonzero(lens >= fmax)
    t = ok_t[rng.integers(0, len(ok_t), size=n_pairs)]
    F = rng.integers(fmin, fmax + 1, size=n_pairs)
    start = (rng.random(n_pairs) * (lens[t] - F + 1)).astype(np.int64)
    p1 = tx.cuml[t] + start
    d = F - rl
    # every member of each fragment's mate1 cluster
    r = run_of[p1]
    k = counts[r]
    pair = np.repeat(np.arange(n_pairs), k)
    within = np.arange(int(k.sum())) - np.repeat(np.cumsum(k) - k, k)
    mem = spos[np.repeat(offsets[r], k) + within]
    tid = tx.transcript_of(mem, rl)
    q2 = mem + d[pair]
    # mate2 inside the member's transcript and equal to the fragment's
    ok = q2 + rl <= tx.cuml[tid + 1] - 1
    ok &= run_of[np.minimum(q2, tx.borderpos - 1)] == run_of[p1 + d][pair]
    pair, tid, mem = pair[ok], tid[ok], mem[ok]
    tpos = mem - tx.cuml[tid]
    return pair, tid, tpos, tpos + d[pair]


def write_pe_bam(path: str, names: List[str], lengths: List[int],
                 pair: np.ndarray, tid: np.ndarray, pos1: np.ndarray,
                 pos2: np.ndarray, rl: int) -> int:
    """A qname-grouped BAM of the alignments (read names rp<pair>, mate1
    forward then mate2 reverse, MD:Z:<rl>, constant sequence and quality:
    the quantifier reads only lengths).  Returns the record count."""
    md = b"MDZ" + str(rl).encode() + b"\x00"
    n_seq = (rl + 1) // 2
    rec = np.dtype([
        ("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
        ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
        ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
        ("next_ref_id", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4"),
        ("read_name", "u1", 10), ("cigar", "<u4"), ("seq", "u1", n_seq),
        ("qual", "u1", rl), ("aux", "u1", len(md))])
    n = 2 * len(pair)
    recs = np.zeros(n, dtype=rec)
    recs["block_size"] = rec.itemsize - 4
    recs["ref_id"] = np.repeat(tid, 2)
    recs["pos"] = np.stack([pos1, pos2], axis=1).reshape(-1)
    recs["l_read_name"] = 10
    recs["n_cigar"] = 1
    recs["flag"] = np.tile([0x1 | 0x40, 0x1 | 0x80 | 0x10], len(pair))
    recs["l_seq"] = rl
    recs["next_ref_id"] = -1
    recs["next_pos"] = -1
    digits = (np.repeat(pair, 2)[:, None]
              // 10 ** np.arange(6, -1, -1)) % 10 + ord("0")
    recs["read_name"][:, :2] = np.frombuffer(b"rp", np.uint8)
    recs["read_name"][:, 2:9] = digits
    recs["cigar"] = rl << 4
    recs["qual"] = 0xFF
    recs["aux"] = np.frombuffer(md, np.uint8)
    text = "".join(f"@SQ\tSN:{a}\tLN:{b}\n"
                   for a, b in zip(names, lengths)).encode()
    head = bytearray(b"BAM\x01" + struct.pack("<i", len(text)) + text
                     + struct.pack("<i", len(names)))
    for a, b in zip(names, lengths):
        nb = a.encode() + b"\x00"
        head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", b)
    body = memoryview(bytes(head) + recs.tobytes())
    with open(path + ".tmp", "wb") as fh:
        for i in range(0, len(body), 60000):
            fh.write(_bgzf_compress(bytes(body[i:i + 60000])))
        fh.write(_BGZF_EOF)
    os.replace(path + ".tmp", path)
    return n
