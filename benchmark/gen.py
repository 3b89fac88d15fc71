"""The benchmark's inputs: transcriptomes and read samples, made from seeds.

``gene_family`` is a copy of ``emsar_tpu_torch/sim.py::gene_family_transcriptome``
(the same random draws in the same order, so the same seed gives the same
transcriptome) that also keeps the gene structure: which exons each
isoform keeps.  ``sample_reads`` is a vectorised copy of
``tools/make_scale_reads.py``: exons are random sequences at least a read
long, so a read's exact-match alignment set follows from the structure alone
(a read inside one exon matches every isoform keeping that exon; a read over
the junction of kept exons e, f matches every isoform keeping e and f and
dropping the exons between).  About 0.1% of junction reads miss a chance
match of their short overhang elsewhere; the file is still valid exact-aligner
output and both the program and the reference read the same alignments.
The generator draws its transcripts from a log-normal abundance per
transcript (``abundance``) instead of ``make_scale_reads``'s uniform
start, and puts each read on the reverse strand with a given share (one
half for an unstranded library).  The traffic is synthetic: no published
sample's abundance spread is in the repository.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class Structure:
    """Exon structure of a gene-family transcriptome."""

    names: List[str]
    gene_of: np.ndarray  # int64 [ntx]
    exon_lens: np.ndarray  # int64 [ntx, n_exons] (the gene's exon pool)
    keeps: np.ndarray  # bool [ntx, n_exons]

    @property
    def lengths(self) -> np.ndarray:
        return np.where(self.keeps, self.exon_lens, 0).sum(axis=1)


def gene_family(rng: np.random.Generator, n_genes: int, min_isoforms: int,
                max_isoforms: int, n_exons: int, min_exon: int,
                max_exon: int) -> Tuple[List[bytes], Structure]:
    """(sequences, structure) of ``n_genes`` genes, each a pool of
    ``n_exons`` random exons with 2..``max_isoforms`` isoforms, each an
    ordered subset of the pool.  Transcript names are G<gene>T<isoform>."""
    names: List[str] = []
    seqs: List[bytes] = []
    gene_of: List[int] = []
    lens_of: List[np.ndarray] = []
    keeps: List[np.ndarray] = []
    for g in range(n_genes):
        exon_lens = rng.integers(min_exon, max_exon + 1, size=n_exons)
        exons = [_BASES[rng.integers(0, 4, size=L)].tobytes()
                 for L in exon_lens]
        k = int(rng.integers(min_isoforms, max_isoforms + 1))
        for i in range(k):
            keep = rng.random(n_exons) < rng.uniform(0.4, 0.9)
            if not keep.any():
                keep[int(rng.integers(0, n_exons))] = True
            seqs.append(b"".join(e for e, m in zip(exons, keep) if m))
            names.append(f"G{g:05d}T{i}")
            gene_of.append(g)
            lens_of.append(exon_lens)
            keeps.append(keep)
    return seqs, Structure(names=names, gene_of=np.asarray(gene_of),
                           exon_lens=np.asarray(lens_of, dtype=np.int64),
                           keeps=np.asarray(keeps))


def transcriptome(shape: dict, rng: np.random.Generator
                  ) -> Tuple[List[bytes], Structure]:
    """``gene_family`` with a configuration's ``transcriptome`` shape."""
    return gene_family(rng, shape["genes"],
                       shape["min_isoforms"], shape["max_isoforms"],
                       shape["exons"], shape["min_exon"], shape["max_exon"])


def write_fasta(path: str, names: List[str], seqs: List[bytes]) -> None:
    with open(path + ".tmp", "wb", buffering=1 << 22) as fh:
        for n, s in zip(names, seqs):
            fh.write(b">" + n.encode() + b"\n" + s + b"\n")
    os.replace(path + ".tmp", path)


@dataclasses.dataclass
class Alignments:
    """A sample's alignment lines, grouped by read (read ids ascending)."""

    n_reads: int
    read: np.ndarray  # int64 [lines]
    tid: np.ndarray  # int64 [lines]
    pos: np.ndarray  # int64 [lines], 0-based in the transcript
    minus: np.ndarray  # bool [n_reads]: the read is on the reverse strand


def abundance(ntx: int, sigma: float, rng: np.random.Generator
              ) -> np.ndarray:
    """A log-normal weight per transcript: exp(sigma * N(0, 1))."""
    return np.exp(sigma * rng.standard_normal(ntx))


def sample_reads(st: Structure, rl: int, n_reads: int, weight: np.ndarray,
                 rng: np.random.Generator, minus_share: float = 0.5
                 ) -> Alignments:
    """``n_reads`` exact-match SE reads of length ``rl``: fragments drawn in
    proportion to the transcript's ``weight`` x (length - rl + 1), starts
    uniform along the transcript, each read on the reverse strand with
    probability ``minus_share``."""
    n_exons = st.keeps.shape[1]
    if st.exon_lens.min() < rl - 1:
        raise ValueError("an exon shorter than a read less one base: a read "
                         "could span two junctions")
    kept_lens = np.where(st.keeps, st.exon_lens, 0)
    tx_len = kept_lens.sum(axis=1)
    pre = np.cumsum(kept_lens, axis=1) - kept_lens  # slot start in tx
    ntx = len(tx_len)
    bits = (st.keeps.astype(np.int64) << np.arange(n_exons)).sum(axis=1)
    # next kept slot after e, per transcript (-1: none)
    nxt = np.full((ntx, n_exons), -1, dtype=np.int64)
    for e in range(n_exons - 1):
        later = st.keeps[:, e + 1:]
        nxt[:, e] = np.where(later.any(axis=1),
                             e + 1 + np.argmax(later, axis=1), -1)
    between = np.zeros((n_exons, n_exons), dtype=np.int64)
    for e in range(n_exons):
        for f in range(e + 2, n_exons):
            between[e, f] = ((1 << f) - 1) & ~((1 << (e + 1)) - 1)
    gstart = np.concatenate([[0], np.flatnonzero(np.diff(st.gene_of)) + 1,
                             [ntx]])
    n_iso = np.diff(gstart)
    gene_idx = np.repeat(np.arange(len(n_iso)), n_iso)

    w = weight * np.maximum(tx_len - rl + 1, 0)
    tid = rng.choice(ntx, size=n_reads, p=w / w.sum())
    pos = (rng.random(n_reads) * (tx_len[tid] - rl + 1)).astype(np.int64)
    minus = rng.random(n_reads) < minus_share

    # the kept slot holding the read's first base (dropped slots share the
    # next kept slot's start, so the last slot starting at or before pos is
    # kept)
    e = (pos[:, None] >= pre[tid]).sum(axis=1) - 1
    off = pos - pre[tid, e]
    span = off + rl > st.exon_lens[tid, e]
    f = nxt[tid, e]
    need = (1 << e) | np.where(span & (f >= 0), 1 << np.maximum(f, 0), 0)
    blk = np.where(span, between[e, np.maximum(f, 0)], 0)

    g = gene_idx[tid]
    lines_r, lines_t, lines_p = [], [], []
    for j in range(int(n_iso.max())):
        has = j < n_iso[g]
        sib = np.where(has, gstart[g] + j, 0)
        sb = bits[sib]
        ok = has & ((sb & need) == need) & ((sb & blk) == 0)
        r = np.flatnonzero(ok)
        lines_r.append(r)
        lines_t.append(sib[r])
        lines_p.append(pre[sib[r], e[r]] + off[r])
    read = np.concatenate(lines_r)
    order = np.argsort(read, kind="stable")
    return Alignments(n_reads=n_reads, read=read[order],
                      tid=np.concatenate(lines_t)[order],
                      pos=np.concatenate(lines_p)[order], minus=minus)


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """[n, width] ASCII digits of ``values``, zero-padded."""
    out = np.empty((len(values), width), dtype=np.uint8)
    v = values.copy()
    for k in range(width - 1, -1, -1):
        out[:, k] = 48 + v % 10
        v //= 10
    return out


def write_bowtie(path: str, aln: Alignments, names: List[str], rl: int,
                 chunk: int = 1 << 20) -> None:
    """Bowtie's default output, a line an alignment:
    ``id  strand  transcript  pos  sequence  quality  0``, ids and positions
    zero-padded so that every line has the same width (the quantifiers read
    the sequence column only for its length)."""
    name_len = {len(n) for n in names}
    if len(name_len) != 1:
        raise ValueError("transcript names of different lengths")
    nl = name_len.pop()
    name_mat = np.frombuffer("".join(names).encode(),
                             dtype=np.uint8).reshape(-1, nl)
    wid = len(str(max(aln.n_reads - 1, 1)))
    wpos = len(str(max(int(aln.pos.max(initial=0)), 1)))
    head = b"r"
    mid1 = b"\t+\t"
    mid2 = b"\t" + b"A" * rl + b"\tI\t0\t\n"
    cols = [len(head), wid, len(mid1), nl, 1, wpos, len(mid2)]
    width = sum(cols)
    starts = np.cumsum([0] + cols)
    template = np.zeros(width, dtype=np.uint8)
    template[starts[0]:starts[1]] = np.frombuffer(head, np.uint8)
    template[starts[2]:starts[3]] = np.frombuffer(mid1, np.uint8)
    template[starts[4]] = ord("\t")
    template[starts[6]:starts[7]] = np.frombuffer(mid2, np.uint8)
    with open(path + ".tmp", "wb") as fh:
        for lo in range(0, len(aln.read), chunk):
            hi = min(lo + chunk, len(aln.read))
            m = np.broadcast_to(template, (hi - lo, width)).copy()
            m[:, starts[1]:starts[2]] = _digits(aln.read[lo:hi], wid)
            m[aln.minus[aln.read[lo:hi]], starts[2] + 1] = ord("-")
            m[:, starts[3]:starts[4]] = name_mat[aln.tid[lo:hi]]
            m[:, starts[5]:starts[6]] = _digits(aln.pos[lo:hi], wpos)
            m.tofile(fh)
    os.replace(path + ".tmp", path)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one input stream of a run: the same (seed, stream)
    gives the same draws."""
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))
