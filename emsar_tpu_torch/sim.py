"""Minimal RNA-seq read simulator (test fixtures).

Functional equivalent of the reference's readgenerator
(src/readgenerator_functions.c:4-114): uniform random fragments from the
concatenated transcriptome (fw+rc for unstranded, fw-only for
strand-specific), skipping fragments that cross '@'/'$' separators.
SE emits one FASTA; PE emits .R1/.R2 with /1 and /2 suffixes (mate2 is the
reverse complement of the fragment tail).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .io.fasta import Transcriptome, revcomp_bytes


def simulate_fragments(tx: Transcriptome, fraglength: int, numreads: int,
                       rng: np.random.Generator,
                       strand_specific: bool = False) -> np.ndarray:
    """Uniform fragment start positions on the concatenated sequence
    (both halves when unstranded), avoiding separators."""
    limit = (tx.borderpos if strand_specific else tx.seqlength) - fraglength + 1
    seq = tx.seq
    out = np.empty(numreads, dtype=np.int64)
    n = 0
    while n < numreads:
        cand = rng.integers(0, limit, size=(numreads - n) * 2)
        for p in cand:
            frag = seq[p:p + fraglength]
            if (frag == ord("@")).any() or (frag == ord("$")).any():
                continue
            out[n] = p
            n += 1
            if n == numreads:
                break
    return out


def fragments_to_reads(tx: Transcriptome, positions: np.ndarray,
                       readlength: int, fraglength: int, pe: bool,
                       header_prefix: str = "r"
                       ) -> Tuple[List[str], List[bytes], Optional[List[bytes]]]:
    names = [f"{header_prefix}{i}" for i in range(len(positions))]
    seq = tx.seq.tobytes()
    r1 = [seq[p:p + readlength] for p in positions]
    if not pe:
        return names, r1, None
    r2 = [revcomp_bytes(seq[p + fraglength - readlength:p + fraglength])
          for p in positions]
    return names, r1, r2


def gene_family_transcriptome(rng: np.random.Generator, n_genes: int,
                              min_isoforms: int = 2, max_isoforms: int = 10,
                              n_exons: int = 8, min_exon: int = 80,
                              max_exon: int = 400
                              ) -> Tuple[List[str], List[bytes], List[str]]:
    """Exon/isoform-structured transcriptome: each gene has a pool of exons;
    isoforms are ordered exon subsets.  Produces the heavy sequence sharing
    regime that drives large sequence-sharing modules (the reference MLE's
    hard case).  Returns (names, seqs, gene_of_transcript)."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    names: List[str] = []
    seqs: List[bytes] = []
    genes: List[str] = []
    for g in range(n_genes):
        exon_lens = rng.integers(min_exon, max_exon + 1, size=n_exons)
        exons = [bases[rng.integers(0, 4, size=L)].tobytes()
                 for L in exon_lens]
        k = int(rng.integers(min_isoforms, max_isoforms + 1))
        for i in range(k):
            keep = rng.random(n_exons) < rng.uniform(0.4, 0.9)
            if not keep.any():
                keep[int(rng.integers(0, n_exons))] = True
            seq = b"".join(e for e, m in zip(exons, keep) if m)
            names.append(f"G{g:05d}T{i}")
            seqs.append(seq)
            genes.append(f"G{g:05d}")
    return names, seqs, genes


def write_reads_fasta(path: str, names: List[str], seqs: List[bytes],
                      mate: int = 0) -> None:
    suffix = f"/{mate}" if mate else ""
    with open(path, "w") as fh:
        for n, s in zip(names, seqs):
            fh.write(f">{n}{suffix}\n{s.decode('latin-1')}\n")
