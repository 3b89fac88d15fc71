"""Output writers, byte-layout-compatible with the reference.

* ``.fpkm`` — print_FPKMfinal (reference src/emsar_functions.c:3163-3212)
* ``.fraglength_effect`` — print_FraglengthDist (:2477-2493)
* ``.segments`` — print_aEUMA_3 (:2262-2300)

FPKM values themselves match at solver tolerance, not bitwise (the
reference seeds its pattern search with time()).
"""

from __future__ import annotations

from typing import List

import numpy as np


def round_off(x: float) -> int:
    """Reference Round_off (:3215): truncate, +1 if frac >= .5."""
    i = int(x)
    return i + 1 if x - i >= 0.5 else i


def _c_g(x: float) -> str:
    """C printf %lg formatting."""
    return "%g" % x


def write_fpkm(path: str, names: List[str], fpkm_rounds: np.ndarray,
               ieuma: np.ndarray, total_read_count: int,
               verbose: int = 1) -> None:
    """fpkm_rounds: [num_round, ntid]; rounds after the first are
    random-restart re-solves whose spread populates sd.of.FPKM (reference
    print_FPKMfinal sd, src/emsar_functions.c:3186-3200).

    Deliberate divergence (documented): the FPKM/iReadcount/TPM columns
    report round 0 — the fully-converged deterministic ML estimate — not
    the reference's mean over rounds (src/emsar_main.c:444-450).  On
    identifiable coordinates every round converges to the same value, so
    the two coincide; on non-identifiable collinear coordinates the
    reference's mean is an arbitrary point of the flat maximizer manifold
    that varies with srand(time), while round 0 is a reproducible
    same-likelihood point.  The sd column still reports the manifold
    spread across rounds, as in the reference."""
    num_round, ntid = fpkm_rounds.shape
    mean = fpkm_rounds.mean(axis=0)
    est = fpkm_rounds[0]
    if num_round > 1:
        sd = np.sqrt(((fpkm_rounds - mean) ** 2).sum(axis=0)
                     / (num_round - 1)) / num_round
    else:
        sd = np.zeros(ntid)
    total_fpkm = float(est.sum())
    ireadcount = (ieuma / 1e3) * est * (total_read_count / 1e6)
    total_int = 0
    with open(path, "w", buffering=1 << 20) as fh:
        fh.write("transcriptID\tFPKM\tsd.of.FPKM\teff.length\tiReadcount\t"
                 "iReadcount.int\tTPM\n")
        for t in range(ntid):
            irc_int = round_off(float(ireadcount[t]))
            total_int += irc_int
            tpm = est[t] * 1e6 / total_fpkm if total_fpkm != 0 else float("nan")
            fh.write(f"{names[t]}\t{est[t]:.6f}\t{sd[t]:.6f}\t"
                     f"{ieuma[t]:.6f}\t{ireadcount[t]:.6f}\t{irc_int}\t"
                     f"{tpm:.6f}\n")
    if verbose > 0:
        print(f"Total inferred readcount={total_int}")


def write_fraglength_dist(path: str, fraglen_min: int, n_fraglen: int,
                          fraglength_counts: np.ndarray,
                          wf: np.ndarray) -> None:
    with open(path, "w") as fh:
        fh.write("Fragment.length\tObs.Counts\t"
                 "normalized.Fragment.length.sampling.prob\n")
        for i in range(n_fraglen):
            fl = i + fraglen_min
            cnt = int(fraglength_counts[fl]) if fl < len(fraglength_counts) else 0
            fh.write(f"{fl}\t{cnt}\t{_c_g(float(wf[i]))}\n")


def write_posbias(path: str, posbias) -> None:
    """.posbias: per relative position, 5'/3' fragment counts, unavailable
    counts and normalized frequencies (reference print_posbias,
    src/emsar_functions.c:2580-2597).  Note: the reference writes this file
    before reading any alignments (src/emsar_main.c:364-372), so its output
    is all zeros in v2.0.1; we write it after the first sample is read so
    the surface is actually usable."""
    n5, n3 = posbias.normalized()
    with open(path, "w") as fh:
        fh.write("relative_position\t5-frag_count\t5-avail_count\t"
                 "5-norm_frag_count\t3-frag_count\t3-avail_count\t"
                 "3-norm_frag_count\n")
        for i in range(posbias.freq_len):
            fh.write(f"{i}\t{posbias.freq_5[i]:.6f}\t"
                     f"{posbias.unavail_5[i]:.6f}\t{n5[i]:.6f}\t"
                     f"{posbias.freq_3[i]:.6f}\t{posbias.unavail_3[i]:.6f}\t"
                     f"{n3[i]:.6f}\n")


def write_segments(path: str, names: List[str], ct_offsets: np.ndarray,
                   ct_tids: np.ndarray, cs: np.ndarray, adj_euma: np.ndarray,
                   read_count: np.ndarray, fpkm_mean: np.ndarray,
                   total_read_count: int) -> None:
    """.segments: per-cid set id, transcripts, eff. length, read count and
    expected read count (multiplicities included, as the reference sums
    over CT[cid] with duplicates)."""
    n_cid = len(ct_offsets) - 1
    with open(path, "w", buffering=1 << 20) as fh:
        fh.write("segment_id\tsequence_sharing_set_id\ttranscript_id\t"
                 "transcript_names\teff.length\tReadcount\texpected_Readcount\n")
        for cid in range(n_cid):
            tids = ct_tids[ct_offsets[cid]:ct_offsets[cid + 1]]
            tid_str = ",".join(f"t{t}" for t in tids)
            name_str = "+".join(names[t] for t in tids)
            expected = float(fpkm_mean[tids].sum()
                             * (adj_euma[cid] / 1e3)
                             * (total_read_count / 1e6))
            fh.write(f"c{cid}\ts{cs[cid]}\t{tid_str}\t{name_str}\t"
                     f"{adj_euma[cid]:.6f}\t{int(read_count[cid])}\t"
                     f"{expected:.6f}\n")
