"""``benchmark/child.py`` with a fault planted in the program, for the tests
that show a run with a broken timed path comes out not correct.

    python -m benchmark.faulty_child FAULT RECORD TRACE ENTRY [ARG ...]

FAULT is one of:

* ``unchanged``: every step of the solve after its first EM step leaves
  its state as it was, so the solve returns one EM step from its start
  (each module's reads kept, the likelihood far from its maximum);
* ``half``: half of the batch left out and the mean taken over the rest:
  every other read of an alignment file is ingested, its counts doubled;
  a build reads every other transcript's windows only;
* ``altered``: one answer altered where it is produced: the most abundant
  transcript's FPKM written 1% high; a build's first multi-transcript
  segment counted once more.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

from benchmark import child


def _one_em_step(problem) -> np.ndarray:
    """One EM step from every transcript at one abundance."""
    cid, tid = problem.edge_cid, problem.edge_tid
    theta = np.where(problem.denom > 0, 1.0, 0.0)
    s = np.bincount(cid, problem.edge_mult * theta[tid],
                    minlength=len(problem.reads))
    ratio = np.where(problem.reads > 0, problem.reads / np.where(
        s > 0, s, 1.0), 0.0)
    g = np.bincount(tid, problem.edge_mult * ratio[cid],
                    minlength=len(theta))
    return np.where(problem.denom > 0, theta * g / np.where(
        problem.denom > 0, problem.denom, 1.0), 0.0)


def _unchanged() -> None:
    from emsar_tpu_torch.model import quantify

    def solve_auto(graph, modules, eumaps, read_count, problem, *args,
                   **kwargs):
        return _one_em_step(problem), 0, None

    quantify._solve_auto = solve_auto
    quantify.polish_host_f64 = lambda problem, theta, **kw: (theta, 0)


def _half() -> None:
    from emsar_tpu_torch.index import device_build
    from emsar_tpu_torch.ingest import native

    collapse = native.NativeCollapser.collapse_file

    def collapse_half(self, path, *args, **kwargs):
        half = path + ".half"
        with open(path) as src, open(half, "w") as dst:
            last, keep = None, False
            for line in src:
                rid = line[:line.index("\t")]
                if rid != last:
                    last, keep = rid, not keep
                if keep:
                    dst.write(line)
        c = collapse(self, half, *args, **kwargs)
        os.remove(half)
        return dataclasses.replace(
            c, single_counts=2 * c.single_counts,
            multi_counts=2 * c.multi_counts,
            fraglength_counts=2 * c.fraglength_counts,
            total_read_count=2 * c.total_read_count)
    native.NativeCollapser.collapse_file = collapse_half

    build = device_build.build_se_index_device

    def build_half(tx, *args, **kwargs):
        seq = tx.seq.copy()
        codes = tx.codes.copy()
        for t in range(1, tx.n_transcripts, 2):  # every other transcript
            a, b = tx.cuml[t], tx.cuml[t + 1] - 1
            seq[a:b], codes[a:b] = ord("N"), 4
            n = tx.seqlength
            seq[n - b:n - a], codes[n - b:n - a] = ord("N"), 4
        return build(dataclasses.replace(tx, seq=seq, codes=codes), *args,
                     **kwargs)
    device_build.build_se_index_device = build_half


def _altered() -> None:
    from emsar_tpu_torch.index import build
    from emsar_tpu_torch.io import outputs

    write = outputs.write_fpkm

    def write_fpkm(path, names, fpkm_rounds, *args, **kwargs):
        rounds = fpkm_rounds.copy()
        rounds[0, int(np.argmax(rounds[0]))] *= 1.01
        return write(path, names, rounds, *args, **kwargs)
    outputs.write_fpkm = write_fpkm

    se = build.build_se_index

    def build_se(*args, **kwargs):
        idx = se(*args, **kwargs)
        idx.multi_euma[0, :] += 1
        return idx
    build.build_se_index = build_se


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}

if __name__ == "__main__":
    FAULTS[sys.argv[1]]()
    sys.exit(child.main(sys.argv[2:]))
