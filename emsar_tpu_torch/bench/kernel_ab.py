"""The window-hash, SQUAREM and PE candidate kernels of a parent checkout
against this one's, on the card, in one process:

    python3 -m emsar_tpu_torch.bench.kernel_ab PARENT_DIR [--fa F]
        [--rsh R] [--aln A] [--pe-fa P] [--out bench_cache/kernel_ab.json]

PARENT_DIR is the root of another checkout of this repository (for
example ``git archive`` of the parent commit unpacked into a directory
that ``.gitignore`` lists).  Its ``emsar_tpu_torch`` is loaded under the
name ``parent_port`` and builds its own kernels into its own ``_build/``.
The inputs are the smoke fixture's and bench.py's PE FASTA
(``chip_smoke.py`` makes them under ``bench_cache/torch_smoke/``) and the
scale transcriptome of ``chip_smoke.py`` phase 8
(``bench.scale_transcriptome``), made here in memory.

In turns (parent, change, change, parent), device ms per call
(``kernels.measure.device_ms``) and host ms per call of:

* ``window_hash`` on the smoke transcriptome at l50 and on the scale one
  at l76 (~337 M windows), unstranded and stranded;
* ``squarem_block`` (8 cycles from the read-attribution start) on each
  dense batch of the smoke sample's main path, float64 and float32;
* ``pe_candidates`` at the PE ``-x`` build's shape (bench.py's PE FASTA,
  ssfr l101 F290-300, one chunk) and on the first chunk of the scale
  transcriptome's ssfr l101 builds at F290-300 (nfl 11) and F1-400
  (nfl 300), as the build plans them: the kernel alone, and the kernel
  with ``_sort_candidates`` (each side its own; both read a count back).
  The parent's full grid is resolved by ``pe_candidates.resolve_grid``.

The two window hashes must give the same bits, the two SQUAREM blocks
agree within ``kernels.check.block_tol`` (whether they give the same bits
is reported), and the two candidate expansions give the same multiset of
sorted (key, payload) pairs of multi-cluster members and the same
singleton counts; the script raises otherwise.
Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import numpy as np
import torch

from . import (ORDER, SCALE_READLEN, load_parent, scale_transcriptome,
               smoke_sample, write_result)
from ..index import device_build_pe
from ..index.device_build import DeviceRef
from ..io.fasta import build_transcriptome, read_fasta
from ..kernels import measure, squarem, window_hash
from ..kernels import pe_candidates as kpe
from ..kernels.check import block_agreement, block_tol
from ..model.dense import _theta0, batch_to_device, partition_modules

N_ITERS = 8
SMOKE_READLEN = 50
# bench.py's PE shape and the scale PE builds: l101, F290-300 (and F1-400)
PE_READLEN = 101


def ab(label: str, fns: dict, n: int, bound, extra=None) -> dict:
    """Time parent and change in the order ORDER; medians and runs."""
    runs = {who: [] for who in fns}
    for who in ORDER:
        host = measure.host_ms(fns[who], min(n, 20))
        runs[who].append({"ms": measure.device_ms(fns[who], n=n,
                                                  host_per_call_ms=host),
                          "host_ms": host})
    med = {who: {k: statistics.median(r[k] for r in v)
                 for k in ("ms", "host_ms")} for who, v in runs.items()}
    out = {"median": med, "runs": runs, "bound_ms": bound[0],
           "bound_by": bound[1],
           "share_of_bound": {who: bound[0] / med[who]["ms"] for who in med}}
    out.update(extra or {})
    print(f"[kernel_ab] {label}: parent {med['parent']['ms']:.5f} ms, "
          f"change {med['change']['ms']:.5f} ms on the card; bound "
          f"{bound[0]:.5f} ms ({bound[1]})", flush=True)
    return out


def window_hash_cases(pwh, ref: DeviceRef, rl: int, label: str,
                      n_calls: int) -> dict:
    n = ref.borderpos - rl + 1
    tidf = ref.tid_forward(n)
    out = {}
    for unstranded in (True, False):
        args = (ref.codes, tidf, ref.borderpos, ref.seqlength, rl,
                unstranded)
        a, b = pwh.window_hash(*args), window_hash.window_hash(*args)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"window_hash {label}: parent and change "
                                 f"differ")
        del a, b
        bound = measure.bound_ms(
            window_hash.bytes_moved(ref.borderpos, rl, unstranded), 0)
        name = f"window_hash {label} l{rl} {'ns' if unstranded else 'ss'}"
        out[name] = ab(name, {"parent": lambda: pwh.window_hash(*args),
                              "change": lambda: window_hash.window_hash(
                                  *args)}, n_calls, bound, {"windows": n})
    return out


def squarem_cases(psq, rsh: str, aln: str, dev) -> dict:
    x = smoke_sample(rsh, aln)
    out = {}
    for np_dt, dt in ((np.float64, torch.float64),
                      (np.float32, torch.float32)):
        for batch in partition_modules(x.graph, x.modules, x.eumaps,
                                       x.read_count, dtype=np_dt).batches:
            db = batch_to_device(batch, dev, dt)
            args = [db.m, db.eumaps, db.reads, db.inv_denom, _theta0(db)]
            a = psq.squarem_block(*args, N_ITERS)
            b = squarem.squarem_block(*args, N_ITERS)
            err, diff, n = block_agreement(b, a, *args, N_ITERS)
            tol = block_tol(dt, N_ITERS)
            if err > tol or not torch.isfinite(b).all():
                raise AssertionError(f"squarem_block {batch.shape} {dt}: "
                                     f"{err:.3e} over {n} modules (tol "
                                     f"{tol:g})")
            B, C, T = batch.shape
            bound = measure.bound_ms(measure.nbytes(*args, b),
                                     16 * B * C * T * N_ITERS, dt)
            name = f"squarem_block {batch.shape} {str(dt)[6:]}"
            out[name] = ab(name, {
                "parent": lambda: psq.squarem_block(*args, N_ITERS),
                "change": lambda: squarem.squarem_block(*args, N_ITERS)},
                200, bound, {"max_rel_diff": err, "max_abs_diff": diff,
                             "modules_compared": n,
                             "bit_equal": bool(torch.equal(a, b))})
    return out


def _sorted_pairs(keys: torch.Tensor, pay: torch.Tensor):
    """(keys, payloads) ordered by key, then payload."""
    order = torch.sort(pay, stable=True).indices
    order = order[torch.sort(keys[order], stable=True).indices]
    return keys[order], pay[order]


def pe_case(ppe, psort, ref: DeviceRef, fmin: int, fmax: int, label: str,
            n_calls: int, whole: bool) -> dict:
    """The parent's and this checkout's pe_candidates on one chunk of the
    ssfr l101 build at fragment lengths fmin-fmax (``whole``: every
    member, as one chunk; else the first chunk the build plans)."""
    dev = ref.codes.device
    rl = PE_READLEN
    fl_min = max(fmin, rl)
    nfl, d0 = fmax - fl_min + 1, fl_min - rl
    t32, nsep = ref.t32(rl), ref.nsep()
    R, spos, srank = device_build_pe.rank_pass(ref, t32, rl, False, 0)
    plan = device_build_pe.plan_chunks(
        srank, nfl, device_build_pe.chunk_budget(dev, ref.seqlength + 1))
    lo, hi, weight = (0, spos.shape[0], sum(w for _, _, w in plan)) \
        if whole else plan[0]
    tail = (R, None, t32, nsep, d0, nfl, rl, ref.borderpos, ref.seqlength,
            False)
    ctail = (R, None, kpe.pack_tables(t32, nsep)) + tail[4:]
    mpos, mrank = spos[lo:hi], srank[lo:hi]
    n_single = (int(t32.max()) + 1) * nfl
    got_single = torch.zeros(n_single, dtype=torch.int64, device=dev)
    want_single = torch.zeros_like(got_single)
    got = _sorted_pairs(*kpe.pe_candidates(spos, srank, lo, hi, *ctail,
                                           got_single, capacity=weight))
    grid = ppe.pe_candidates(mpos, mrank, *tail)
    want = _sorted_pairs(*kpe.resolve_grid(
        *grid, kpe.singleton_members(srank, lo, hi), nfl, want_single))
    n_grid = grid[0].shape[0]
    n_valid = int((grid[0] != kpe.INVALID_KEY).sum())
    del grid
    same = (all(torch.equal(a, b) for a, b in zip(got, want))
            and torch.equal(got_single, want_single))
    if not same:
        raise AssertionError(f"pe_candidates {label}: parent and change "
                             f"differ")
    n_written, n_kept = got[0].shape[0], int(got_single.sum())
    n_entries = int(torch.count_nonzero(got_single))
    del got, want
    scratch = torch.zeros_like(got_single)
    extra = {"members": hi - lo, "nfl": nfl, "grid": n_grid,
             "valid": n_valid, "written": n_written,
             "singleton_slots": n_kept, "singleton_entries": n_entries,
             "singleton_members": int(kpe.singleton_members(srank, lo,
                                                            hi).sum()),
             "parent_bound_ms": measure.bound_ms(
                 kpe.bytes_moved_grid(mpos, nfl, False), 0)[0]}
    bound = measure.bound_ms(kpe.bytes_moved(mpos, nfl, False, n_written,
                                             n_entries), 0)
    out = {label: ab(label, {
        "parent": lambda: ppe.pe_candidates(mpos, mrank, *tail),
        "change": lambda: kpe.launch(spos, srank, lo, hi, *ctail, scratch,
                                     capacity=weight)},
        n_calls, bound, extra)}
    name = f"{label} + sort"
    out[name] = ab(name, {
        "parent": lambda: psort(*ppe.pe_candidates(mpos, mrank, *tail)),
        "change": lambda: device_build_pe._sort_candidates(
            *kpe.pe_candidates(spos, srank, lo, hi, *ctail, scratch,
                               capacity=weight))},
        n_calls, bound, extra)
    return out


def pe_candidates_cases(ppe, psort, pe_fa: str, scale_ref, dev) -> dict:
    out = pe_case(ppe, psort, DeviceRef(read_fasta(pe_fa, "E"), dev), 290,
                  300, "pe_candidates PE -x shape", 20, True)
    for fmin, fmax in ((290, 300), (1, 400)):
        out.update(pe_case(ppe, psort, scale_ref, fmin, fmax,
                           f"pe_candidates scale chunk F{fmin}-{fmax}", 5,
                           False))
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    cache = os.path.join("bench_cache", "torch_smoke")
    ap.add_argument("--fa", default=os.path.join(cache, "smoke.fa"))
    ap.add_argument("--rsh", default=os.path.join(cache, "smoke.rsh"))
    ap.add_argument("--aln", default=os.path.join(cache, "smoke.bowtieout"))
    ap.add_argument("--pe-fa", default=os.path.join(cache, "benchpe.fa"))
    ap.add_argument("--out", default=os.path.join("bench_cache",
                                                  "kernel_ab.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    dev = torch.device("cuda")
    pwh, psq, ppe, pbuild = load_parent(
        args.parent, "kernels.window_hash", "kernels.squarem",
        "kernels.pe_candidates", "index.device_build_pe")
    t0 = time.perf_counter()
    for mod in (pwh, psq, ppe, window_hash, squarem, kpe):
        mod.build()
    res = squarem_cases(psq, args.rsh, args.aln, dev)
    res.update(window_hash_cases(
        pwh, DeviceRef(read_fasta(args.fa, "E"), dev), SMOKE_READLEN,
        "smoke", 200))
    ref = DeviceRef(build_transcriptome(*scale_transcriptome()), dev)
    res.update(window_hash_cases(pwh, ref, SCALE_READLEN, "scale", 10))
    res.update(pe_candidates_cases(ppe, pbuild._sort_candidates, args.pe_fa,
                                   ref, dev))
    del ref
    write_result({"card": torch.cuda.get_device_name(0), "order": ORDER,
                  "n_iters": N_ITERS, "cases": res,
                  "seconds": time.perf_counter() - t0}, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
