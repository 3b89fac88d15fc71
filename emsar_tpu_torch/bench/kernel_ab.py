"""The window-hash and SQUAREM kernels of a parent checkout against this
one's, on the card, in one process:

    python3 -m emsar_tpu_torch.bench.kernel_ab PARENT_DIR [--fa F]
        [--rsh R] [--aln A] [--out bench_cache/kernel_ab.json]

PARENT_DIR is the root of another checkout of this repository (for
example ``git archive`` of the parent commit unpacked into a directory
that ``.gitignore`` lists).  Its ``emsar_tpu_torch`` is loaded under the
name ``parent_port`` and builds its own kernels into its own ``_build/``.
The inputs are the smoke fixture's (``chip_smoke.py`` makes it under
``bench_cache/torch_smoke/``) and the scale transcriptome of
``chip_smoke.py`` phase 8 (``bench.scale_transcriptome``), made here in
memory.

In turns (parent, change, change, parent), device ms per call
(``kernels.measure.device_ms``) and host ms per call of:

* ``window_hash`` on the smoke transcriptome at l50 and on the scale one
  at l76 (~337 M windows), unstranded and stranded;
* ``squarem_block`` (8 cycles from the read-attribution start) on each
  dense batch of the smoke sample's main path, float64 and float32.

The two window hashes must give the same bits and the two SQUAREM blocks
agree within ``kernels.check.block_tol`` (whether they give the same bits
is reported); the script raises otherwise.
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
from ..index.device_build import DeviceRef
from ..io.fasta import build_transcriptome, read_fasta
from ..kernels import measure, squarem, window_hash
from ..kernels.check import block_agreement, block_tol
from ..model.dense import _theta0, batch_to_device, partition_modules

N_ITERS = 8
SMOKE_READLEN = 50


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    cache = os.path.join("bench_cache", "torch_smoke")
    ap.add_argument("--fa", default=os.path.join(cache, "smoke.fa"))
    ap.add_argument("--rsh", default=os.path.join(cache, "smoke.rsh"))
    ap.add_argument("--aln", default=os.path.join(cache, "smoke.bowtieout"))
    ap.add_argument("--out", default=os.path.join("bench_cache",
                                                  "kernel_ab.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    dev = torch.device("cuda")
    pwh, psq = load_parent(args.parent, "kernels.window_hash",
                           "kernels.squarem")
    t0 = time.perf_counter()
    for mod in (pwh, psq, window_hash, squarem):
        mod.build()
    res = {}
    res.update(squarem_cases(psq, args.rsh, args.aln, dev))
    res.update(window_hash_cases(pwh, DeviceRef(read_fasta(args.fa, "E"),
                                                dev),
                                 SMOKE_READLEN, "smoke", 200))
    ref = DeviceRef(build_transcriptome(*scale_transcriptome()), dev)
    res.update(window_hash_cases(pwh, ref, SCALE_READLEN, "scale", 10))
    del ref
    write_result({"card": torch.cuda.get_device_name(0), "order": ORDER,
                  "n_iters": N_ITERS, "cases": res,
                  "seconds": time.perf_counter() - t0}, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
