"""The default solve of ``emsar -I`` through each dense route and gain.

    python3 -m emsar_tpu_torch.bench.dense_routes IDX.rsh ALN [ALN ...]
        [--out FILE.json] [--repeat 2]

For each alignment file, the sample is collapsed once and quantified by
``model/quantify.py::quantify_sample`` (the CLI's "EM solve" and restart
rounds) four ways: the dense batches on torch.bmm (``dense._solve_loop``,
forced by emptying ``dense.KERNEL_CLASSES`` for the run) or on the hand
kernel (``--solver_pallas``, ``dense._dense_solve_pallas``), each with the
JAX package's gain (``solver_gain`` 'jax') and with the repaired one.  Of each run's last repeat it reports the spans: "EM solve",
every ``solve: dense batch`` (shape, blocks, stop, seconds), ``solve:
polish`` (cycles, stop, seconds), "restart rounds", the logL and the card's
peak of allocated memory.  The first repeat builds the kernels and warms
the allocator; the card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

ROUTES = (("bmm", False), ("kernel", True))
GAINS = ("jax", "repaired")


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip()
    except OSError:
        return "(no nvidia-smi)"


def _summary(spans) -> dict:
    out = {"dense": [], "restart_s": 0.0}
    for s in spans:
        a = s.attrs
        if s.name == "EM solve":
            out["em_solve_s"] = s.seconds
        elif s.name == "solve: dense batch":
            out["dense"].append({"shape": a.get("shape"),
                                 "blocks": a.get("blocks"),
                                 "stop": a.get("stop"), "s": s.seconds})
        elif s.name == "solve: polish":
            out["polish"] = {"cycles": a.get("cycles"),
                             "stop": a.get("stop"), "s": s.seconds}
        elif s.name == "restart rounds":
            out["restart_s"] += s.seconds
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("rsh")
    ap.add_argument("aln", nargs="+")
    ap.add_argument("--out", default=None)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..config import QuantConfig
    from ..ingest import native
    from ..io.rsh import RshIndex
    from ..model import dense
    from ..model.quantify import quantify_sample
    from ..utils import timing

    dev = torch.device(args.device)
    card = _card()
    print(f"card: {card}", flush=True)
    index = RshIndex.load(args.rsh)
    base = QuantConfig(verbose=0, min_fraglength=index.min_fraglength,
                       max_fraglength=index.max_fraglength)
    collapser = native.NativeCollapser(index)
    rows = []
    for aln in args.aln:
        counts = collapser.collapse_file(
            aln, "bowtie", False, 0, base.max_repeat, base.min_fraglength,
            base.max_fraglength)
        for route, pallas in ROUTES:
            for gain in GAINS:
                cfg = QuantConfig(**{**base.__dict__, "solver_pallas": pallas,
                                     "solver_gain": gain})
                classes = dense.KERNEL_CLASSES
                dense.KERNEL_CLASSES = classes if pallas else ()
                for _ in range(args.repeat):
                    n0 = len(timing.spans())
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats(dev)
                    t0 = time.perf_counter()
                    res = quantify_sample(index, counts, cfg, dev)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                dense.KERNEL_CLASSES = classes
                row = {"aln": aln, "route": route, "gain": gain,
                       "quantify_s": wall, "loglik": res.loglik,
                       "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                      if dev.type == "cuda" else None),
                       **_summary(timing.spans()[n0:])}
                rows.append(row)
                print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
