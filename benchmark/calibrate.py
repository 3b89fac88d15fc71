"""The readings that a cell's limits are set from, on the card.

    python3 -m benchmark.calibrate --workload CELL --seeds 1,2,3 [--control]
        [--variants program,program_f32,program_loop] [--out FILE]
        [--config NAME --traffic NAME]

For each seed: the run's set-up, one invocation of the program on each of
the run's inputs (as the window runs them), and the numbers its outputs give
against the reference.  With ``--control`` the same numbers for the control,
the reference put in the program's place one precision below the
configuration's (a quantification solved in float32, its columns written in
float64), and for a quantification the fault planted in that reference (the
solve's steps after its first EM step return their state unchanged); for a
build the control is a reference whose window keys are cut to a 32-bit hash.
``--variants`` picks the program's paths: ``program`` (the cell's
invocation), ``program_f32`` (with ``--solver_dtype float32``),
``program_loop`` (without ``--batch_samples``).  One JSON line a seed, on
standard output and in FILE.  ``--config`` and ``--traffic`` read a cell
that ``BENCHMARK.json`` does not hold (``configs/<config>.json``,
``traffic/<traffic>.json``).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from benchmark import run as harness


def readings(cell, seed: int, control: bool, variants) -> dict:
    import torch

    from benchmark import data, refbuild, refquant

    h = harness.Harness()
    os.makedirs(h.work, exist_ok=True)
    s = harness.setup(h, cell, seed)
    dev = torch.device("cuda")
    out = {"seed": seed}
    entry = "emsar_build" if cell.traffic["mode"] == "build" else "emsar"
    quant = cell.traffic["mode"] == "quant"
    refs = {}
    if quant:
        index = refbuild.Index.load(s["paths"]["index"])
        refs = {f: refquant.Reference(index, data.load_alignments(f), dev)
                for g in s["groups"] for f in g}
    for name in variants:
        invs = []
        for k in range(s["inputs"]):
            o = os.path.join(h.work, f"{name}{k}")
            argv = s["argv"](k, o)
            if name == "program_f32":
                argv = ["--solver_dtype", "float32", *argv]
            elif name == "program_loop":
                argv = [a for a in argv if a != "--batch_samples"]
            wall, rc, rec = h.call(entry, argv)
            invs.append(harness.Invocation(wall, s["reads"], rec, rc == 0,
                                           f"exit code {rc}", o, k))
        t0 = time.perf_counter()
        out[name] = (harness.check_quant(cell, s, invs, dev, refs) if quant
                     else harness.check_build(cell, s, invs, dev))
        out[name + "_check_s"] = time.perf_counter() - t0
        out[name + "_wall_s"] = [i.wall_s for i in invs]
        out[name + "_phases"] = [sorted({p[0] for p in i.record.get(
            "phases", [])}) for i in invs]
    if control:
        t0 = time.perf_counter()
        if not quant:
            c = cell.config
            ref = refbuild.build(s["seqs"], s["names"], c["read_length"], dev)
            hashed = refbuild.build(s["seqs"], s["names"], c["read_length"],
                                    dev, key_bits=32)
            a, b = ref.rsh_text().split(b"\n"), hashed.rsh_text().split(b"\n")
            out["control"] = {"rsh_lines_differ": float(
                abs(len(a) - len(b)) + sum(x != y for x, y in zip(a, b)))}
        else:
            for name, make in (("control", refquant.control_outputs),
                               ("fault", refquant.fault_outputs)):
                worst: dict = {}
                for f, ref in refs.items():
                    make(ref, f + "." + name)
                    nums = refquant.judge(
                        ref, f + f".{name}.fpkm",
                        f + f".{name}.fraglength_effect")
                    for k, v in nums.items():
                        worst[k] = max(worst.get(k, v), v)
                out[name] = worst
        out["control_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--variants", default="program")
    ap.add_argument("--out")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    a = ap.parse_args(argv)
    if a.config:
        path = os.path.join(harness.HERE, "configs", a.config + ".json")
        with open(path) as fh:
            conf = json.load(fh)
        with open(os.path.join(harness.HERE, "traffic",
                               a.traffic + ".json")) as fh:
            traffic = json.load(fh)
        cell = harness.Cell(a.workload, 1, conf, path, traffic, {}, [], [])
    else:
        cell = harness.load_cell(a.workload)
    for seed in (int(x) for x in a.seeds.split(",")):
        line = json.dumps(readings(cell, seed, a.control,
                                   a.variants.split(",")))
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
