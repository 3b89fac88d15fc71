"""The benchmark of emsar_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

CELL is a workload of ``BENCHMARK.json``.  Set-up builds the program's
kernels into its own build cache, makes (once per checkout) the
configuration's index, and makes the run's inputs from the seed.  The window
then runs the cell's invocation back to back, each in a fresh process
(``benchmark/child.py``), as users run ``emsar-torch`` and
``emsar-build-torch``: one per sample, study or index, until ``--seconds``
have passed; the last one runs to its end.  After the window the outputs of
every invocation are held to the plain reference.  The last line of
standard output is the result; the numbers compared, each beside its limit,
end standard error.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and ``limits/<cell>.json``, found by the names in
``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional

T_START = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import child as child_mod  # noqa: E402

CACHE = os.path.join(HERE, "_cache")
WORK = os.path.join(HERE, "_work")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    config_path: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclasses.dataclass
class Invocation:
    wall_s: float
    reads: int
    record: dict
    ok: bool
    why: str
    out_dir: str
    inputs: int  # which of the run's inputs it ran on


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    setup_s: float
    window_s: float
    invocations: List[Invocation]
    facts: dict  # sizes the readers need (a build's forward length)


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, root: str = ROOT) -> Cell:
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    w = next((w for w in spec["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    config_path = os.path.join(root, conf["file"])

    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name=name, chips=w["chips"], config=_load_json(config_path),
                config_path=config_path,
                traffic=_load_json(os.path.join(
                    HERE, "traffic", w["traffic"] + ".json")),
                limits=_load_json(os.path.join(HERE, "limits",
                                               name + ".json")),
                end_to_end=e2e, per_layer=layer)


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child_env(device: str) -> dict:
    """The environment of every process the run starts: the program's
    device, and every kernel cache at a fixed place inside the checkout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["EMSAR_TORCH_DEVICE"] = device
    env["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    env["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    env["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
    env["USE_FLAX"] = "0"
    return env


class Harness:
    """Runs a cell's processes; ``child`` is the command that starts one
    invocation (tests put a program with a planted fault there)."""

    def __init__(self, device: str = "cuda", child: Optional[list] = None,
                 work: str = WORK):
        self.device = device
        self.env = child_env(device)
        self.child = child or [sys.executable, "-m", "benchmark.child"]
        self.work = work
        self.n = 0

    def call(self, entry: str, args: List[str], trace: bool = False):
        """(wall seconds, exit code, record) of one process."""
        self.n += 1
        rec = os.path.join(self.work, f"record{self.n:03d}.json")
        log = os.path.join(self.work, f"log{self.n:03d}.txt")
        t0, launch = time.perf_counter(), time.time()
        ru0 = resource.getrusage(resource.RUSAGE_CHILDREN)
        with open(log, "wb") as fh:
            rc = subprocess.run(
                [*self.child, rec, "1" if trace else "0", entry, *args],
                cwd=ROOT, env=self.env, stdout=fh,
                stderr=subprocess.STDOUT).returncode
        wall = time.perf_counter() - t0
        ru1 = resource.getrusage(resource.RUSAGE_CHILDREN)
        record = _load_json(rec) if os.path.exists(rec) else {}
        record.update(log=log, launch=launch, exit=launch + wall,
                      cpu_s=ru1.ru_utime + ru1.ru_stime - ru0.ru_utime
                      - ru0.ru_stime)
        # a traced process starts the profiler before the CLI and reads its
        # trace after: neither is the invocation's
        tracing = record.get("after_s", 0.0) + (
            record["main_start"] - record["imported"]
            if "main_start" in record else 0.0)
        return wall - tracing, rc, record

    def script(self, module: str, *args: str) -> None:
        """A set-up step in a process of its own, so that this process
        holds no CUDA context while the window runs."""
        subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                       env=self.env, check=True)


def tail(path: str, n: int = 2000) -> str:
    with open(path, "rb") as fh:
        return fh.read()[-n:].decode(errors="replace")


def setup(h: Harness, cell: Cell, seed: int) -> dict:
    """Build the kernels and make the run's inputs: a list of invocations'
    arguments to cycle through, and what the reference needs."""
    wall, rc, rec = h.call("build_kernels", [])
    if rc != 0:
        raise RuntimeError("kernel build failed:\n" + tail(rec["log"]))
    from benchmark import data

    t = cell.traffic
    c = cell.config
    if t["mode"] == "build":
        fa = os.path.join(h.work, "transcriptome.fa")
        names, seqs = data.make_transcriptome_fasta(c, seed, fa)
        return {"names": names, "seqs": seqs,
                "borderpos": sum(len(s) for s in seqs) + len(seqs) - 1,
                "argv": lambda k, out: [fa, str(c["read_length"]), out,
                                        "idx"],
                "inputs": 1, "reads": 0}
    paths = data.config_paths(c, cell.config_path)
    if not all(os.path.exists(p) for p in paths.values()):
        h.script("benchmark.data", cell.config_path, h.device)
    n_inputs = t["distinct_inputs"]
    per = t["samples_per_invocation"]
    files = data.make_samples(
        paths["structure"], c["read_length"], c["reads_per_sample"],
        t["abundance_sigma"], t["profile_seed"], seed, n_inputs * per,
        h.work, workers=min(8, os.cpu_count() or 1),
        minus=data.minus_share(c))
    groups = [files[k * per:(k + 1) * per] for k in range(n_inputs)]
    lists = []
    for k, g in enumerate(groups):
        if per == 1:
            lists.append(g[0])
        else:
            lst = os.path.join(h.work, f"study{k}.list")
            with open(lst, "w") as fh:
                fh.write("\n".join(g) + "\n")
            lists.append(lst)

    def argv(k, out):
        return [*t["args"], "-I", paths["rsh"], out, "s", lists[k]]
    return {"paths": paths, "groups": groups, "argv": argv,
            "inputs": n_inputs, "reads": per * c["reads_per_sample"]}


def window(h: Harness, cell: Cell, s: dict, seconds: float,
           trace: bool) -> tuple:
    t = cell.traffic
    entry = "emsar_build" if t["mode"] == "build" else "emsar"
    invs: List[Invocation] = []
    t0 = time.perf_counter()
    while not invs or time.perf_counter() - t0 < seconds:
        k = len(invs) % s["inputs"]
        out = os.path.join(h.work, f"out{len(invs):03d}")
        wall, rc, rec = h.call(entry, s["argv"](k, out), trace)
        names = [p[0] for p in rec.get("phases", [])]
        why = ""
        if rc != 0:
            why = f"exit code {rc}"
        for need in t.get("require_phases", []):
            if need not in names:
                why = why or f"no phase {need!r}"
        for bad in t.get("forbid_phases", []):
            if bad in names:
                why = why or f"phase {bad!r} ran"
        invs.append(Invocation(wall_s=wall, reads=s["reads"], record=rec,
                               ok=not why, why=why, out_dir=out, inputs=k))
        if t["mode"] == "build":
            # a build's .npz sidecar is not compared: keep the disk small
            for f in os.listdir(out) if os.path.isdir(out) else []:
                if f.endswith(".npz"):
                    os.remove(os.path.join(out, f))
    return invs, time.perf_counter() - t0


def check_quant(cell: Cell, s: dict, invs: List[Invocation], device,
                refs: Optional[dict] = None) -> Dict[str, float]:
    """The worst of each number over every sample of every invocation
    (``refs``: the samples' references, kept across calls)."""
    from benchmark import data, refbuild, refquant

    index = refbuild.Index.load(s["paths"]["index"])
    refs = {} if refs is None else refs
    worst: Dict[str, float] = {}
    for inv in invs:
        if not inv.ok:
            continue
        for i, f in enumerate(s["groups"][inv.inputs]):
            if f not in refs:
                refs[f] = refquant.Reference(
                    index, data.load_alignments(f), device)
            nums = refquant.judge(
                refs[f], os.path.join(inv.out_dir, f"s.{i}.fpkm"),
                os.path.join(inv.out_dir, f"s.{i}.fraglength_effect"))
            for k, v in nums.items():
                worst[k] = max(worst.get(k, v), v)
    return worst


def check_build(cell: Cell, s: dict, invs: List[Invocation], device
                ) -> Dict[str, float]:
    from benchmark import refbuild

    c = cell.config
    ref = refbuild.build(s["seqs"], s["names"], c["read_length"], device,
                         unstranded=c["strand"] == "ns",
                         max_repeat=c["max_repeat"]).rsh_text().split(b"\n")
    worst = 0
    for inv in invs:
        if not inv.ok:
            continue
        with open(os.path.join(inv.out_dir, "idx.rsh"), "rb") as fh:
            got = fh.read().split(b"\n")
        worst = max(worst, abs(len(got) - len(ref)) + sum(
            a != b for a, b in zip(got, ref)))
    return {"rsh_lines_differ": float(worst)}


def breakdown(run: Run) -> dict:
    """The device operations that took most time, and the device's idle
    time by what the host was doing: starting a process, importing, a phase
    of the CLI (or outside every phase), exiting, between processes."""
    ops: Dict[str, float] = {}
    idle: Dict[str, float] = {"between processes": run.window_s}
    for inv in run.invocations:
        r = inv.record
        idle["between processes"] -= r["exit"] - r["launch"]
        if "main_start" not in r:
            continue
        for k, v in (("process start", r["enter"] - r["launch"]),
                     ("imports", r["imported"] - r["enter"]),
                     ("profiler start", r["main_start"] - r["imported"]),
                     ("exit", r["exit"] - r["main_end"] - r["after_s"])):
            idle[k] = idle.get(k, 0.0) + v
        tr = r.get("trace", {})
        for k, v in tr.get("by_name", {}).items():
            ops[k] = ops.get(k, 0.0) + v
        for k, v in tr.get("idle_by_phase", {}).items():
            idle[k] = idle.get(k, 0.0) + v

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             harness: Optional[Harness] = None,
             t_start: Optional[float] = None) -> dict:
    """One run; returns the result line's object.  Set-up is timed from
    ``t_start`` (the harness process's start), else from this call."""
    t_start = time.perf_counter() if t_start is None else t_start
    h = harness or Harness()
    shutil.rmtree(h.work, ignore_errors=True)
    os.makedirs(h.work)
    try:
        s = setup(h, cell, seed)
        setup_s = time.perf_counter() - t_start
        invs, window_s = window(h, cell, s, seconds, trace)
        run = Run(cell=cell, setup_s=setup_s, window_s=window_s,
                  invocations=invs,
                  facts={"borderpos": s.get("borderpos")})
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            v = metric_reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        peak = max((i.record.get("peak_bytes", 0) for i in invs), default=0)
        kinds = {i.record["device"] for i in invs if "device" in i.record}

        import torch
        dev = torch.device(h.device)
        t_check = time.perf_counter()
        if cell.traffic["mode"] == "build":
            nums = check_build(cell, s, invs, dev)
        else:
            nums = check_quant(cell, s, invs, dev)
        print(f"reference and comparison: "
              f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
        print("invocations (wall s, host CPU s): " + ", ".join(
            f"{i.wall_s:.2f} {i.record['cpu_s']:.2f}" for i in invs),
            file=sys.stderr)
        failed = sum(not i.ok for i in invs)
        checks = {k: {"value": nums.get(k, float("inf")), "limit": lim}
                  for k, lim in cell.limits.items()}
        banned = sorted({b for i in invs for b in i.record.get("banned", [])})
        correct = (failed == 0 and not banned and
                   all(c["value"] <= c["limit"] for c in checks.values()))
        out = {"correct": correct, "attempted": len(invs), "failed": failed,
               "metrics": metrics,
               "device": {"platform": "gpu" if h.device.startswith("cuda")
                          else h.device,
                          "kind": ",".join(sorted(kinds)),
                          "count": cell.chips, "memory_peak_bytes": peak}}
        if trace:
            out["device"]["busy_s"] = sum(
                i.record.get("trace", {}).get("busy_s", 0.0) for i in invs)
            out["device"]["window_s"] = window_s
            out["breakdown"] = breakdown(run)
        for i in invs:
            if not i.ok:
                print(f"invocation failed ({i.why}):\n{tail(i.record['log'])}",
                      file=sys.stderr)
        if banned:
            print(f"an invocation loaded {', '.join(banned)}",
                  file=sys.stderr)
        out["checks"] = checks
        return out
    finally:
        shutil.rmtree(h.work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    found = importlib.util.find_spec("emsar_tpu_torch")
    if found is None or not (found.origin or "").startswith(ROOT + os.sep):
        print("the program (emsar_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return 3
    cell = load_cell(a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = run_cell(cell, a.seed, a.seconds, bool(a.trace), t_start=T_START)
    banned = child_mod.banned_modules()
    if banned:
        print(f"this process loaded {', '.join(banned)}", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
