"""Where the time of a cluster kernel launch goes, on the card: variants of
``csrc/csr_cluster.cu`` made from its text, timed at the smoke fixture's
CSR shape (R 1, float64, the plan ``solver.cycle_plan`` makes):

    python3 -m emsar_tpu_torch.bench.cluster_parts [--rsh R] [--aln A]
        [--edges N] [--cluster CL] [--threads 1024,512,256] [--full]
        [--out bench_cache/cluster_parts.json]

``--edges N``: a problem of the cluster sweep (``cluster_sweep.
random_problem``) instead of the smoke's; ``--cluster CL``: a plan forced
to clusters of CL blocks (as many tiles as the card holds such clusters,
doubled until a block's share fits).  The variants:

* cluster_em_pair stopped at each of its barriers of the whole cluster:
  every block returns right after the barrier (all blocks of a cluster
  pass it, so none reads a block that has gone): "launch" returns at
  once, "staged" after the staging's barrier (the image's bulk copy and
  the gathers), "pass 1" to "pass 3" after that pass's barrier, "full" is
  the kernel;
* both kernels whole at each block size of ``--threads``
  (``-DEMSAR_CLUSTER_THREADS``; ``--full``: only these);
* both kernels with every cluster barrier (barrier.cluster, where a
  cluster is more than one block) twice ("doubled barriers": the
  difference is that many barriers' cost).

Device ms a call (``kernels.measure.device_ms``, the outputs allocated
once).  A measurement tool: the variants are built (one nvcc each, all
started together) into ``emsar_tpu_torch/_build/parts/`` and used
nowhere else.  Prints one JSON object (with the card's name and power
limit) and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import subprocess

import numpy as np
import torch

from . import cluster_sweep, smoke_sample, write_result
from .cluster_sweep import card
from ..kernels import _build, csr_cluster, measure
from ..model import solver

STOPS = ("launch", "staged", "pass 1", "pass 2", "pass 3", "full")
# the kernels' barrier of the whole cluster between passes
BARRIER = "sync_all<CL>(cluster);"
PARTS_DIR = os.path.join(_build.BUILD_DIR, "parts")


def variant_source(text: str, stop: str) -> str:
    """csr_cluster.cu with cluster_em_pair returning at ``stop``."""
    start = text.index("cluster_em_pair_kernel(EmPairArgs<F> a) {")
    end = text.index("struct ExtrapGainArgs", start)
    body = text[start:end]
    if stop == "launch":
        at = body.index("cg::this_cluster();") + len("cg::this_cluster();")
    elif stop != "full":
        at = -1
        for _ in range(STOPS.index(stop)):
            at = body.index(BARRIER, at + 1)
        at += len(BARRIER)
    else:
        return text
    return text[:start] + body[:at] + "\n    return;" + body[at:] + text[end:]


def build(variants: dict) -> dict:
    """{name: ctypes library} of {name: (source text, threads)}, built
    with the package's nvcc flags, all at once."""
    os.makedirs(PARTS_DIR, exist_ok=True)

    def one(item):
        name, (text, threads) = item
        stem = os.path.join(PARTS_DIR, name.replace(" ", "_"))
        with open(stem + ".cu", "w") as fh:
            fh.write(text)
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             f"-DEMSAR_CLUSTER_THREADS={threads}", "-o", stem + ".so",
             stem + ".cu"], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        return name, stem + ".so"
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = dict(pool.map(one, variants.items()))
    libs = {}
    for name, so in built.items():
        lib = ctypes.CDLL(so)
        for fn, argtypes in (("emsar_cluster_em_pair_f64",
                              csr_cluster.EM_PAIR_ARGTYPES),
                             ("emsar_cluster_extrap_gain_f64",
                              csr_cluster.EXTRAP_GAIN_ARGTYPES)):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    cache = os.path.join("bench_cache", "torch_smoke")
    ap.add_argument("--rsh", default=os.path.join(cache, "smoke.rsh"))
    ap.add_argument("--aln", default=os.path.join(cache, "smoke.bowtieout"))
    ap.add_argument("--edges", type=int, default=0)
    ap.add_argument("--cluster", type=int, default=0)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--threads", default="1024,512,256")
    ap.add_argument("--out", default=os.path.join("bench_cache",
                                                  "cluster_parts.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cluster_parts: needs a CUDA device")
    dev = torch.device("cuda")
    if args.edges:
        problem = cluster_sweep.random_problem(
            np.random.default_rng(args.edges + 1), args.edges)
    else:
        x = smoke_sample(args.rsh, args.aln)
        problem = solver.build_problem(x.graph, x.modules, x.eumaps,
                                       x.read_count)
    p = solver.problem_to_device(problem, dev, torch.float64)
    theta = torch.as_tensor(solver.read_attribution_start(problem))[None].to(
        dev)
    plan = solver.cycle_plan(p, 1, clusters=True)
    if args.cluster:
        n_tiles = csr_cluster.max_active_clusters(torch.float64, 0,
                                                  args.cluster, dev.index or 0)
        while True:
            plan = csr_cluster.tile_plan(p.by_cid, p.by_tid, n_tiles,
                                         args.cluster)
            if plan.smem <= csr_cluster.SMEM_BYTES:
                break
            n_tiles *= 2
    with open(os.path.join(_build.CSRC_DIR, csr_cluster.SOURCE)) as fh:
        text = fh.read()
    threads = [int(v) for v in args.threads.split(",")]
    variants = {f"full {n}": (text, n) for n in threads}
    if not args.full:
        variants.update({f"em_pair {s}": (variant_source(text, s), threads[0])
                         for s in STOPS[:-1]})
        variants[f"doubled barriers {threads[0]}"] = (text.replace(
            "cluster.sync();", "cluster.sync();\n    cluster.sync();"),
            threads[0])
    libs = build(variants)
    R, T = theta.shape
    C = p.by_cid.n_groups
    outs = [torch.empty_like(theta) for _ in range(4)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    args_plan = plan.args()

    def em_pair(lib):
        def call():
            rc = lib.emsar_cluster_em_pair_f64(
                theta.data_ptr(), None, None, None, *args_plan,
                p.reads.data_ptr(), p.inv_denom.data_ptr(), None,
                *(o.data_ptr() for o in outs), R, T, plan.n_tiles, plan.rows,
                plan.smem, 0, 0, plan.cluster, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        return call
    t1, t2, r_sq, v_sq = outs
    rs = torch.sum(r_sq, dim=1, keepdim=True)
    vs = torch.sum(v_sq, dim=1, keepdim=True)
    cand, terms = torch.empty_like(theta), theta.new_empty((R, C))

    def extrap_gain(lib):
        def call():
            rc = lib.emsar_cluster_extrap_gain_f64(
                theta.data_ptr(), t1.data_ptr(), t2.data_ptr(), rs.data_ptr(),
                vs.data_ptr(), *args_plan, p.reads.data_ptr(),
                p.eumaps.data_ptr(), p.inv_denom.data_ptr(), cand.data_ptr(),
                terms.data_ptr(), R, C, T, plan.n_tiles, plan.rows, plan.smem,
                0, 0, plan.cluster, stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        return call
    # the full kernel first (its outputs feed extrap_gain), then each part
    em_pair(libs[f"full {threads[0]}"])()
    rs.copy_(torch.sum(r_sq, dim=1, keepdim=True))
    vs.copy_(torch.sum(v_sq, dim=1, keepdim=True))
    torch.cuda.synchronize()
    result = {"card": card(), "shape": {"R": R, "C": C, "T": T,
                                        "E": int(p.by_cid.idx.shape[0]),
                                        "tiles": plan.n_tiles,
                                        "cluster": plan.cluster,
                                        "smem": plan.smem}, "ms": {}}
    for name in variants:
        fns = {"cluster_em_pair": em_pair(libs[name])}
        if not name.startswith("em_pair"):
            fns["cluster_extrap_gain"] = extrap_gain(libs[name])
        for k, fn in fns.items():
            ms = measure.device_ms(fn)
            result["ms"][f"{k} {name}"] = ms
            print(f"[cluster_parts] {k} {name}: {ms:.5f} ms", flush=True)
    write_result(result, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
