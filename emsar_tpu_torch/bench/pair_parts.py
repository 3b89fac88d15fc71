"""``pair_gain``'s builds on the card: the default build of
``csrc/csr_cycle.cu`` (each thread loads its edges' tids and weights, each
folding thread its segment's group ends, from device memory) against the
build that stages a tile's tids, weights and group ends in shared memory
by TMA bulk copies onto an mbarrier (``-DEMSAR_PAIR_TMA=1``), each for
tiles of each size of ``--tiles`` (``-DEMSAR_PAIR_TILE``, the grouping's
tiles ``segment_sum.tile_bounds`` at that size), at the shapes of
``bench/cycle_ab.py``:

    python3 -m emsar_tpu_torch.bench.pair_parts [--large]
        [--tiles 512,256,128] [--rsh R] [--aln A]
        [--out bench_cache/pair_parts.json]

Device ms a call from a cold L2 (``kernels.measure.device_ms_cold``) of
the gain terms alone and with both intensities (a block's last cycle),
beside the bound (``cycle_ab.kernel_bounds``).  Every build's outputs
must be bit-equal to the package's ``csr_cycle.pair_gain``; the script
raises otherwise.  A measurement tool: the builds (one nvcc each, all
started together) go to ``emsar_tpu_torch/_build/parts/`` and are used
nowhere else.  Prints one JSON object (with the card's name and power
limit) and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import os

import torch

from . import write_result
from .cluster_sweep import card
from .cycle_ab import cases, cycle_inputs, kernel_bounds, side_inputs
from ..kernels import _build, csr_cycle, measure
from ..kernels import segment_sum as ss
from ..model import solver
from ..parallel import mesh


def build(variants: dict) -> dict:
    """{name: ctypes library} of {name: (tma, tile)}, built from
    csr_cycle.cu with the package's nvcc flags, all at once."""
    libs = _build.build_variants(csr_cycle.SOURCE, {
        f"pair {name}": (f"-DEMSAR_PAIR_TMA={int(tma)}",
                         f"-DEMSAR_PAIR_TILE={tile}")
        for name, (tma, tile) in variants.items()})
    return {name: csr_cycle.bind(libs[f"pair {name}"]) for name in variants}


def pair_call(lib, tile: int, p, t2, cand, intensities: bool):
    """A call of ``lib``'s pair_gain over ``p``'s by-cid grouping cut in
    tiles of ``tile``: returns (call, its outputs)."""
    g = p.by_cid
    tiles = ss.tile_bounds(g.offsets, tile)
    R, C = cand.shape[0], g.n_groups
    out = torch.empty((R, C), dtype=cand.dtype, device=cand.device)
    s_pair = ((torch.empty_like(out), torch.empty_like(out)) if intensities
              else (None, None))
    fn = (lib.emsar_pair_gain_f64 if cand.dtype == torch.float64
          else lib.emsar_pair_gain_f32)
    a_stride = C if p.reads.dim() == 2 else 0
    stream = torch.cuda.current_stream(cand.device).cuda_stream

    def call():
        rc = fn(t2.data_ptr(), cand.data_ptr(), g.mult.data_ptr(),
                g.idx.data_ptr(), g.offsets.data_ptr(), tiles.data_ptr(),
                p.reads.data_ptr(), p.eumaps.data_ptr(),
                *(None if t is None else t.data_ptr() for t in s_pair),
                out.data_ptr(), R, C, g.n_x, a_stride, tiles.shape[1] - 1,
                tile, stream)
        if rc != 0:
            raise RuntimeError(f"pair_gain launch failed: CUDA error {rc}")
    outs = (out, *s_pair) if intensities else (out,)
    return call, outs


def _bits_equal(a, b) -> bool:
    return all(torch.equal(x.view(torch.int64 if x.dtype == torch.float64
                                  else torch.int32),
                           y.view(torch.int64 if y.dtype == torch.float64
                                  else torch.int32))
               for x, y in zip(a, b))


def run(dev, all_cases: dict, tiles, log=print) -> dict:
    """Every case: every build's pair_gain bit-equal to the package's, and
    each build's device and host ms (cold L2) with and without the
    intensities.  Returns {case: what it measured}."""
    variants = {f"{way} {t}": (way == "tma", t)
                for t in tiles for way in ("direct", "tma")}
    libs = build(variants)
    result = {}
    for name, case in all_cases.items():
        p, th = side_inputs(solver, mesh, case, dev)
        v = cycle_inputs(p, th)
        t2, cand = v["t2"], v["cand"]
        bounds = kernel_bounds(p, th.shape[0])
        want = {False: (csr_cycle.pair_gain(p.by_cid, p.reads, p.eumaps, t2,
                                            cand),),
                True: csr_cycle.pair_gain(p.by_cid, p.reads, p.eumaps, t2,
                                          cand, intensities=True)}
        entry = {"rows": th.shape[0], "edges": int(p.by_cid.idx.shape[0]),
                 "segments": p.by_cid.n_groups,
                 "bound_ms": {k: bounds[k][0] for k in (
                     "pair_gain", "pair_gain intensities")}, "ms": {}}
        for vname, (_, tile) in variants.items():
            for intensities in (False, True):
                call, outs = pair_call(libs[vname], tile, p, t2, cand,
                                       intensities)
                call()
                torch.cuda.synchronize()
                if not _bits_equal(outs, want[intensities]):
                    raise AssertionError(f"{name} {vname}: pair_gain differs "
                                         f"from the package's")
                key = vname + (" intensities" if intensities else "")
                host = measure.host_ms(call, 50)
                entry["ms"][key] = {
                    "ms": measure.device_ms_cold(call, host_per_call_ms=host),
                    "host_ms": host}
        result[name] = entry
        log(f"[pair_parts] {name} (E={entry['edges']}, R={entry['rows']}): "
            + ", ".join(f"{k} {m['ms']:.5f} ms"
                        for k, m in entry["ms"].items())
            + f"; bounds {entry['bound_ms']}")
        del p, th, v
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--large", action="store_true",
                    help="also the cluster sweep's largest problem")
    ap.add_argument("--tiles", default=f"{ss.TILE},256,128")
    cache = os.path.join("bench_cache", "torch_smoke")
    ap.add_argument("--rsh", default=os.path.join(cache, "smoke.rsh"))
    ap.add_argument("--aln", default=os.path.join(cache, "smoke.bowtieout"))
    ap.add_argument("--out", default=os.path.join("bench_cache",
                                                  "pair_parts.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pair_parts: needs a CUDA device")
    dev = torch.device("cuda")
    tiles = [int(t) for t in args.tiles.split(",")]
    write_result({"card": card(), "tiles": tiles,
                  "cases": run(dev, cases(args.rsh, args.aln, args.large),
                               tiles)}, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
