#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (emsar_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a), nvcc and a checkout of this repository; it
imports nothing of JAX.  Phases, each of which raises on failure (non-zero
exit, no result line):

1. torch version, the card's name and power limit (nvidia-smi).
2. Build the hand-written CUDA kernel from csrc/ (nvcc, sm_90a).
3. Kernel against its plain PyTorch version on the card: every size class
   x {float32, float64}, on padded batches of a real gene-family index
   and on random modules; max error and median CUDA-event times.
4. Fixture (cached under bench_cache/torch_smoke/): the SE bench workload,
   a 2000-gene family transcriptome (~12k transcripts, ~15 Mbp), SE l50
   .rsh from the port's NumPy builder, 1M simulated reads as bowtie lines.
5. The main path, ``emsar -I idx.rsh out s aln`` through the port's CLI:
   with --solver_pallas (the kernel; its launch count must be > 0), in
   float32 with the kernel, with the torch.bmm dense path, and with
   --solver_mode csr.  The .fpkm files must agree: logL (from each file's
   FPKM) within rel 1e-9 (1e-7 for float32), gene-level inferred read
   counts within 1e-3, gene-level TPM within rel 1e-3 (5e-3 for float32)
   of max(TPM, 1), .fraglength_effect byte-equal.
6. Kernel against plain version at the main path's shapes (its dense
   batches, float64): max abs error and times.

The last lines are the kernels JSON, the card line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, "bench_cache", "torch_smoke")
N_GENES = 2000
READLEN = 50
N_READS = 1_000_000
SEED = 1234
N_ITERS = 8
KERNEL = {"name": "squarem_block", "route": "cuda",
          "source": "emsar_tpu_torch/csrc/squarem_block.cu",
          "replaces": "emsar_tpu/model/dense.py:333"}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` between CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def gene_family_batches(n_genes: int, seed: int, dtypes):
    """{dtype: padded dense batches} of a real gene-family index (port
    builder) with Poisson read counts."""
    import numpy as np

    from emsar_tpu.config import BuildConfig
    from emsar_tpu.io.fasta import build_transcriptome
    from emsar_tpu.model.modules import build_segment_graph
    from emsar_tpu.sim import gene_family_transcriptome
    from emsar_tpu_torch.index.build import build_se_index
    from emsar_tpu_torch.model.dense import partition_modules
    from emsar_tpu_torch.model.quantify import index_modules

    rng = np.random.default_rng(seed)
    names, seqs, _ = gene_family_transcriptome(rng, n_genes)
    idx = build_se_index(build_transcriptome(names, seqs), READLEN, READLEN,
                         BuildConfig(verbose=0))
    adj = np.concatenate([idx.single_euma[:, 0], idx.multi_euma[:, 0]])
    rc = rng.poisson(adj * 0.5).astype(np.int64)
    graph = build_segment_graph(idx, adj.astype(np.float64), rc)
    eumaps = adj / 1e3 * (rc.sum() / 1e6)
    mods = index_modules(idx)
    return {dt: partition_modules(graph, mods, eumaps, rc, dtype=dt).batches
            for dt in dtypes}


def phase_kernel_check(dev) -> float:
    """Kernel vs plain version on the card, every class x dtype.  Returns
    the largest relative error seen."""
    import numpy as np
    import torch

    from emsar_tpu_torch.kernels import squarem
    from emsar_tpu_torch.kernels.check import (block_agreement, block_tol,
                                               random_modules)
    from emsar_tpu_torch.model.dense import (SIZE_CLASSES, _theta0,
                                             batch_to_device)

    worst = 0.0
    dtypes = ((np.float32, torch.float32), (np.float64, torch.float64))
    batches = gene_family_batches(300, 7, [d for d, _ in dtypes])
    for np_dt, dt in dtypes:
        real = {b.shape[1:]: b for b in batches[np_dt]}
        for C, T in SIZE_CLASSES:
            cases = []
            if (C, T) in real:
                db = batch_to_device(real[(C, T)], dev, dt)
                cases.append(("gene-family", [db.m, db.eumaps, db.reads,
                                              db.inv_denom, _theta0(db)]))
            rng = np.random.default_rng(C * T)
            cases.append(("random", [torch.as_tensor(a).to(dev, dt) for a
                                     in random_modules(rng, 256, C, T)]))
            for (kind, args), n_it in itertools.product(cases, (1, N_ITERS)):
                got = squarem.squarem_block(*args, n_it)
                torch.cuda.synchronize()
                want = squarem.squarem_block_ref(*args, n_it)
                if not torch.isfinite(got).all():
                    raise AssertionError(f"non-finite kernel output "
                                         f"({C},{T}) {dt} {kind}")
                err, _, n = block_agreement(got, want, *args, n_it)
                tol = block_tol(dt, n_it)
                k_ms = cuda_ms(lambda: squarem.squarem_block(*args, n_it))
                p_ms = cuda_ms(lambda: squarem.squarem_block_ref(*args, n_it),
                               reps=5)
                log(f"kernel check ({C},{T}) {str(dt)[6:]} {kind} "
                    f"B={args[0].shape[0]} cycles={n_it}: max rel diff "
                    f"{err:.3e} over {n} modules (tol {tol:g}); kernel "
                    f"{k_ms:.4f} ms, plain {p_ms:.4f} ms")
                if n < args[0].shape[0] // 4 or err > tol:
                    raise AssertionError(
                        f"kernel disagrees with its plain version at "
                        f"({C},{T}) {dt} {kind}: {err:.3e} over {n}")
                worst = max(worst, err)
    return worst


def ensure_fixture(n_genes: int = N_GENES, n_reads: int = N_READS,
                   cache: str = CACHE):
    """(rsh, aln) of the SE bench workload, built with the port's host
    tools and cached.  Alignment lines follow bench.py's writer: every
    member of the read's window group, strand from the canonical flags."""
    import numpy as np

    from emsar_tpu.config import BuildConfig
    from emsar_tpu.index import pack
    from emsar_tpu.io.fasta import build_transcriptome
    from emsar_tpu.sim import gene_family_transcriptome, simulate_fragments
    from emsar_tpu_torch.index.build import build_se_index, se_group

    os.makedirs(cache, exist_ok=True)
    rsh = os.path.join(cache, "smoke.rsh")
    aln = os.path.join(cache, "smoke.bowtieout")
    if os.path.exists(rsh) and os.path.exists(aln):
        return rsh, aln
    rng = np.random.default_rng(SEED)
    names, seqs, _ = gene_family_transcriptome(rng, n_genes)
    tx = build_transcriptome(names, seqs)
    t0 = time.perf_counter()
    build_se_index(tx, READLEN, READLEN, BuildConfig(verbose=0)).write_text(
        rsh + ".tmp")
    log(f"fixture: {tx.n_transcripts} transcripts, {tx.borderpos} bp, "
        f".rsh in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rl = READLEN
    p16 = pack.pack16(tx.codes)
    bad = pack.bad_prefix(tx.codes)
    pos = np.arange(0, tx.borderpos - rl + 1, dtype=np.int64)
    pos = pos[pack.valid_windows(bad, pos, rl)]
    spos, run_id, sflag = se_group(p16, pos, tx.seqlength, rl, False)
    run_of = np.empty(tx.borderpos, dtype=np.int64)
    run_of[spos] = run_id
    flag_of = np.zeros(tx.borderpos, dtype=bool)
    flag_of[spos] = sflag
    order = np.argsort(run_id, kind="stable")
    members = spos[order]
    counts = np.bincount(run_id)
    offsets = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    tids = tx.transcript_of(members, rl)
    tpos = members - tx.cuml[tids]
    mflag = flag_of[members]
    frag = simulate_fragments(tx, rl, n_reads, rng)
    seqstr = tx.seq.tobytes()
    with open(aln + ".tmp", "w", buffering=1 << 22) as fh:
        for i, p in enumerate(frag):
            if p < tx.borderpos:
                fwpos = p
                r_is_canon = flag_of[p]
            else:
                fwpos = tx.seqlength - p - rl
                r_is_canon = not flag_of[fwpos]
            run = run_of[fwpos]
            sl = slice(offsets[run], offsets[run + 1])
            srun = seqstr[p:p + rl].decode()
            # the sequence column is read only for its length
            for tid_, q, fl in zip(tids[sl], tpos[sl], mflag[sl]):
                strand = "+" if (fl == r_is_canon) else "-"
                fh.write(f"r{i}\t{strand}\t{names[tid_]}\t{q}\t{srun}"
                         f"\tI\t0\t\n")
    os.replace(rsh + ".tmp", rsh)
    os.replace(aln + ".tmp", aln)
    log(f"fixture: {n_reads} reads as bowtie lines in "
        f"{time.perf_counter() - t0:.1f} s")
    return rsh, aln


def _parse_fpkm(path):
    import numpy as np
    names, cols = [], []
    with open(path) as fh:
        next(fh)
        for line in fh:
            f = line.rstrip("\n").split("\t")
            names.append(f[0])
            cols.append([float(x) for x in f[1:]])
    return names, np.array(cols)


def _gene_sum(names, values):
    """Per-gene sums (transcripts are named G<gene>T<isoform>)."""
    import numpy as np
    genes = np.array([n.split("T")[0] for n in names])
    _, inv = np.unique(genes, return_inverse=True)
    return np.bincount(inv, weights=values)


RUNS = (("kernel", ["--solver_pallas"]),
        ("kernel_f32", ["--solver_pallas", "--solver_dtype", "float32"]),
        ("bmm", []),
        ("csr", ["--solver_mode", "csr"]))


def phase_main_path(rsh: str, aln: str, out_root: str):
    """Drive ``emsar -I`` through the port's CLI once per RUNS entry and
    check the outputs against each other.  Returns (launches of the
    float64 kernel run, {run: phase seconds}, the sample's inputs)."""
    import numpy as np

    from emsar_tpu.config import QuantConfig
    from emsar_tpu.ingest import native as native_mod
    from emsar_tpu.io.rsh import RshIndex
    from emsar_tpu.utils.timing import phase_times, reset_phases
    from emsar_tpu_torch.cli import emsar as cli
    from emsar_tpu_torch.kernels import squarem
    from emsar_tpu_torch.model.quantify import _host_loglik, prepare_sample
    from emsar_tpu_torch.model.solver import build_problem

    log(f"native C++ ingest available: {native_mod.available()}")
    launches, seconds, lls, tpms, ircs, fl_bytes = {}, {}, {}, {}, {}, {}
    names0 = None
    for name, flags in RUNS:
        out = os.path.join(out_root, name)
        reset_phases()
        squarem.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli.main(["-q"] + flags + ["-I", rsh, out, "s", aln])
        wall = time.perf_counter() - t0
        launches[name] = squarem.LAUNCHES
        if rc != 0:
            raise AssertionError(f"run {name} exited {rc}")
        seconds[name] = dict(phase_times(), total=wall)
        names, cols = _parse_fpkm(os.path.join(out, "s.0.fpkm"))
        if not np.isfinite(cols).all():
            raise AssertionError(f"run {name}: non-finite .fpkm values")
        if names0 is None:
            names0 = names
            index = RshIndex.load(rsh)
            cfg = QuantConfig(verbose=0, min_fraglength=index.min_fraglength,
                              max_fraglength=index.max_fraglength)
            counts = native_mod.NativeCollapser(index).collapse_file(
                aln, "bowtie", False, 0, cfg.max_repeat, cfg.min_fraglength,
                cfg.max_fraglength) if native_mod.available() else \
                cli._collapse_python(index, {n: i for i, n in
                                             enumerate(index.names)},
                                     cfg, aln, [-1])
            x = prepare_sample(index, counts, cfg)
            problem = build_problem(x.graph, x.modules, x.eumaps,
                                    x.read_count)
        if names != names0 or cols.shape != (len(names0), 6):
            raise AssertionError(f"run {name}: unexpected .fpkm layout")
        lls[name] = _host_loglik(problem, cols[:, 0])
        tpms[name] = _gene_sum(names, cols[:, 5])
        ircs[name] = _gene_sum(names, cols[:, 3])
        with open(os.path.join(out, "s.0.fraglength_effect"), "rb") as fh:
            fl_bytes[name] = fh.read()
        log(f"run {name}: {wall:.2f} s, logL {lls[name]!r}, kernel "
            f"launches {launches[name]}, phases "
            + ", ".join(f"{k} {v:.3f}" for k, v in seconds[name].items()))
    for name, _ in RUNS:
        if name.startswith("kernel") and launches[name] <= 0:
            raise AssertionError(f"run {name} never launched the kernel")
    # EM approaches an isoform whose ML abundance is 0 sublinearly, so the
    # paths stop at the same 1e-9 logL gain with such isoforms at different
    # small FPKM; EM keeps each module's read total, so that mass moves to
    # the gene's other isoforms of other effective lengths.  Gene TPM then
    # differs by ~1e-4 relative (more in float32), gene read counts barely.
    ref = "kernel"
    failed = []
    for name, _ in RUNS:
        # the float32 solve stops at its 1e-5 gain floor and relies on the
        # 200-cycle host f64 polish: held to looser bounds
        f32 = name.endswith("f32")
        ll_tol = 1e-7 if f32 else 1e-9
        tpm_tol = 5e-3 if f32 else 1e-3
        rel = abs(lls[name] - lls[ref]) / abs(lls[ref])
        d_irc = float(np.abs(ircs[name] - ircs[ref]).max())
        d_tpm = np.abs(tpms[name] - tpms[ref])
        d_tpm_rel = d_tpm / np.maximum(tpms[ref], 1.0)
        g = int(np.argmax(d_tpm))
        same_fl = fl_bytes[name] == fl_bytes[ref]
        log(f"{name} vs {ref}: logL rel diff {rel:.3e} (tol {ll_tol:g}), "
            f"gene iReadcount max abs diff {d_irc:.3e} (tol 1e-3), "
            f"gene TPM max abs diff {d_tpm.max():.3e} (at TPM "
            f"{tpms[ref][g]:.3f}), max rel diff {d_tpm_rel.max():.3e} "
            f"(tol {tpm_tol:g}), .fraglength_effect equal {same_fl}")
        if (rel > ll_tol or d_irc > 1e-3 or d_tpm_rel.max() > tpm_tol
                or not same_fl):
            failed.append(name)
    if failed:
        raise AssertionError(f"runs {failed} disagree with {ref}")
    return launches["kernel"], seconds, x


def phase_main_path_shapes(x, dev):
    """Kernel vs plain version on the main path's own dense batches
    (float64, one block from the read-attribution start).  ``x`` is the
    sample's ``prepare_sample`` result.  Returns (max abs err, kernel ms,
    plain ms) summed over the batches."""
    import numpy as np
    import torch

    from emsar_tpu_torch.kernels import squarem
    from emsar_tpu_torch.kernels.check import block_agreement, block_tol
    from emsar_tpu_torch.model.dense import (_theta0, batch_to_device,
                                             partition_modules)

    part = partition_modules(x.graph, x.modules, x.eumaps, x.read_count,
                             dtype=np.float64)
    max_abs, k_total, p_total = 0.0, 0.0, 0.0
    for batch in part.batches:
        db = batch_to_device(batch, dev, torch.float64)
        args = [db.m, db.eumaps, db.reads, db.inv_denom, _theta0(db)]
        got = squarem.squarem_block(*args, N_ITERS)
        want = squarem.squarem_block_ref(*args, N_ITERS)
        err, diff, n = block_agreement(got, want, *args, N_ITERS)
        k_ms = cuda_ms(lambda: squarem.squarem_block(*args, N_ITERS))
        p_ms = cuda_ms(lambda: squarem.squarem_block_ref(*args, N_ITERS),
                       reps=5)
        log(f"main-path batch {batch.shape}: max rel diff {err:.3e} over "
            f"{n} modules, max abs diff {diff:.3e}; kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms per {N_ITERS}-cycle block")
        if err > block_tol(torch.float64, N_ITERS):
            raise AssertionError(f"kernel disagrees on batch {batch.shape}")
        max_abs = max(max_abs, diff)
        k_total += k_ms
        p_total += p_ms
    if not part.batches:
        raise AssertionError("the fixture produced no dense batches")
    return max_abs, k_total, p_total


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "emsar_tpu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository (emsar_tpu_torch/ not found)")
    sys.path.insert(0, REPO)
    import torch

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs on the GPU only")
    log(f"card: {card_line()}")
    os.environ["EMSAR_TORCH_DEVICE"] = "cuda"
    from emsar_tpu_torch.device import resolve_device
    from emsar_tpu_torch.kernels import _build, squarem
    dev = resolve_device()

    t0 = time.perf_counter()
    squarem.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    log_path = _build.library_path(squarem.SOURCE) + ".log"
    if os.path.exists(log_path):
        with open(log_path) as fh:
            for ln in fh.read().splitlines():
                if "registers" in ln or "spill" in ln or "smem" in ln:
                    log(f"ptxas: {ln.strip()}")

    t0 = time.perf_counter()
    worst = phase_kernel_check(dev)
    log(f"kernel check: {time.perf_counter() - t0:.1f} s, worst rel diff "
        f"{worst:.3e}")

    t0 = time.perf_counter()
    rsh, aln = ensure_fixture()
    log(f"fixture: {time.perf_counter() - t0:.1f} s")

    out_root = os.path.join(CACHE, "out")
    launches, seconds, sample = phase_main_path(rsh, aln, out_root)
    max_abs, k_ms, p_ms = phase_main_path_shapes(sample, dev)

    print(json.dumps({"kernels": [dict(KERNEL, launches=launches,
                                       max_abs_err=max_abs, ms=k_ms,
                                       plain_ms=p_ms)]}))
    print(json.dumps({"phase_seconds": seconds}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
