#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (emsar_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a), nvcc and a checkout of this repository; it
imports nothing of JAX.  Phases, each of which raises on failure (non-zero
exit, no result line):

1. torch version, the card's name and power limit (nvidia-smi).
2. Build the three hand-written CUDA kernels from csrc/ (one nvcc per
   source, all started together; sm_90a); ptxas registers and spills.
3. SQUAREM kernel against its plain PyTorch version on the card: every
   size class x {float32, float64}, on padded batches of a real
   gene-family index and on random modules; max error and median
   CUDA-event times.  Segment-sum kernel against its plain version on
   random CSR problems (rel 1e-12 f64, 1e-5 f32), and bit-identical
   across two launches.
4. Fixture (cached under bench_cache/torch_smoke/): the SE bench workload,
   a 2000-gene family transcriptome (~12k transcripts, ~15 Mbp) as
   smoke.fa, SE l50 .rsh from the port's NumPy builder, 1M simulated reads
   as bowtie lines.  Window-hash kernel against its plain version on that
   transcriptome (l50, both strandednesses): bit-equal lanes and tids.
5. The main path, ``emsar -I idx.rsh out s aln`` through the port's CLI:
   with --solver_pallas (the kernel; its launch count must be > 0), in
   float32 with the kernel, with the torch.bmm dense path, and twice with
   --solver_mode csr (the segment-sum kernel; the two .fpkm files must be
   byte-identical).  The .fpkm files must agree: logL (from each file's
   FPKM) within rel 1e-9 (1e-7 for float32), gene-level inferred read
   counts within 1e-3, gene-level TPM within rel 1e-3 (5e-3 for float32)
   of max(TPM, 1), .fraglength_effect byte-equal.
6. Kernels against plain versions at the main path's shapes: the SQUAREM
   block on its dense batches (float64), the segment sums on its CSR
   problem; max abs error and times.
7. The SE index build on the card: ``emsar-build-torch smoke.fa 50`` must
   write the NumPy builder's smoke.rsh byte for byte (window-hash launch
   count > 0), and ``emsar-torch --solver_pallas -x smoke.fa`` must agree
   with the -I kernel run (logL rel 1e-12, .fraglength_effect equal).
8. The build at scale: the 42,000-gene transcriptome of
   tools/make_scale_fixture.py (~168k transcripts, ~338 Mbp), SE l76
   through ``emsar-build-torch``: wall time, phases, peak device memory,
   n_multi; the .rsh must load back.  Then the window-hash kernel against
   its plain version on all ~337M windows at l76, unstranded and stranded
   (the plain version in chunks): bit-equal lanes and tids, with both
   times.  Then the .rsh against window classes counted apart from the
   builder (``torch.unique`` over the kernel's 96-bit identities): per
   transcript its single counts and its windows in multi records, and the
   class-size histogram, all equal.

The last lines are the kernels JSON, the card line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
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
SCALE_GENES = 42000
SCALE_SEED = 20260820
SCALE_READLEN = 76
KERNELS = {
    "squarem_block": {"name": "squarem_block", "route": "cuda",
                      "source": "emsar_tpu_torch/csrc/squarem_block.cu",
                      "replaces": "emsar_tpu/model/dense.py:333"},
    "segment_sum": {"name": "segment_sum", "route": "cuda",
                    "source": "emsar_tpu_torch/csrc/segment_sum.cu",
                    "replaces": "emsar_tpu/model/solver.py:114"},
    "window_hash": {"name": "window_hash", "route": "cuda",
                    "source": "emsar_tpu_torch/csrc/window_hash.cu",
                    "replaces": "emsar_tpu/index/device_build.py:1477"},
}


def kernel_modules():
    """{kernel name: its wrapper module} (each has LAUNCHES and build)."""
    from emsar_tpu_torch.kernels import segment_sum, squarem, window_hash
    return {"squarem_block": squarem, "segment_sum": segment_sum,
            "window_hash": window_hash}


def reset_launches() -> None:
    for mod in kernel_modules().values():
        mod.LAUNCHES = 0


def read_launches() -> dict:
    return {k: mod.LAUNCHES for k, mod in kernel_modules().items()}


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
                         BuildConfig(verbose=0), backend="numpy")
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


def write_fasta(path: str, names, seqs) -> None:
    with open(path + ".tmp", "w", buffering=1 << 22) as fh:
        for n, s in zip(names, seqs):
            fh.write(f">{n}\n{s.decode('latin-1')}\n")
    os.replace(path + ".tmp", path)


def ensure_fixture(n_genes: int = N_GENES, n_reads: int = N_READS,
                   cache: str = CACHE):
    """(fasta, rsh, aln) of the SE bench workload, built with the port's
    host tools and cached.  Alignment lines follow bench.py's writer: every
    member of the read's window group, strand from the canonical flags."""
    import numpy as np

    from emsar_tpu.config import BuildConfig
    from emsar_tpu.index import pack
    from emsar_tpu.io.fasta import build_transcriptome
    from emsar_tpu.sim import gene_family_transcriptome, simulate_fragments
    from emsar_tpu_torch.index.build import build_se_index, se_group

    os.makedirs(cache, exist_ok=True)
    fa = os.path.join(cache, "smoke.fa")
    rsh = os.path.join(cache, "smoke.rsh")
    aln = os.path.join(cache, "smoke.bowtieout")
    if all(os.path.exists(f) for f in (fa, rsh, aln)):
        return fa, rsh, aln
    rng = np.random.default_rng(SEED)
    names, seqs, _ = gene_family_transcriptome(rng, n_genes)
    write_fasta(fa, names, seqs)
    tx = build_transcriptome(names, seqs)
    t0 = time.perf_counter()
    build_se_index(tx, READLEN, READLEN, BuildConfig(verbose=0),
                   backend="numpy").write_text(rsh + ".tmp")
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
    return fa, rsh, aln


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
        ("csr", ["--solver_mode", "csr"]),
        ("csr_again", ["--solver_mode", "csr"]))


def phase_main_path(rsh: str, aln: str, out_root: str):
    """Drive ``emsar -I`` through the port's CLI once per RUNS entry and
    check the outputs against each other.  Returns ({run: {kernel:
    launches}}, {run: phase seconds}, the sample's inputs)."""
    import numpy as np

    from emsar_tpu.config import QuantConfig
    from emsar_tpu.ingest import native as native_mod
    from emsar_tpu.io.rsh import RshIndex
    from emsar_tpu.utils.timing import phase_times, reset_phases
    from emsar_tpu_torch.cli import emsar as cli
    from emsar_tpu_torch.model.quantify import _host_loglik, prepare_sample
    from emsar_tpu_torch.model.solver import build_problem

    log(f"native C++ ingest available: {native_mod.available()}")
    launches, seconds, lls, tpms, ircs, fl_bytes = {}, {}, {}, {}, {}, {}
    fpkm_bytes = {}
    names0 = None
    for name, flags in RUNS:
        out = os.path.join(out_root, name)
        reset_phases()
        reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["-q"] + flags + ["-I", rsh, out, "s", aln])
        wall = time.perf_counter() - t0
        launches[name] = read_launches()
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
        with open(os.path.join(out, "s.0.fpkm"), "rb") as fh:
            fpkm_bytes[name] = fh.read()
        log(f"run {name}: {wall:.2f} s, logL {lls[name]!r}, kernel "
            f"launches {launches[name]}, phases "
            + ", ".join(f"{k} {v:.3f}" for k, v in seconds[name].items()))
    for name, _ in RUNS:
        kernel = ("squarem_block" if name.startswith("kernel") else
                  "segment_sum" if name.startswith("csr") else None)
        if kernel and launches[name][kernel] <= 0:
            raise AssertionError(f"run {name} never launched {kernel}")
    same = fpkm_bytes["csr"] == fpkm_bytes["csr_again"]
    log(f"csr vs csr_again: .fpkm byte-identical {same}")
    if not same:
        raise AssertionError("two CSR runs on the same input gave different "
                             ".fpkm bytes")
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
    return launches, seconds, x


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


def phase_build_kernels() -> None:
    """Build every kernel of the port, one nvcc per source, all started
    together; log each build's time and ptxas' registers and spills."""
    from emsar_tpu_torch.kernels import _build

    def timed(mod):
        t0 = time.perf_counter()
        mod.build()
        return time.perf_counter() - t0

    mods = kernel_modules()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        secs = dict(zip(mods, pool.map(timed, mods.values())))
    log(f"kernel builds: {time.perf_counter() - t0:.1f} s in all, "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name, mod in mods.items():
        log_path = _build.library_path(mod.SOURCE) + ".log"
        if os.path.exists(log_path):
            with open(log_path) as fh:
                for ln in fh.read().splitlines():
                    if "registers" in ln or "spill" in ln or "smem" in ln:
                        log(f"ptxas {name}: {ln.strip()}")


def random_csr(rng, n_seg: int, n_x: int, n_edges: int, dev, dtype):
    """A random edge list grouped by segment, as segment_sum's arguments
    (w, idx, offsets) on ``dev``."""
    import numpy as np
    import torch
    seg = np.sort(rng.integers(0, n_seg, n_edges))
    off = np.zeros(n_seg + 1, dtype=np.int64)
    np.cumsum(np.bincount(seg, minlength=n_seg), out=off[1:])
    w = torch.as_tensor(rng.integers(1, 3, n_edges) * 1.0).to(dev, dtype)
    return (w, *(torch.as_tensor(a).to(dev) for a in
                 (rng.integers(0, n_x, n_edges), off)))


def check_segment_sum(x, args, label: str):
    """Segment-sum kernel against its plain version on one input:
    bit-identical across two launches, within rel 1e-12 (f64) / 1e-5 (f32).
    Returns (max abs err, kernel ms, plain ms)."""
    import torch

    from emsar_tpu_torch.kernels import segment_sum as ss
    a = ss.segment_sum(x, *args)
    b = ss.segment_sum(x, *args)
    torch.cuda.synchronize()
    want = ss.segment_sum_ref(x, *args)
    if not torch.equal(a, b):
        raise AssertionError(f"segment_sum {label}: two launches differ")
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[x.dtype]
    err = float((a - want).abs().max()) if a.numel() else 0.0
    rel = err / max(float(want.abs().max()), 1e-300) if a.numel() else 0.0
    k_ms = cuda_ms(lambda: ss.segment_sum(x, *args))
    p_ms = cuda_ms(lambda: ss.segment_sum_ref(x, *args))
    log(f"segment_sum {label} {str(x.dtype)[6:]} R={x.shape[0]} "
        f"G={args[2].shape[0] - 1} E={args[0].shape[0]}: max abs diff "
        f"{err:.3e}, rel {rel:.3e} (tol {tol:g}), two launches equal; "
        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    if rel > tol or not torch.isfinite(a).all():
        raise AssertionError(f"segment_sum {label} disagrees: rel {rel:.3e}")
    return err, k_ms, p_ms


def phase_segment_sum_random(dev) -> None:
    import numpy as np
    import torch
    for dtype in (torch.float32, torch.float64):
        for n_seg, n_x, n_e, R in ((1000, 800, 5000, 1), (200_000, 150_000,
                                                          2_000_000, 3)):
            rng = np.random.default_rng(n_seg + R)
            x = torch.as_tensor(rng.uniform(0, 10, (R, n_x))).to(dev, dtype)
            check_segment_sum(x, random_csr(rng, n_seg, n_x, n_e, dev, dtype),
                              "random")


def phase_window_hash_check(fa: str, dev):
    """Window-hash kernel against its plain version on the smoke
    transcriptome at l50, unstranded and stranded: bit-equal.  Returns
    (max abs lane difference, kernel ms, plain ms) of the unstranded
    pass, the build's own."""
    import torch

    from emsar_tpu.io.fasta import read_fasta
    from emsar_tpu_torch.index.device_build import DeviceRef
    from emsar_tpu_torch.kernels import window_hash as wh

    ref = DeviceRef(read_fasta(fa, "E"), dev)
    n = ref.borderpos - READLEN + 1
    tidf = ref.tid_forward(n)
    measured = {}
    for unstranded in (True, False):
        args = (ref.codes, tidf, ref.borderpos, ref.seqlength, READLEN,
                unstranded)
        got = wh.window_hash(*args)
        torch.cuda.synchronize()
        want = wh.window_hash_ref(*args)
        diff = max(int((g.long() - w.long()).abs().max())
                   for g, w in zip(got, want))
        k_ms = cuda_ms(lambda: wh.window_hash(*args))
        p_ms = cuda_ms(lambda: wh.window_hash_ref(*args), reps=3)
        n_valid = int((got[3] >= 0).sum())
        log(f"window_hash l{READLEN} {'ns' if unstranded else 'ss'}: "
            f"{n} windows, {n_valid} valid, max lane/tid diff {diff}; "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        if diff != 0 or n_valid == 0:
            raise AssertionError("window_hash is not bit-equal to its plain "
                                 "version")
        measured[unstranded] = (float(diff), k_ms, p_ms)
    return measured[True]


def phase_segment_sum_main(x, dev):
    """Segment sums of one CSR EM step on the main path's problem (the
    whole fixture in --solver_mode csr, float64): by cid (intensities) and
    by tid (the EM numerator).  Returns (max abs err, kernel ms, plain
    ms), summed over the two."""
    import numpy as np
    import torch

    from emsar_tpu_torch.model.solver import build_problem, problem_to_device

    problem = build_problem(x.graph, x.modules, x.eumaps, x.read_count)
    p = problem_to_device(problem, dev, torch.float64)
    rng = np.random.default_rng(5)
    total = [0.0, 0.0, 0.0]
    for label, g, n_x in (("by cid", p.by_cid, problem.n_transcripts),
                          ("by tid", p.by_tid, len(problem.eumaps))):
        xs = torch.as_tensor(rng.uniform(0, 10, (1, n_x))).to(dev)
        err, k_ms, p_ms = check_segment_sum(
            xs, (g.mult, g.idx, g.offsets), f"main path {label}")
        total = [max(total[0], err), total[1] + k_ms, total[2] + p_ms]
    return tuple(total)


def phase_build_smoke(fa: str, rsh: str, out_root: str):
    """``emsar-build-torch smoke.fa 50`` on the card against the NumPy
    builder's smoke.rsh.  Returns the run's kernel launches."""
    from emsar_tpu.utils.timing import phase_times, reset_phases
    from emsar_tpu_torch.cli import emsar_build

    out = os.path.join(out_root, "build")
    reset_phases()
    reset_launches()
    t0 = time.perf_counter()
    rc = emsar_build.main(["-q", fa, str(READLEN), out, "smoke"])
    wall = time.perf_counter() - t0
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"emsar-build-torch exited {rc}")
    with open(rsh, "rb") as a, open(os.path.join(out, "smoke.rsh"),
                                     "rb") as b:
        same = a.read() == b.read()
    log(f"SE build on the card: {wall:.2f} s, launches {launches}, .rsh "
        f"byte-equal to the NumPy builder's {same}; phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase_times().items()))
    if not same:
        raise AssertionError("the card-built .rsh differs from smoke.rsh")
    if launches["window_hash"] <= 0:
        raise AssertionError("the SE build never launched window_hash")
    return launches


def phase_fasta_path(fa: str, aln: str, out_root: str, x):
    """``emsar-torch --solver_pallas -x smoke.fa`` against the -I kernel
    run: logL rel 1e-12, .fraglength_effect byte-equal."""
    from emsar_tpu.utils.timing import phase_times, reset_phases
    from emsar_tpu_torch.cli import emsar as cli
    from emsar_tpu_torch.model.quantify import _host_loglik
    from emsar_tpu_torch.model.solver import build_problem

    out = os.path.join(out_root, "fasta")
    reset_phases()
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["-q", "--solver_pallas", "-x", fa, out, "s", aln])
    wall = time.perf_counter() - t0
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"emsar-torch -x exited {rc}")
    problem = build_problem(x.graph, x.modules, x.eumaps, x.read_count)
    lls = {}
    for name in ("kernel", "fasta"):
        _, cols = _parse_fpkm(os.path.join(out_root, name, "s.0.fpkm"))
        lls[name] = _host_loglik(problem, cols[:, 0])
    rel = abs(lls["fasta"] - lls["kernel"]) / abs(lls["kernel"])
    fl = [open(os.path.join(out_root, n, "s.0.fraglength_effect"),
               "rb").read() for n in ("kernel", "fasta")]
    log(f"-x run: {wall:.2f} s, launches {launches}, logL rel diff to the "
        f"-I kernel run {rel:.3e} (tol 1e-12), .fraglength_effect equal "
        f"{fl[0] == fl[1]}; phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase_times().items()))
    if rel > 1e-12 or fl[0] != fl[1]:
        raise AssertionError("the -x run disagrees with the -I run")
    if launches["window_hash"] <= 0 or launches["squarem_block"] <= 0:
        raise AssertionError("the -x run skipped a kernel")


def window_hash_ref_range(codes, tidf, seqlength: int, rl: int,
                          unstranded: bool, a: int, b: int):
    """The plain window hash of the forward windows [a, b) alone: the plain
    version run on a reference cut to the bases those windows read, laid
    out as a whole one (m fw bases, '$', the m rc bases they pair with,
    '$'), so that window i of the cut is window a + i of the whole."""
    import torch

    from emsar_tpu_torch.kernels import window_hash as wh
    m = b - a + rl - 1
    end = codes.new_full((1,), 4)
    cut = torch.cat([codes[a:a + m], end,
                     codes[seqlength - a - m:seqlength - a], end])
    return wh.window_hash_ref(cut, tidf[a:b], m, 2 * m + 1, rl, unstranded)


def check_window_hash_scale(ref, tidf, rl: int, chunk: int = 1 << 25):
    """Window-hash kernel against its plain version on every window of
    ``ref`` at ``rl``, unstranded and stranded; the plain version runs in
    chunks of ``chunk`` windows.  Raises on any differing bit.  Returns
    ({unstranded: (kernel ms, plain ms summed over the chunks)}, the
    unstranded kernel output)."""
    import torch

    from emsar_tpu_torch.kernels import window_hash as wh
    n = ref.borderpos - rl + 1
    measured, kept = {}, None
    for unstranded in (True, False):
        args = (ref.codes, tidf, ref.borderpos, ref.seqlength, rl,
                unstranded)
        k_ms = cuda_ms(lambda: wh.window_hash(*args), reps=5, warmup=1)
        got = wh.window_hash(*args)
        n_bad, p_ms = 0, 0.0
        for a in range(0, n, chunk):
            b = min(a + chunk, n)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            want = window_hash_ref_range(ref.codes, tidf, ref.seqlength, rl,
                                         unstranded, a, b)
            ev[1].record()
            ev[1].synchronize()
            p_ms += ev[0].elapsed_time(ev[1])
            differs = torch.zeros(b - a, dtype=torch.bool, device=tidf.device)
            for g, w in zip(got, want):
                differs |= g[a:b] != w
            n_bad += int(differs.sum())
            del want, differs
        n_valid = int((got[3] >= 0).sum())
        log(f"window_hash at scale l{rl} {'ns' if unstranded else 'ss'}: "
            f"{n} windows, {n_valid} valid, {n_bad} differ from the plain "
            f"version; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms (in "
            f"{-(-n // chunk)} chunks)")
        if n_bad or n_valid == 0:
            raise AssertionError(f"window_hash at scale: {n_bad} windows "
                                 f"differ from the plain version")
        measured[unstranded] = (k_ms, p_ms)
        if unstranded:
            kept = got
        del got
    return measured, kept


def check_rsh_counts(index, lanes, max_repeat: int) -> float:
    """Hold a built SE .rsh (one read length) against window classes
    counted apart from the builder: the valid windows of ``lanes`` (h1, h2,
    h3, tid) grouped by ``torch.unique`` over their 96-bit identity.  Per
    transcript, its windows in classes of one must equal its single count,
    and its windows in classes of 1 < size < max_repeat its occurrences in
    the signatures weighted by their counts; the classes' size histogram
    must equal that of the signatures.  Raises on a difference; returns the
    seconds it took."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    h1, h2, h3, tid = lanes
    keep = tid >= 0
    rows = torch.stack([(h1[keep].long() << 32) | (h2[keep].long()
                                                   & 0xFFFFFFFF),
                        h3[keep].long()], 1)
    tids = tid[keep].long()
    del keep
    _, inv, cnt = torch.unique(rows, dim=0, return_inverse=True,
                               return_counts=True)
    del rows
    per_row = cnt[inv]
    del inv
    ntid = index.n_transcripts
    mid = (per_row > 1) & (per_row < max_repeat)
    got_single = torch.bincount(tids[per_row == 1], minlength=ntid)
    got_multi = torch.bincount(tids[mid], minlength=ntid)
    mid_sizes = cnt[(cnt > 1) & (cnt < max_repeat)]
    got_hist = torch.bincount(mid_sizes, minlength=max_repeat)
    del per_row, mid, tids
    sizes = np.diff(index.sig_offsets)
    counts = np.asarray(index.multi_euma)[:, 0].astype(np.int64)
    want_multi = np.zeros(ntid, dtype=np.int64)
    np.add.at(want_multi, np.asarray(index.sig_tids, dtype=np.int64),
              np.repeat(counts, sizes))
    want_hist = np.zeros(max_repeat, dtype=np.int64)
    np.add.at(want_hist, sizes, counts)
    checks = {
        "single counts": np.array_equal(
            got_single.cpu().numpy(), np.asarray(index.single_euma)[:, 0]),
        "multi windows per transcript": np.array_equal(
            got_multi.cpu().numpy(), want_multi),
        "class size histogram": np.array_equal(got_hist.cpu().numpy(),
                                               want_hist),
    }
    secs = time.perf_counter() - t0
    log(f"scale .rsh against torch.unique window classes: "
        f"{int(cnt.shape[0])} classes, {int(mid_sizes.shape[0])} of "
        f"1 < size < {max_repeat} ({int(counts.sum())} records in the "
        f".rsh); " + ", ".join(f"{k} equal {v}" for k, v in checks.items())
        + f"; {secs:.1f} s")
    if not all(checks.values()):
        raise AssertionError(f"the scale .rsh disagrees with the window "
                             f"classes: {checks}")
    return secs


def phase_scale_build(dev, out_root: str, n_genes: int = SCALE_GENES):
    """The SE l76 build of tools/make_scale_fixture.py's transcriptome on
    the card through ``emsar-build-torch``, then the window-hash kernel
    against its plain version on all of its windows and the .rsh against
    window classes counted with ``torch.unique``.  Returns a dict of what
    it measured."""
    import numpy as np
    import torch

    from emsar_tpu.config import BuildConfig
    from emsar_tpu.io.fasta import read_fasta
    from emsar_tpu.io.rsh import RshIndex
    from emsar_tpu.sim import gene_family_transcriptome
    from emsar_tpu.utils.timing import phase_times, reset_phases
    from emsar_tpu_torch.cli import emsar_build
    from emsar_tpu_torch.index.device_build import DeviceRef

    t0 = time.perf_counter()
    names, seqs, _ = gene_family_transcriptome(
        np.random.default_rng(SCALE_SEED), n_genes, min_isoforms=2,
        max_isoforms=6, n_exons=10, min_exon=120, max_exon=500)
    fa = os.path.join(out_root, "scale.fa")
    write_fasta(fa, names, seqs)
    n_bp = sum(len(s_) for s_ in seqs)
    del names, seqs
    log(f"scale fixture: {n_genes} genes, {n_bp} bp, written in "
        f"{time.perf_counter() - t0:.1f} s")

    out = os.path.join(out_root, "scale")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_phases()
    reset_launches()
    t0 = time.perf_counter()
    rc = emsar_build.main(["-q", fa, str(SCALE_READLEN), out, "scale"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"scale build exited {rc}")
    phases = phase_times()
    groups = {}
    for key, word in (("read fasta", "fasta"), ("upload", "upload"),
                      ("hash", "hash"), ("sort", "sort"),
                      ("accumulate", "accumulate"),
                      ("finalize", "finalize"), ("write", "writing")):
        groups[key] = sum(v for k, v in phases.items() if word in k)
    t1 = time.perf_counter()
    index = RshIndex.load(os.path.join(out, "scale.rsh"))
    load_s = time.perf_counter() - t1
    log(f"scale build SE l{SCALE_READLEN}: {wall:.2f} s wall, peak device "
        f"memory {peak / 2**30:.2f} GiB, n_multi {index.n_multi}, "
        f"{index.n_transcripts} transcripts, launches {launches}; phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in groups.items())
        + f"; .rsh loads back in {load_s:.1f} s")
    if launches["window_hash"] <= 0 or index.n_multi <= 0:
        raise AssertionError("the scale build did not run as expected")

    torch.cuda.empty_cache()
    ref = DeviceRef(read_fasta(fa, "E"), dev)
    tidf = ref.tid_forward(ref.borderpos - SCALE_READLEN + 1)
    wh_times, lanes = check_window_hash_scale(ref, tidf, SCALE_READLEN)
    del ref, tidf
    check_s = check_rsh_counts(index, lanes, BuildConfig().max_repeat)
    del lanes
    torch.cuda.empty_cache()
    os.remove(fa)
    return {"wall_s": wall, "peak_bytes": peak, "n_multi": index.n_multi,
            "phases_s": groups, "bp": n_bp,
            "window_hash_ms": wh_times[True][0],
            "window_hash_plain_ms": wh_times[True][1],
            "window_hash_ss_ms": list(wh_times[False]),
            "rsh_check_s": check_s}


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
    os.environ.pop("EMSAR_TORCH_BUILD_BACKEND", None)
    from emsar_tpu_torch.device import resolve_device
    dev = resolve_device()
    t_start = time.perf_counter()

    phase_build_kernels()

    t0 = time.perf_counter()
    worst = phase_kernel_check(dev)
    log(f"kernel check: {time.perf_counter() - t0:.1f} s, worst rel diff "
        f"{worst:.3e}")
    phase_segment_sum_random(dev)

    t0 = time.perf_counter()
    fa, rsh, aln = ensure_fixture()
    log(f"fixture: {time.perf_counter() - t0:.1f} s")
    wh_err, wh_ms, wh_plain = phase_window_hash_check(fa, dev)

    out_root = os.path.join(CACHE, "out")
    launches, seconds, sample = phase_main_path(rsh, aln, out_root)
    sq_err, sq_ms, sq_plain = phase_main_path_shapes(sample, dev)
    ss_err, ss_ms, ss_plain = phase_segment_sum_main(sample, dev)
    build_launches = phase_build_smoke(fa, rsh, out_root)
    phase_fasta_path(fa, aln, out_root, sample)
    scale = phase_scale_build(dev, out_root)
    log(f"all phases: {time.perf_counter() - t_start:.1f} s")

    measured = {
        "squarem_block": (launches["kernel"]["squarem_block"], sq_err,
                          sq_ms, sq_plain),
        "segment_sum": (launches["csr"]["segment_sum"], ss_err, ss_ms,
                        ss_plain),
        "window_hash": (build_launches["window_hash"], wh_err, wh_ms,
                        wh_plain),
    }
    print(json.dumps({"kernels": [
        dict(KERNELS[k], launches=n, max_abs_err=e, ms=ms, plain_ms=p)
        for k, (n, e, ms, p) in measured.items()]}))
    print(json.dumps({"phase_seconds": seconds, "scale_build": scale}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
