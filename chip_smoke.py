#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (emsar_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a), nvcc and a checkout of this repository; it
imports nothing of JAX.  Phases, each of which raises on failure (non-zero
exit, no result line):

1. torch version, the card's name and power limit (nvidia-smi).
2. Build the three hand-written CUDA kernels from csrc/ (one nvcc per
   source, all started together; sm_90a); per kernel instance ptxas'
   registers, stack, spills and static shared memory (the SQUAREM block
   classes' dynamic shared memory is written in its source).
3. SQUAREM kernel against its plain PyTorch version on the card: every
   size class x {float32, float64}, on padded batches of a real
   gene-family index and on random modules; max error and times.
   Segment-sum kernel and em_step against their plain versions on the CPU
   on random problems (float32 and float64, R 1 and 3, every lane count,
   empty segments, one segment of >3,000 edges): the same bits, and the
   same bits on two launches; sparse.mm of the same CSR matrix timed as
   the library yardstick.
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
   The CSR run's logL must be CSR_LOGL.
6. Kernels against plain versions at the main path's shapes: the SQUAREM
   block on its dense batches (float64), the segment sums and em_step on
   its CSR problem (bit-equal to the CPU); max abs error, device and host
   times, bounds.  Then the CSR solve: CSR_BLOCKS blocks to its end, and
   over three blocks the ms per block, the kernel launches per block and
   the device busy share (torch.profiler).
7. The SE index build on the card: ``emsar-build-torch smoke.fa 50`` must
   write the NumPy builder's smoke.rsh byte for byte (window-hash launch
   count > 0), and ``emsar-torch --solver_pallas -x smoke.fa`` must agree
   with the -I kernel run (logL rel 1e-12, .fraglength_effect equal).
8. The build at scale: the 42,000-gene transcriptome of
   tools/make_scale_fixture.py (``emsar_tpu_torch.bench.
   scale_transcriptome``; ~168k transcripts, ~338 Mbp), SE l76
   through ``emsar-build-torch``: wall time, phases, peak device memory,
   n_multi; the .rsh must load back.  Then the window-hash kernel against
   its plain version on all ~337M windows at l76, unstranded and stranded
   (the plain version in chunks): bit-equal lanes and tids, with both
   times.  Then the .rsh against window classes counted apart from the
   builder (``torch.unique`` over the kernel's 96-bit identities): per
   transcript its single counts and its windows in multi records, and the
   class-size histogram, all equal.

Times on the card (``kernels/measure.py``): ``ms`` is device time per
call, CUDA events around calls queued back to back behind a sleep kernel;
``host_ms`` the host's time per call with no sync; ``bound_ms`` the bytes
or operations of the call over the H100's published rates.

The last lines are the kernels JSON, the card line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import json
import os
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
# the CSR run's logL (from its .fpkm) and the CSR solve's block count on the
# smoke fixture: fixed by the deterministic segment sums, whose order any
# redesign keeps bit for bit
CSR_LOGL = 3262461.230667876
CSR_BLOCKS = 136
KERNELS = {
    "squarem_block": {"name": "squarem_block", "route": "cuda",
                      "source": "emsar_tpu_torch/csrc/squarem_block.cu",
                      "replaces": "emsar_tpu/model/dense.py:333"},
    "segment_sum": {"name": "segment_sum", "route": "cuda",
                    "source": "emsar_tpu_torch/csrc/segment_sum.cu",
                    "replaces": "emsar_tpu/model/solver.py:114"},
    "em_step": {"name": "em_step", "route": "cuda",
                "source": "emsar_tpu_torch/csrc/segment_sum.cu",
                "replaces": "emsar_tpu/model/solver.py:113"},
    "window_hash": {"name": "window_hash", "route": "cuda",
                    "source": "emsar_tpu_torch/csrc/window_hash.cu",
                    "replaces": "emsar_tpu/index/device_build.py:1477"},
}


def kernel_modules():
    """{kernel source's name: its wrapper module} (each has build)."""
    from emsar_tpu_torch.kernels import segment_sum, squarem, window_hash
    return {"squarem_block": squarem, "segment_sum": segment_sum,
            "window_hash": window_hash}


def launch_counters():
    """{kernel name: (wrapper module, name of its launch count)}."""
    mods = kernel_modules()
    return {"squarem_block": (mods["squarem_block"], "LAUNCHES"),
            "segment_sum": (mods["segment_sum"], "LAUNCHES"),
            "em_step": (mods["segment_sum"], "EM_LAUNCHES"),
            "window_hash": (mods["window_hash"], "LAUNCHES")}


def reset_launches() -> None:
    for mod, attr in launch_counters().values():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr)
            in launch_counters().items()}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def gene_family_batches(n_genes: int, seed: int, dtypes):
    """{dtype: padded dense batches} of a real gene-family index (port
    builder) with Poisson read counts."""
    import numpy as np

    from emsar_tpu_torch.config import BuildConfig
    from emsar_tpu_torch.io.fasta import build_transcriptome
    from emsar_tpu_torch.model.modules import build_segment_graph
    from emsar_tpu_torch.sim import gene_family_transcriptome
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
    from emsar_tpu_torch.kernels.measure import device_ms
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
                k_ms = device_ms(lambda: squarem.squarem_block(*args, n_it),
                                 n=50)
                p_ms = device_ms(lambda: squarem.squarem_block_ref(*args,
                                                                   n_it), n=5)
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

    from emsar_tpu_torch.config import BuildConfig
    from emsar_tpu_torch.index import pack
    from emsar_tpu_torch.io.fasta import build_transcriptome
    from emsar_tpu_torch.sim import gene_family_transcriptome, simulate_fragments
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

    from emsar_tpu_torch.config import QuantConfig
    from emsar_tpu_torch.ingest import native as native_mod
    from emsar_tpu_torch.io.rsh import RshIndex
    from emsar_tpu_torch.utils.timing import phase_times, reset_phases
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
        kernels = (("squarem_block",) if name.startswith("kernel") else
                   ("segment_sum", "em_step") if name.startswith("csr")
                   else ())
        for kernel in kernels:
            if launches[name][kernel] <= 0:
                raise AssertionError(f"run {name} never launched {kernel}")
    same = fpkm_bytes["csr"] == fpkm_bytes["csr_again"]
    log(f"csr vs csr_again: .fpkm byte-identical {same}; CSR logL "
        f"{lls['csr']!r} (want {CSR_LOGL!r})")
    if not same:
        raise AssertionError("two CSR runs on the same input gave different "
                             ".fpkm bytes")
    if lls["csr"] != CSR_LOGL:
        raise AssertionError(f"the CSR run's logL {lls['csr']!r} moved from "
                             f"{CSR_LOGL!r}")
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
    sample's ``prepare_sample`` result.  Returns what it measured: times
    and bounds summed over the batches, host ms per call their mean.  The
    bound counts each batch's inputs and output once and 16 C T
    operations per module and cycle (the eight passes over M, a
    multiply and an add each; the elementwise work is left out)."""
    import numpy as np
    import torch

    from emsar_tpu_torch.kernels import measure, squarem
    from emsar_tpu_torch.kernels.check import block_agreement, block_tol
    from emsar_tpu_torch.model.dense import (_theta0, batch_to_device,
                                             partition_modules)

    part = partition_modules(x.graph, x.modules, x.eumaps, x.read_count,
                             dtype=np.float64)
    if not part.batches:
        raise AssertionError("the fixture produced no dense batches")
    tot = {"err": 0.0, "ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "library_ms": None}
    bound_by = {}
    for batch in part.batches:
        db = batch_to_device(batch, dev, torch.float64)
        args = [db.m, db.eumaps, db.reads, db.inv_denom, _theta0(db)]
        got = squarem.squarem_block(*args, N_ITERS)
        want = squarem.squarem_block_ref(*args, N_ITERS)
        err, diff, n = block_agreement(got, want, *args, N_ITERS)
        host = measure.host_ms(lambda: squarem.squarem_block(*args,
                                                             N_ITERS))
        k_ms = measure.device_ms(lambda: squarem.squarem_block(*args,
                                                               N_ITERS),
                                 host_per_call_ms=host)
        p_ms = measure.device_ms(lambda: squarem.squarem_block_ref(
            *args, N_ITERS), n=5)
        B, C, T = batch.shape
        bound, by = measure.bound_ms(measure.nbytes(*args, got),
                                     16 * B * C * T * N_ITERS)
        bound_by[by] = bound_by.get(by, 0.0) + bound
        log(f"main-path batch {batch.shape}: max rel diff {err:.3e} over "
            f"{n} modules, max abs diff {diff:.3e}; kernel {k_ms:.4f} ms on "
            f"the card, {host:.4f} ms host per call; plain {p_ms:.4f} ms "
            f"per {N_ITERS}-cycle block; bound {bound:.4f} ms ({by})")
        if err > block_tol(torch.float64, N_ITERS):
            raise AssertionError(f"kernel disagrees on batch {batch.shape}")
        tot["err"] = max(tot["err"], diff)
        for k, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", bound),
                     ("host_ms", host / len(part.batches))):
            tot[k] += v
    tot["bound_by"] = max(bound_by, key=bound_by.get)
    return tot


def demangle(names: list) -> list:
    """``names`` demangled without their parameter lists by the CUDA
    toolkit's cu++filt, else binutils' c++filt; as they are where neither
    runs."""
    import shutil

    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for tool in (os.path.join(cuda, "bin", "cu++filt"), "c++filt"):
        exe = shutil.which(tool)
        if not exe or not names:
            continue
        proc = subprocess.run([exe, "-p", *names], capture_output=True,
                              text=True)
        out = proc.stdout.splitlines()
        if proc.returncode == 0 and len(out) == len(names):
            return [n.replace("(anonymous namespace)::", "") for n in out]
    return list(names)


def ptxas_report(text: str) -> list:
    """Per kernel instance in a ``-Xptxas -v`` log: its name, registers,
    stack frame, spill stores and loads, and static shared memory
    (bytes)."""
    import re

    def num(pattern, block):
        g = re.search(pattern, block)
        return int(g.group(1)) if g else 0
    blocks = text.split("Compiling entry function")[1:]
    names = demangle([block.split("'")[1] for block in blocks])
    return [{"kernel": name,
             "registers": num(r"Used (\d+) registers", block),
             "stack_bytes": num(r"(\d+) bytes stack frame", block),
             "spill_store_bytes": num(r"(\d+) bytes spill stores", block),
             "spill_load_bytes": num(r"(\d+) bytes spill loads", block),
             "static_smem_bytes": num(r"(\d+) bytes smem", block)}
            for name, block in zip(names, blocks)]


def phase_build_kernels() -> dict:
    """Build every kernel of the port, one nvcc per source, all started
    together; log each build's time, and per kernel instance ptxas'
    registers, stack, spills and static shared memory.  Returns {source's
    kernel: ptxas report}."""
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
    reports = {}
    for name, mod in mods.items():
        log_path = _build.library_path(mod.SOURCE) + ".log"
        if os.path.exists(log_path):
            with open(log_path) as fh:
                reports[name] = ptxas_report(fh.read())
            for r in reports[name]:
                log(f"ptxas {name}: {r['kernel']}: {r['registers']} "
                    f"registers, {r['stack_bytes']} B stack, "
                    f"{r['spill_store_bytes']}/{r['spill_load_bytes']} B "
                    f"spill stores/loads, {r['static_smem_bytes']} B static "
                    f"shared memory")
    return reports


def random_csr(rng, n_seg: int, n_x: int, n_edges: int, dev, dtype,
               long_seg: int = 0):
    """A random edge list grouped by segment, as segment_sum's arguments
    (w, idx, offsets) on ``dev``: segments drawn uniformly (some stay
    empty), idx unsorted within a segment, and ``long_seg`` more edges in
    one segment."""
    import numpy as np
    import torch
    seg = np.sort(np.concatenate([rng.integers(0, n_seg, n_edges),
                                  np.full(long_seg, n_seg // 2)]))
    E = len(seg)
    off = np.zeros(n_seg + 1, dtype=np.int64)
    np.cumsum(np.bincount(seg, minlength=n_seg), out=off[1:])
    w = torch.as_tensor(rng.integers(1, 3, E) * 1.0).to(dev, dtype)
    return (w, *(torch.as_tensor(a).to(dev) for a in
                 (rng.integers(0, n_x, E), off)))


def check_segment_sum(x, args, label: str) -> dict:
    """Segment-sum kernel against its plain version on the CPU: the same
    bits (tolerance 0), and the same bits on two launches.  Times the
    prepared launch (device and host ms), the plain version on the card
    and one ``torch.sparse.mm`` of the same CSR matrix (the library
    yardstick).  Returns what it measured."""
    import warnings

    import torch

    from emsar_tpu_torch.kernels import measure
    from emsar_tpu_torch.kernels import segment_sum as ss
    w, idx, off = args
    g = ss.prepare(off, idx, w, x.shape[1])
    a = ss.segment_sum(x, *args)
    b = ss.sum_groups(x, g)
    torch.cuda.synchronize()
    want = ss.segment_sum_ref(*(t.cpu() for t in (x, w, idx, off)))
    plain = ss.segment_sum_ref(x, *args)
    err = float((a.cpu() - want).abs().max()) if a.numel() else 0.0
    d_plain = float((a - plain).abs().max()) if a.numel() else 0.0
    if not torch.equal(a, b):
        raise AssertionError(f"segment_sum {label}: two launches differ")
    if not torch.equal(a.cpu(), want) or not torch.isfinite(a).all():
        raise AssertionError(f"segment_sum {label}: not the CPU plain "
                             f"version's bits (max abs diff {err:.3e})")
    R, N = x.shape
    G = g.n_groups
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        A = torch.sparse_csr_tensor(off, idx.to(off.dtype), w, size=(G, N),
                                    check_invariants=False)
        xt = x.T.contiguous()
        d_lib = float((torch.sparse.mm(A, xt).T - want.to(x.device)).abs()
                      .max()) if a.numel() else 0.0
        lib_ms = measure.device_ms(lambda: torch.sparse.mm(A, xt))
    host = measure.host_ms(lambda: ss.sum_groups(x, g))
    k_ms = measure.device_ms(lambda: ss.sum_groups(x, g),
                             host_per_call_ms=host)
    p_ms = measure.device_ms(lambda: ss.segment_sum_ref(x, *args), n=20)
    E = idx.shape[0]
    n_bytes = measure.nbytes(x, g.mult, g.idx, g.offsets) + a.numel() * \
        a.element_size()
    bound, by = measure.bound_ms(n_bytes, 2 * E * R, x.dtype)
    log(f"segment_sum {label} {str(x.dtype)[6:]} R={R} G={G} E={E} lanes "
        f"{g.lanes}: bit-equal to the CPU plain version, two launches "
        f"equal (max abs diff to the card's plain version {d_plain:.3e}, "
        f"to sparse.mm {d_lib:.3e}); kernel {k_ms:.4f} ms on the card, "
        f"{host:.4f} ms host per call; plain {p_ms:.4f} ms; sparse.mm "
        f"{lib_ms:.4f} ms; bound {bound:.4f} ms ({by}, {n_bytes} B)")
    return {"err": err, "ms": k_ms, "host_ms": host, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by}


def cpu_groups(g):
    """A prepared edge grouping's copy on the CPU."""
    import dataclasses
    return dataclasses.replace(g, offsets=g.offsets.cpu(), idx=g.idx.cpu(),
                               mult=g.mult.cpu())


def check_em_step(p, theta, label: str) -> dict:
    """em_step on the card against its plain version on the CPU: the same
    bits (tolerance 0), and the same bits on two calls.  ``p`` is a
    DeviceProblem on the card, theta [R, ntid] in its dtype.  Returns
    what it measured (the bound counts em_step's inputs and output once:
    theta, both groupings, reads, inv_denom, the new theta)."""
    import torch

    from emsar_tpu_torch.kernels import measure
    from emsar_tpu_torch.kernels import segment_sum as ss
    args = (p.by_cid, p.by_tid, p.reads, p.inv_denom)
    a = ss.em_step(theta, *args)
    b = ss.em_step(theta, *args)
    torch.cuda.synchronize()
    want = ss.em_step_ref(theta.cpu(), cpu_groups(p.by_cid),
                          cpu_groups(p.by_tid), p.reads.cpu(),
                          p.inv_denom.cpu())
    err = float((a.cpu() - want).abs().max())
    if not torch.equal(a, b):
        raise AssertionError(f"em_step {label}: two calls differ")
    if not torch.equal(a.cpu(), want) or not torch.isfinite(a).all():
        raise AssertionError(f"em_step {label}: not the CPU plain version's "
                             f"bits (max abs diff {err:.3e})")
    host = measure.host_ms(lambda: ss.em_step(theta, *args))
    k_ms = measure.device_ms(lambda: ss.em_step(theta, *args),
                             host_per_call_ms=host)
    p_ms = measure.device_ms(lambda: ss.em_step_ref(theta, *args), n=20)
    R = theta.shape[0]
    E = p.by_cid.idx.shape[0]
    C, T = p.by_cid.n_groups, p.by_tid.n_groups
    n_bytes = measure.nbytes(
        theta, p.reads, p.inv_denom, a, *(t for g in (p.by_cid, p.by_tid)
                                          for t in (g.mult, g.idx,
                                                    g.offsets)))
    bound, by = measure.bound_ms(n_bytes, R * (4 * E + C + 2 * T),
                                 theta.dtype)
    log(f"em_step {label} {str(theta.dtype)[6:]} R={R} C={C} T={T} E={E} "
        f"lanes {p.by_cid.lanes}/{p.by_tid.lanes}: bit-equal to the CPU "
        f"plain version, two calls equal; kernel {k_ms:.4f} ms on the card "
        f"(two launches), {host:.4f} ms host per call; plain {p_ms:.4f} "
        f"ms; bound {bound:.4f} ms ({by}, {n_bytes} B)")
    return {"err": err, "ms": k_ms, "host_ms": host, "plain_ms": p_ms,
            "library_ms": None, "bound_ms": bound, "bound_by": by}


def random_problem(rng, n_seg: int, ntid: int, n_edges: int):
    """A random SolverProblem with read-less segments and transcripts of
    zero denominator among the rest."""
    import numpy as np

    from emsar_tpu_torch.model.solver import SolverProblem
    key = np.unique(rng.integers(0, n_seg, n_edges) * ntid
                    + rng.integers(0, ntid, n_edges))
    reads = rng.poisson(3, n_seg) * 1.0
    denom = rng.uniform(0.5, 3, ntid)
    denom[rng.random(ntid) < 0.05] = 0.0
    return SolverProblem(
        n_transcripts=ntid, edge_cid=(key // ntid).astype(np.int32),
        edge_tid=(key % ntid).astype(np.int32),
        edge_mult=rng.integers(1, 3, len(key)).astype(np.float64),
        eumaps=rng.uniform(0.1, 2, n_seg), reads=reads, denom=denom)


def phase_segment_sum_random(dev) -> None:
    """Segment sums and em_step on random problems, float32 and float64,
    R in {1, 3}: each lane count (4, 8, 16, 32 by the mean edges per
    segment), many empty segments, one segment of 3,000 more edges."""
    import numpy as np
    import torch

    from emsar_tpu_torch.model.solver import problem_to_device
    for dtype in (torch.float32, torch.float64):
        for n_seg, n_x, n_e, R, long_seg in (
                (5000, 4000, 2000, 1, 0), (1000, 800, 5000, 3, 3000),
                (200_000, 150_000, 2_000_000, 3, 0),
                (1000, 800, 25_000, 1, 0)):
            rng = np.random.default_rng(n_seg + R)
            x = torch.as_tensor(rng.uniform(0, 10, (R, n_x))).to(dev, dtype)
            check_segment_sum(x, random_csr(rng, n_seg, n_x, n_e, dev, dtype,
                                            long_seg), "random")
        for R in (1, 3):
            rng = np.random.default_rng(R)
            problem = random_problem(rng, 20_000, 8_000, 80_000)
            p = problem_to_device(problem, dev, dtype)
            theta = rng.uniform(0, 10, (R, problem.n_transcripts))
            theta[:, rng.random(problem.n_transcripts) < 0.2] = 0.0
            check_em_step(p, torch.as_tensor(theta).to(dev, dtype), "random")


def phase_window_hash_check(fa: str, dev):
    """Window-hash kernel against its plain version on the smoke
    transcriptome at l50, unstranded and stranded: bit-equal.  Returns
    what it measured of the unstranded pass, the build's own.  The bound
    counts once the codes the windows read (the forward half, and the rc
    half when unstranded), their tids and the four output lanes
    (``window_hash.bytes_moved``); the hash's integer operations are not
    counted (no published integer rate outside the tensor cores)."""
    import torch

    from emsar_tpu_torch.index.device_build import DeviceRef
    from emsar_tpu_torch.io.fasta import read_fasta
    from emsar_tpu_torch.kernels import measure
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
        host = measure.host_ms(lambda: wh.window_hash(*args))
        k_ms = measure.device_ms(lambda: wh.window_hash(*args),
                                 host_per_call_ms=host)
        p_ms = measure.device_ms(lambda: wh.window_hash_ref(*args), n=3)
        bound, by = measure.bound_ms(
            wh.bytes_moved(ref.borderpos, READLEN, unstranded), 0)
        n_valid = int((got[3] >= 0).sum())
        log(f"window_hash l{READLEN} {'ns' if unstranded else 'ss'}: "
            f"{n} windows, {n_valid} valid, max lane/tid diff {diff}; "
            f"kernel {k_ms:.4f} ms on the card, {host:.4f} ms host per "
            f"call; plain {p_ms:.4f} ms; bound {bound:.4f} ms ({by})")
        if diff != 0 or n_valid == 0:
            raise AssertionError("window_hash is not bit-equal to its plain "
                                 "version")
        measured[unstranded] = {
            "err": float(diff), "ms": k_ms, "host_ms": host,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}
    return measured[True]


def phase_segment_sum_main(x, dev):
    """Segment sums and em_step on the main path's CSR problem (the whole
    fixture in --solver_mode csr, float64, R = 1): the sums by cid
    (intensities) and by tid (the EM numerator), and em_step in float64
    and float32.  Returns ({kernel: measured}, the SolverProblem); the
    segment-sum times are the two sums' together, its host time their
    mean."""
    import numpy as np
    import torch

    from emsar_tpu_torch.model.solver import (build_problem, problem_to_device,
                                              read_attribution_start)
    problem = build_problem(x.graph, x.modules, x.eumaps, x.read_count)
    p = problem_to_device(problem, dev, torch.float64)
    rng = np.random.default_rng(5)
    sums = []
    for label, g in (("by cid", p.by_cid), ("by tid", p.by_tid)):
        xs = torch.as_tensor(rng.uniform(0, 10, (1, g.n_x))).to(dev)
        sums.append(check_segment_sum(
            xs, (g.mult, g.idx, g.offsets), f"main path {label}"))
    seg = {k: sum(m[k] for m in sums) for k in
           ("err", "ms", "plain_ms", "library_ms", "bound_ms")}
    seg["err"] = max(m["err"] for m in sums)
    seg["host_ms"] = sum(m["host_ms"] for m in sums) / len(sums)
    seg["bound_by"] = sums[0]["bound_by"]
    theta = torch.as_tensor(read_attribution_start(problem))[None].to(dev)
    em = check_em_step(p, theta, "main path")
    p32 = problem_to_device(problem, dev, torch.float32)
    check_em_step(p32, theta.float(), "main path")
    return {"segment_sum": seg, "em_step": em}, problem


def phase_csr_profile(problem, dev, n_blocks: int = 3) -> dict:
    """The CSR solve of the main path on the card: the whole solve must
    stop after CSR_BLOCKS blocks; then ``n_blocks`` blocks from the same
    start, timed (ms per block, host clock around work that ends in a
    sync), counted (kernel launches per block: the port's counts and every
    kernel the profiler saw) and profiled (device busy share: kernel time
    on the card over the wall time of the window, torch.profiler)."""
    import numpy as np
    import torch

    from emsar_tpu_torch.kernels import segment_sum as ss
    from emsar_tpu_torch.model.solver import (em_solve, problem_to_device,
                                              read_attribution_start, solve)
    _, ll, blocks = solve(problem, dev, dtype=np.float64)
    log(f"CSR solve: {blocks} blocks (want {CSR_BLOCKS}), logL {ll!r}")
    if blocks != CSR_BLOCKS:
        raise AssertionError(f"the CSR solve took {blocks} blocks, not "
                             f"{CSR_BLOCKS}")
    p = problem_to_device(problem, dev, torch.float64)
    th0 = torch.as_tensor(read_attribution_start(problem))[None].to(dev)
    max_iters = n_blocks * 8 * 3

    def run():
        out = em_solve(p, th0, 1e-9, 8, max_iters)
        torch.cuda.synchronize()
        return out

    run()
    n0 = ss.LAUNCHES + ss.EM_LAUNCHES
    t0 = time.perf_counter()
    _, _, it = run()
    wall = time.perf_counter() - t0
    ours = (ss.LAUNCHES + ss.EM_LAUNCHES - n0) / it
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    busy = busy_us / (prof_wall * 1e6) if kernels else None
    out = {"blocks": it, "ms_per_block": wall * 1e3 / it,
           "port_kernel_launches_per_block": ours,
           "device_kernels_per_block": len(kernels) / it,
           "device_busy_share": busy, "profiled_wall_s": prof_wall}
    log(f"CSR blocks on the card: {out}")
    return out


def phase_build_smoke(fa: str, rsh: str, out_root: str):
    """``emsar-build-torch smoke.fa 50`` on the card against the NumPy
    builder's smoke.rsh.  Returns the run's kernel launches."""
    from emsar_tpu_torch.utils.timing import phase_times, reset_phases
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
    from emsar_tpu_torch.utils.timing import phase_times, reset_phases
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

    from emsar_tpu_torch.kernels import measure
    from emsar_tpu_torch.kernels import window_hash as wh
    n = ref.borderpos - rl + 1
    measured, kept = {}, None
    for unstranded in (True, False):
        args = (ref.codes, tidf, ref.borderpos, ref.seqlength, rl,
                unstranded)
        k_ms = measure.device_ms(lambda: wh.window_hash(*args), n=5)
        got = wh.window_hash(*args)
        bound, by = measure.bound_ms(
            wh.bytes_moved(ref.borderpos, rl, unstranded), 0)
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
            f"{-(-n // chunk)} chunks); bound {bound:.3f} ms ({by})")
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


def phase_scale_build(dev, out_root: str):
    """The SE l76 build of tools/make_scale_fixture.py's transcriptome on
    the card through ``emsar-build-torch``, then the window-hash kernel
    against its plain version on all of its windows and the .rsh against
    window classes counted with ``torch.unique``.  Returns a dict of what
    it measured."""
    import torch

    from emsar_tpu_torch.config import BuildConfig
    from emsar_tpu_torch.io.fasta import read_fasta
    from emsar_tpu_torch.io.rsh import RshIndex
    from emsar_tpu_torch.bench import (SCALE_GENES, SCALE_READLEN,
                                       scale_transcriptome)
    from emsar_tpu_torch.utils.timing import phase_times, reset_phases
    from emsar_tpu_torch.cli import emsar_build
    from emsar_tpu_torch.index.device_build import DeviceRef

    t0 = time.perf_counter()
    names, seqs = scale_transcriptome()
    fa = os.path.join(out_root, "scale.fa")
    write_fasta(fa, names, seqs)
    n_bp = sum(len(s_) for s_ in seqs)
    del names, seqs
    log(f"scale fixture: {SCALE_GENES} genes, {n_bp} bp, written in "
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

    ptxas = phase_build_kernels()

    t0 = time.perf_counter()
    worst = phase_kernel_check(dev)
    log(f"kernel check: {time.perf_counter() - t0:.1f} s, worst rel diff "
        f"{worst:.3e}")
    phase_segment_sum_random(dev)

    t0 = time.perf_counter()
    fa, rsh, aln = ensure_fixture()
    log(f"fixture: {time.perf_counter() - t0:.1f} s")
    measured = {"window_hash": phase_window_hash_check(fa, dev)}

    out_root = os.path.join(CACHE, "out")
    launches, seconds, sample = phase_main_path(rsh, aln, out_root)
    measured["squarem_block"] = phase_main_path_shapes(sample, dev)
    csr_measured, problem = phase_segment_sum_main(sample, dev)
    measured.update(csr_measured)
    csr_blocks = phase_csr_profile(problem, dev)
    build_launches = phase_build_smoke(fa, rsh, out_root)
    phase_fasta_path(fa, aln, out_root, sample)
    scale = phase_scale_build(dev, out_root)
    log(f"all phases: {time.perf_counter() - t_start:.1f} s")

    main_launches = {"squarem_block": launches["kernel"]["squarem_block"],
                     "segment_sum": launches["csr"]["segment_sum"],
                     "em_step": launches["csr"]["em_step"],
                     "window_hash": build_launches["window_hash"]}
    print(json.dumps({"kernels": [
        dict(KERNELS[k], launches=main_launches[k],
             max_abs_err=measured[k]["err"], ms=measured[k]["ms"],
             host_ms=measured[k]["host_ms"],
             plain_ms=measured[k]["plain_ms"],
             bound_ms=measured[k]["bound_ms"],
             bound_by=measured[k]["bound_by"],
             library_ms=measured[k]["library_ms"])
        for k in KERNELS]}))
    print(json.dumps({"phase_seconds": seconds, "csr_blocks": csr_blocks,
                      "scale_build": scale, "ptxas": ptxas}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
