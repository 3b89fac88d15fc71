#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (emsar_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a), nvcc and a checkout of this repository; it
imports nothing of JAX.  Phases, each of which raises on failure (non-zero
exit, no result line):

1. torch version, the card's name and power limit (nvidia-smi).
2. Build the six hand-written CUDA kernel sources of csrc/ (one nvcc per
   source, all started together; sm_90a); per kernel instance ptxas'
   registers, stack, spills and static shared memory (the SQUAREM block
   classes' and the cluster kernels' dynamic shared memory is sized at
   launch).
3. SQUAREM kernel against its plain PyTorch version on the card: every
   size class x {float32, float64}, on padded batches of a real
   gene-family index and on random modules; max error and times.
   Segment-sum kernel and em_step against their plain versions on the CPU
   on random problems (float32 and float64, R 1 and 3, every lane count,
   empty segments, one segment of >3,000 edges): the same bits, and the
   same bits on two launches; sparse.mm of the same CSR matrix timed as
   the library yardstick.  Then the CSR cycle's crossover
   (``emsar_tpu_torch.bench.cluster_sweep``): random problems of modules,
   10,000 to 11.5 M edges at R 1 and some at R 3, R 16 and float32, eight
   cycles on clusters and as twelve launches bit-equal and timed from
   CUDA graphs, the cluster sizes and tile counts compared at 90,000
   edges, the two row layouts (a cluster a row, a cluster over all rows)
   at R 3 and 16, and the largest module an 8-block cluster stages;
   ``solver.solve`` above ``CLUSTER_MAX_EDGES``, which must take the
   twelve launches (em_step, cycle_extrap and cycle_select launched),
   and, unforced, on the sweep's modules with one module above the
   8-block cluster's limit (``bench.cycle_ab.oversized_problem``,
   159,815 edges), which must take them too (no tile plan; em_step,
   pair_gain, cycle_extrap, cycle_select and block_end launched), its ms
   per block timed; the csr_cycle kernels at both shapes as in phase
   6.
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
   The CSR run's logL must be CSR_LOGL_REPAIRED (the default gain), and
   its cycles must run on the cluster kernels; a sixth run, csr_jax, with
   the JAX package's gain (``solver_gain`` 'jax'), must give CSR_LOGL.
   Then the solve's dense batches with each gain, torch.bmm and kernel
   path: each one's blocks, seconds and why it stopped (its last gain:
   NaN or real), and the host f64 polish's cycles and seconds.
6. Kernels against plain versions at the main path's shapes: the SQUAREM
   block on its dense batches (float64; with each gain, timed with the
   main path's), the segment sums and em_step on
   its CSR problem (bit-equal to the CPU); the CSR cycle's kernels
   (em_step_cycle, cycle_extrap, the tiled pair_gain with and without its
   intensities and block_end, each with either gain, cycle_select and a
   whole cycle of twelve
   launches; two cycles replayed from a CUDA graph equal to the eager
   ones, cycle_select equal to torch.where, timed beside it) and the
   cluster kernels (cluster_em_pair from theta and from
   an accept, cluster_extrap_gain with and without its intensities, with
   either gain,
   eight cycles of five launches) bit-equal to their plain versions at
   the CSR shape (R 1, float64; the CSR cycle's kernels in float32 too)
   and the CSR restart rounds' (R 3, float32
   and float64); max abs error, device and host times, bounds, each
   kernel's share of its bound and the cluster plan's tiles and cluster
   size.  Then ``bench.cycle_ab`` on this checkout alone: the block end,
   pair_gain and eight cycles of twelve launches at the smoke's CSR
   shapes (R 1, R 3 f64 and f32, R 16) and on the oversized module's
   problem, with its solve's ms per replayed block.  Then the CSR solve through
   ``solver.solve``, its blocks replayed from a CUDA graph
   (``model/loop.py``) on clusters:
   CSR_BLOCKS blocks to its end with the JAX package's gain (a NaN
   stop), CSR_BLOCKS_REPAIRED to a real stop with the default one; the tile plan's host ms, made and taken
   from the plan cache; the whole solve's ms per block, capture ms,
   kernel launches per block run and device busy share (torch.profiler),
   on clusters and forced off them (twelve launches a cycle).
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
9. The PE candidate kernel: ``pe_candidates`` against its plain version,
   bit for bit (the written keys and payloads, their count and the
   singleton counts), on random tables (members past the tables' ends
   too) and on the tables of a 100-gene PE smoke transcriptome at l101
   (ns and ssfr, d0 0 and 189, nfl 1, 11 and 400), timed, with its bound.
10. The PE build on the card: ``emsar-build-torch --PE`` at l101
   F290-300, ns and ssfr, on the PE smoke transcriptome, and F1-400 ns on
   its first 5 genes: each .rsh byte-equal to the port's NumPy PE
   builder's (pe_candidates and window_hash launched).
11. The PE ``-x`` path: bench.py's PE shape (1000 genes, l101, F290-300,
   500,000 fragments, ssfr) as exact-match alignments in a BAM written by
   ``emsar_tpu_torch.bench.pe_fixture``; ``emsar-torch --PE -B -s ssfr
   -f 290 -F 300 -R -x``, then ``-I`` on the written .rsh: logL rel 1e-9,
   gene iReadcount 1e-3, gene TPM rel 1e-3, .fraglength_effect byte-equal.
   Then pe_candidates at that build's own chunks (times and bound of the
   kernels line), bit-equal to its plain version.
12. The PE build at scale: the 337 Mbp transcriptome of phase 8, PE l101
   F290-300 through ``emsar-build-torch --PE``, ssfr and then ns (both
   halves: ~675 M mate1 windows): wall time, phases, chunks, peak device
   memory.  Then, chunk by chunk, pe_candidates against its plain
   version (written candidates and singleton counts), the singleton
   members' share and the valid candidates' share, and the .rsh against
   candidate groups counted with ``torch.unique`` over the full candidate
   grid (``pe_candidate_grid_ref``, apart from the kernel's singleton
   route): per fragment length, the size-1 groups, the kept groups and
   their members equal Σ single_euma, Σ multi_euma and Σ multi_euma x
   signature size.
13. Multisample and distribution (``emsar_tpu_torch/parallel``): (a) the
   smoke reads split by read name into 16 samples
   (``emsar_tpu_torch.bench.multisample``), ``emsar-torch -M -I`` as the
   per-sample loop and with ``--batch_samples`` (the batched solve over
   the sample axis), each twice (loop, batched, batched, loop; the lower
   wall time kept): per sample .fraglength_effect byte-equal, gene
   iReadcount within 1e-3, the two batched runs' .fpkm byte-identical,
   the cluster kernels and block_end launched in the batched solve, and
   neither pair_gain nor cycle_select
   (counted around ``solve_sharded``, apart from the run's per-sample CSR
   restart loops); the tile plans each run made (the plan cache emptied
   before it): the 16 samples' restart loops must make one between them;
   each batched .fpkm's logL within rel 1e-9 of the
   same batched solve on the CPU (the plain versions, the CLI's gain);
   the loop-vs-batched logL and gene-TPM gaps printed (the batched solve
   stops on one gain summed over the samples, JAX's rule).  The batched
   solve with each gain on the card against the CPU: logL within rel
   1e-9, with the JAX package's gain the same blocks (both stop on the
   first block's NaN), with the repaired one both ``converged`` (their
   roundings may end them a few blocks apart); timed on the card: blocks,
   ms per block; the first block's per-sample gains with either gain (NaN
   only with the JAX package's).  (b) em_step at the batched shape (R = 16,
   per-sample reads and 1 / denom) against its plain version on the CPU:
   bit-equal, two calls equal; times and bound; the CSR cycle's kernels
   and the cluster kernels there as in phase 6.  (c) ``-M
   --dist_merge_shards`` in one process over 3 read-name shards of the
   smoke reads: .fpkm byte-equal to phase 5's whole-file default run.  (d)
   Two processes sharing the card (gloo over 127.0.0.1): the same over 4
   shards, byte-equal to (c); ``emsar-build-torch --PE -s ssfr -f 290 -F
   300`` of phase 10's transcriptome sharded over both (a budget of >= 4
   chunks set by a ``python -c`` launcher), byte-equal to phase 10's
   unsharded build.
14. The convergence loops on the card (``emsar_tpu_torch/model/loop.py``):
   the CSR solve of phase 6 and its restart rounds (R = 3), both dense
   size classes with torch.bmm and with ``squarem_block``, their restart
   rounds (R = 3) and the 16-sample
   batched solve of phase 13, each replayed from a CUDA graph against the
   plain loop (the stop flag read after every block, as before the graph
   loop): theta, logL and block count bit-equal; ms per block both ways,
   blocks run after the stop, capture ms, device busy share and kernels
   per block (torch.profiler); the CSR block's bound.  The three CSR loops
   (the solve, its restart rounds, the batched solve) run on clusters and
   again forced off them (twelve launches a cycle): bit-equal.

Times on the card (``kernels/measure.py``): ``ms`` is device time per
call, CUDA events around calls queued back to back behind a sleep kernel;
``host_ms`` the host's time per call with no sync; ``bound_ms`` the bytes
or operations of the call over the H100's published rates.

The last lines are the kernels JSON, the card line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
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
# redesign keeps bit for bit.  CSR_LOGL and CSR_BLOCKS are the JAX
# package's gain's (solver_gain 'jax': the solve stops on a NaN block
# gain); the _REPAIRED pair the default gain's, which stops on a real one
CSR_LOGL = 3262461.230667876
CSR_BLOCKS = 136
CSR_LOGL_REPAIRED = 3262461.2306709792
CSR_BLOCKS_REPAIRED = 289
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
    "pe_candidates": {"name": "pe_candidates", "route": "cuda",
                      "source": "emsar_tpu_torch/csrc/pe_candidates.cu",
                      "replaces": "emsar_tpu/index/device_build.py:1010"},
    "pair_gain": {"name": "pair_gain", "route": "cuda",
                  "source": "emsar_tpu_torch/csrc/csr_cycle.cu",
                  "replaces": "emsar_tpu/model/solver.py:134"},
    "block_end": {"name": "block_end", "route": "cuda",
                  "source": "emsar_tpu_torch/csrc/csr_cycle.cu",
                  "replaces": "emsar_tpu/model/solver.py:181"},
    "cycle_extrap": {"name": "cycle_extrap", "route": "cuda",
                     "source": "emsar_tpu_torch/csrc/csr_cycle.cu",
                     "replaces": "emsar_tpu/model/solver.py:150"},
    "cycle_select": {"name": "cycle_select", "route": "cuda",
                     "source": "emsar_tpu_torch/csrc/csr_cycle.cu",
                     "replaces": "emsar_tpu/model/solver.py:150"},
    "cluster_em_pair": {"name": "cluster_em_pair", "route": "cuda",
                        "source": "emsar_tpu_torch/csrc/csr_cluster.cu",
                        "replaces": "emsar_tpu/model/solver.py:113"},
    "cluster_extrap_gain": {"name": "cluster_extrap_gain", "route": "cuda",
                            "source": "emsar_tpu_torch/csrc/csr_cluster.cu",
                            "replaces": "emsar_tpu/model/solver.py:150"},
}
# the PE build checks: a gene-family transcriptome the port's NumPy PE
# builder takes ~15 s (ns) and ~9 s (ssfr) for at l101 F290-300 on one
# CPU core, and its first genes for the wide range, ~25 s (ns)
PE_SMOKE_GENES = 100
PE_WIDE_GENES = 5


# phase 13: shards of the merge runs (its samples: bench.MS_SAMPLES)
MERGE_SHARDS = 3
MERGE_SHARDS_2PROC = 4
PE_SHARD_MIN_CHUNKS = 4


def kernel_modules():
    """{kernel source's name: its wrapper module} (each has build)."""
    from emsar_tpu_torch.kernels import (csr_cluster, csr_cycle,
                                         pe_candidates, segment_sum, squarem,
                                         window_hash)
    return {"squarem_block": squarem, "segment_sum": segment_sum,
            "window_hash": window_hash, "pe_candidates": pe_candidates,
            "csr_cycle": csr_cycle, "csr_cluster": csr_cluster}


def launch_counters():
    """{kernel name: (wrapper module, name of its launch count)}."""
    mods = kernel_modules()
    return {"squarem_block": (mods["squarem_block"], "LAUNCHES"),
            "segment_sum": (mods["segment_sum"], "LAUNCHES"),
            "em_step": (mods["segment_sum"], "EM_LAUNCHES"),
            "window_hash": (mods["window_hash"], "LAUNCHES"),
            "pe_candidates": (mods["pe_candidates"], "LAUNCHES"),
            "pair_gain": (mods["csr_cycle"], "PAIR_GAIN_LAUNCHES"),
            "block_end": (mods["csr_cycle"], "BLOCK_END_LAUNCHES"),
            "cycle_extrap": (mods["csr_cycle"], "EXTRAP_LAUNCHES"),
            "cycle_select": (mods["csr_cycle"], "SELECT_LAUNCHES"),
            "cluster_em_pair": (mods["csr_cluster"], "EM_PAIR_LAUNCHES"),
            "cluster_extrap_gain": (mods["csr_cluster"],
                                    "EXTRAP_GAIN_LAUNCHES")}


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
        ("csr_again", ["--solver_mode", "csr"]),
        ("csr_jax", ["--solver_mode", "csr"]))
# runs of the CLI with the JAX package's gain (QuantConfig.solver_gain
# 'jax', which no flag selects)
JAX_GAIN_RUNS = ("csr_jax",)


@contextlib.contextmanager
def cli_gain(cli, gain: str):
    """The CLI's configurations with ``solver_gain`` ``gain`` inside."""
    made = cli.QuantConfig
    cli.QuantConfig = functools.partial(made, solver_gain=gain)
    try:
        yield
    finally:
        cli.QuantConfig = made


@contextlib.contextmanager
def dense_route(name: str):
    """Inside, the "bmm" run's dense batches take torch.bmm on the card
    (``dense.KERNEL_CLASSES`` emptied), as every run's did before the
    hand kernel became the card's route for the one-warp classes."""
    from emsar_tpu_torch.model import dense
    classes = dense.KERNEL_CLASSES
    if name == "bmm":
        dense.KERNEL_CLASSES = ()
    try:
        yield
    finally:
        dense.KERNEL_CLASSES = classes


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
        with cli_gain(cli, "jax" if name in JAX_GAIN_RUNS else "repaired"), \
                dense_route(name):
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
        # the CSR runs' cycles run on clusters (the smoke's problem is
        # below CLUSTER_MAX_EDGES): em_step launches only above it
        kernels = (("squarem_block",) if name.startswith("kernel") else
                   ("segment_sum", "block_end", "cluster_em_pair",
                    "cluster_extrap_gain") if name.startswith("csr") else ())
        for kernel in kernels:
            if launches[name][kernel] <= 0:
                raise AssertionError(f"run {name} never launched {kernel}")
    same = fpkm_bytes["csr"] == fpkm_bytes["csr_again"]
    log(f"csr vs csr_again: .fpkm byte-identical {same}; CSR logL "
        f"{lls['csr']!r} (want {CSR_LOGL_REPAIRED!r}), with the JAX "
        f"package's gain {lls['csr_jax']!r} (want {CSR_LOGL!r})")
    if not same:
        raise AssertionError("two CSR runs on the same input gave different "
                             ".fpkm bytes")
    for name, want in (("csr", CSR_LOGL_REPAIRED), ("csr_jax", CSR_LOGL)):
        if want is not None and lls[name] != want:
            raise AssertionError(f"the {name} run's logL {lls[name]!r} "
                                 f"moved from {want!r}")
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


def dense_stops(x, dev) -> dict:
    """Why the solve's dense batches stop, and what the host f64 polish
    then costs, on the main path's sample (f64), with each gain (the JAX
    package's, 'jax', and the default, 'repaired'): per size class and
    path (torch.bmm, ``--solver_pallas``) its blocks, seconds and its last
    block's gain (the best module's; NaN, or real below epsilon, or the
    cap), from the same solve run once more with the cap one block short;
    then ``quantify._solve_auto`` and the polish's cycles
    (``solver.polish_host_f64``) and seconds.  Changes no result."""
    import numpy as np
    import torch

    from emsar_tpu_torch.config import QuantConfig
    from emsar_tpu_torch.model.dense import (_mt, _pad_b, _theta0,
                                             batch_to_device,
                                             partition_modules,
                                             solve_dense_batch)
    from emsar_tpu_torch.model.quantify import _solve_auto
    from emsar_tpu_torch.model.solver import (build_problem, gain_of,
                                              polish_host_f64)
    eps, cap = QuantConfig.epsilon, 2048
    part = partition_modules(x.graph, x.modules, x.eumaps, x.read_count,
                             dtype=np.float64)
    out = {}
    for skip in (False, True):
        gain_name = "repaired" if skip else "jax"
        for pallas in (False, True):
            path = "kernel" if pallas else "bmm"
            for batch in part.batches:
                cls = "x".join(map(str, batch.shape[1:]))
                t0 = time.perf_counter()
                th, it = solve_dense_batch(batch, eps, dev, N_ITERS, cap,
                                           use_pallas=pallas,
                                           skip_unread=skip)
                solve_s = time.perf_counter() - t0
                if it > 1:
                    prev, _ = solve_dense_batch(batch, eps, dev, N_ITERS,
                                                it - 1, use_pallas=pallas,
                                                skip_unread=skip)
                else:  # the first block's start
                    db = batch_to_device(batch, dev, torch.float64)
                    prev = _theta0(db).cpu().numpy()
                db = batch_to_device(batch, dev, torch.float64)
                s_old, s_new = (_mt(db.m, torch.as_tensor(a).to(dev))
                                for a in (prev, th))
                gain = float(torch.max(gain_of(db.reads, db.eumaps, s_old,
                                               s_new, skip)))
                stop = ("NaN" if np.isnan(gain) else "cap" if it >= cap
                        else "real")
                out[f"{gain_name} {path} {cls}"] = {
                    "blocks": it, "gain": gain, "stop": stop, "s": solve_s}
        cfg = QuantConfig(verbose=0, solver_gain=gain_name)
        problem = build_problem(x.graph, x.modules, x.eumaps, x.read_count)
        fpkm, _, _ = _solve_auto(x.graph, x.modules, x.eumaps, x.read_count,
                                 problem, cfg, np.float64, dev)
        t0 = time.perf_counter()
        _, cycles = polish_host_f64(problem, fpkm,
                                    epsilon=max(cfg.epsilon, 1e-9),
                                    max_cycles=200, skip_unread=skip)
        out[f"{gain_name} polish"] = {"cycles": cycles,
                                      "s": time.perf_counter() - t0}
    log("the solve's dense batches (f64, epsilon "
        f"{eps:g}): " + "; ".join(
            f"{k}: {v['blocks']} blocks, stop {v['stop']} (last gain "
            f"{v['gain']!r}), {v['s']:.3f} s" for k, v in out.items()
            if "polish" not in k)
        + "; then the host f64 polish: " + "; ".join(
            f"{k}: {v['cycles']} cycles in {v['s']:.3f} s"
            for k, v in out.items() if "polish" in k))
    return out


def phase_main_path_shapes(x, dev):
    """Kernel vs plain version on the main path's own dense batches
    (float64, one block from the read-attribution start), with the JAX
    package's gain and with the main path's (``skip_unread``).  ``x`` is the
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
        # with the JAX package's gain, then the main path's (timed)
        for skip in (False, True):
            got = squarem.squarem_block(*args, N_ITERS, skip)
            want = squarem.squarem_block_ref(*args, N_ITERS, skip)
            err, diff, n = block_agreement(got, want, *args, N_ITERS, skip)
            log(f"main-path batch {batch.shape} skip_unread={skip}: max rel "
                f"diff {err:.3e} over {n} modules, max abs diff {diff:.3e}")
            if err > block_tol(torch.float64, N_ITERS):
                raise AssertionError(f"kernel disagrees on batch "
                                     f"{batch.shape} (skip_unread={skip})")
        host = measure.host_ms(lambda: squarem.squarem_block(*args,
                                                             N_ITERS, True))
        k_ms = measure.device_ms(lambda: squarem.squarem_block(*args,
                                                               N_ITERS, True),
                                 host_per_call_ms=host)
        p_ms = measure.device_ms(lambda: squarem.squarem_block_ref(
            *args, N_ITERS, True), n=5)
        B, C, T = batch.shape
        bound, by = measure.bound_ms(measure.nbytes(*args, got),
                                     16 * B * C * T * N_ITERS)
        bound_by[by] = bound_by.get(by, 0.0) + bound
        log(f"main-path batch {batch.shape}: kernel {k_ms:.4f} ms on "
            f"the card, {host:.4f} ms host per call; plain {p_ms:.4f} ms "
            f"per {N_ITERS}-cycle block; bound {bound:.4f} ms ({by})")
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


def _same_bits(a, b) -> bool:
    """The same shape, NaN in the same places and the same bits
    elsewhere (any NaN equals any NaN)."""
    import numpy as np
    if a.shape != b.shape:
        return False
    a, b = (np.ascontiguousarray(t.detach().cpu().numpy()) for t in (a, b))
    nan = np.isnan(a)
    return bool(np.array_equal(nan, np.isnan(b))) and bool(np.array_equal(
        a[~nan].view(np.uint8), b[~nan].view(np.uint8)))


def plain_cycle(p, theta):
    """One SQUAREM cycle as torch ops around the port's EM-step and
    intensity kernels (the plain versions of kernels/csr_cycle.py and the
    lines that em_step_cycle took over), on p's device: the card path the
    cycle's kernels replace."""
    import torch

    from emsar_tpu_torch.kernels import csr_cycle as cc
    from emsar_tpu_torch.kernels import segment_sum as ss

    def em(th):
        return ss.em_step(th, p.by_cid, p.by_tid, p.reads, p.inv_denom)
    t1 = em(theta)
    t2 = em(t1)
    r = t1 - theta
    v = t2 - t1 - r
    cand = em(cc.cycle_extrap_ref(theta, t1, t2,
                                  torch.sum(r * r, dim=1, keepdim=True),
                                  torch.sum(v * v, dim=1, keepdim=True)))
    gain = torch.sum(cc.gain_terms(p.reads, p.eumaps,
                                   ss.sum_groups(t2, p.by_cid),
                                   ss.sum_groups(cand, p.by_cid)), dim=-1)
    return cc.cycle_select_ref(gain, cand, t2)


def replayed(fn):
    """What ``fn()`` returns when it is captured into a CUDA graph
    (``bench.cluster_sweep.capture``) and replayed, its output
    overwritten with -1 before the replay."""
    import torch

    from emsar_tpu_torch.bench.cluster_sweep import capture
    graph, out = capture(fn)
    out.fill_(-1.0)
    graph.replay()
    torch.cuda.synchronize()
    return out


def check_csr_cycle(p, theta, label: str) -> dict:
    """The CSR cycle's kernels on the card against their plain versions on
    the same inputs, bit for bit: em_step_cycle (t2, r * r, v * v)
    against the CPU's; cycle_extrap, cycle_select (and torch.where, its
    library call), the
    tiled pair_gain's gain terms and block_end against torch on the card
    (the intensities summed on the CPU: index_add_ on the card sums with
    atomics), pair_gain's intensities against the CPU's; a whole
    ``solver._squarem_cycle`` off clusters (twelve launches) against
    ``plain_cycle``, and on two calls; two cycles replayed from a CUDA
    graph against the same two run eagerly (cycle_extrap and
    cycle_select may start before the row sum they wait on ends).  ``p`` is a DeviceProblem or
    ShardedProblem on the card (reads, eumaps, inv_denom one row or a row
    each), theta [R, T].  Times each csr_cycle kernel (device and host ms)
    and its plain version on the card, each call from a cold L2, beside
    its bound (``bench.cycle_ab.kernel_bounds``), em_step, em_step_cycle
    and the whole cycle against ``plain_cycle``, and cycle_select's
    library call.  Returns {kernel: what it measured, "cycle": the EM
    steps' and the cycle's times}."""
    import torch

    from emsar_tpu_torch.bench.cycle_ab import kernel_bounds
    from emsar_tpu_torch.kernels import csr_cycle as cc
    from emsar_tpu_torch.kernels import measure
    from emsar_tpu_torch.kernels import segment_sum as ss
    from emsar_tpu_torch.model.solver import _squarem_cycle, _squarem_cycles

    theta = theta.contiguous()
    gc, gt = p.by_cid, p.by_tid
    groups = (gc, gt, p.reads, p.inv_denom)
    cpu = (cpu_groups(gc), cpu_groups(gt), p.reads.cpu(), p.inv_denom.cpu())
    failed = []
    t1 = ss.em_step(theta, *groups)
    got = ss.em_step_cycle(t1, theta, *groups)
    torch.cuda.synchronize()
    want = ss.em_step_cycle_ref(t1.cpu(), theta.cpu(), *cpu)
    if not all(_same_bits(a, b) for a, b in zip(got, want)):
        failed.append("em_step_cycle")
    t2, r_sq, v_sq = got
    rs = torch.sum(r_sq, dim=1, keepdim=True)
    vs = torch.sum(v_sq, dim=1, keepdim=True)
    x = cc.cycle_extrap(theta, t1, t2, rs, vs)
    if not _same_bits(x, cc.cycle_extrap_ref(theta, t1, t2, rs, vs)):
        failed.append("cycle_extrap")
    cand = ss.em_step(x, *groups)
    s_t2, s_cand = (ss.segment_sum_ref(a.cpu(), cpu[0].mult, cpu[0].idx,
                                       cpu[0].offsets).to(theta.device)
                    for a in (t2, cand))
    # the main path's gain, then the JAX package's (whose terms the
    # checks below take)
    for skip in (True, False):
        terms = cc.gain_terms(p.reads, p.eumaps, s_t2, s_cand, skip)
        got = cc.pair_gain(gc, p.reads, p.eumaps, t2, cand,
                           skip_unread=skip)
        got_i, s_o, s_n = cc.pair_gain(gc, p.reads, p.eumaps, t2, cand,
                                       intensities=True, skip_unread=skip)
        if not (_same_bits(got, terms) and _same_bits(got_i, terms)
                and _same_bits(s_o, s_t2) and _same_bits(s_n, s_cand)):
            failed.append(f"pair_gain skip_unread={skip}")
    gain = torch.sum(got, dim=-1)
    gain[0] = float("nan")  # the accept's NaN branch: t2
    out = cc.cycle_select(gain, cand, t2)
    if not _same_bits(out, cc.cycle_select_ref(gain, cand, t2)):
        failed.append("cycle_select")
    s_prev = ss.sum_groups(theta, gc)
    for skip in (True, False):
        end = cc.block_end(gain, cand, t2, s_t2, s_cand, s_prev, p.reads,
                           p.eumaps, skip)
        if not all(_same_bits(a, b) for a, b in zip(end, cc.block_end_ref(
                gain, cand, t2, s_t2, s_cand, s_prev, p.reads, p.eumaps,
                skip))):
            failed.append(f"block_end skip_unread={skip}")
    library = {"cycle_select": lambda: torch.where(
        (gain >= 0)[:, None], cand, t2)}
    if not _same_bits(library["cycle_select"](), out):
        failed.append("cycle_select against torch.where")
    whole = [_squarem_cycle(p, theta, clusters=False) for _ in range(2)]
    if not (_same_bits(whole[0], plain_cycle(p, theta))
            and _same_bits(whole[0], whole[1])):
        failed.append("the whole cycle")
    # a block of two cycles (cycle_select and cycle_extrap each launched
    # behind the row sum they wait on) replayed from a CUDA graph
    two = _squarem_cycles(p, theta, 2, None)
    if not _same_bits(replayed(lambda: _squarem_cycles(p, theta, 2, None)),
                      two):
        failed.append("two cycles replayed from a CUDA graph")
    n_nan = int(torch.isnan(terms).sum())
    if failed:
        raise AssertionError(f"csr_cycle {label}: {failed} differ from "
                             f"their plain versions")
    R = theta.shape[0]
    bounds = kernel_bounds(p, R)
    calls = {
        "pair_gain": (lambda: cc.pair_gain(gc, p.reads, p.eumaps, t2, cand),
                      lambda: cc.pair_gain_ref(gc, p.reads, p.eumaps, t2,
                                               cand)),
        "block_end": (lambda: cc.block_end(gain, cand, t2, s_t2, s_cand,
                                           s_prev, p.reads, p.eumaps),
                      lambda: cc.block_end_ref(gain, cand, t2, s_t2, s_cand,
                                               s_prev, p.reads, p.eumaps)),
        "cycle_extrap": (lambda: cc.cycle_extrap(theta, t1, t2, rs, vs),
                         lambda: cc.cycle_extrap_ref(theta, t1, t2, rs, vs)),
        "cycle_select": (lambda: cc.cycle_select(gain, cand, t2),
                         lambda: cc.cycle_select_ref(gain, cand, t2))}
    measured = {}
    # from a cold L2: their inputs fit in the H100's 50 MB at these shapes
    for name, (fn, plain) in calls.items():
        host = measure.host_ms(fn)
        ms = measure.device_ms_cold(fn, host_per_call_ms=host)
        bound, by, n_bytes = bounds[name]
        lib = library.get(name)
        measured[name] = {"err": 0.0, "ms": ms, "host_ms": host,
                          "plain_ms": measure.device_ms_cold(plain, n=20),
                          "library_ms": None if lib is None else
                          measure.device_ms_cold(lib),
                          "bound_ms": bound, "bound_by": by,
                          "bytes": n_bytes}
    steps = {
        "em_step": lambda: ss.em_step(t1, *groups),
        "em_step_cycle": lambda: ss.em_step_cycle(t1, theta, *groups),
        "pair_gain intensities": lambda: cc.pair_gain(
            gc, p.reads, p.eumaps, t2, cand, intensities=True),
        "cycle": lambda: _squarem_cycle(p, theta, clusters=False)}
    cycle = {}
    for name, fn in steps.items():
        host = measure.host_ms(fn, 50)
        cycle[name] = {"ms": measure.device_ms(fn, host_per_call_ms=host),
                       "host_ms": host}
        if name in bounds:
            cycle[name]["bound_ms"] = bounds[name][0]
    cycle["plain_cycle_ms"] = measure.device_ms(lambda: plain_cycle(
        p, theta), n=50)
    C, T, E = gc.n_groups, gt.n_groups, gc.idx.shape[0]
    log(f"csr_cycle {label} {str(theta.dtype)[6:]} R={R} C={C} T={T} E={E}: "
        f"em_step_cycle, cycle_extrap, pair_gain (tiles of {ss.TILE} "
        f"segments, "
        f"{gc.tiles.shape[1] - 1} tiles), cycle_select, block_end and the "
        f"whole cycle bit-equal to their plain versions, two cycles "
        f"replayed from a CUDA graph to the eager ones ({n_nan} NaN gain "
        f"terms); " + "; ".join(
            f"{k} {m['ms']:.5f} ms on the card ({m['bound_ms'] / m['ms']:.1%}"
            f" of its bound {m['bound_ms']:.5f} ms, {m['bound_by']}), "
            f"{m['host_ms']:.4f} ms host, plain {m['plain_ms']:.4f} ms"
            + ("" if m["library_ms"] is None else
               f", torch.where {m['library_ms']:.5f} ms")
            for k, m in measured.items()) + "; " + "; ".join(
            f"{k} {m['ms']:.5f} ms" + (f" (bound {m['bound_ms']:.5f})"
                                       if "bound_ms" in m else "")
            for k, m in cycle.items() if isinstance(m, dict))
        + f"; the torch body's cycle {cycle['plain_cycle_ms']:.4f} ms")
    measured["cycle"] = cycle
    measured["nan_terms"] = n_nan
    return measured


def cluster_bounds(p, plan, R: int) -> dict:
    """{kernel: (bound ms, bound_by)} of the two cluster kernels at R rows
    of ``p``: each input read once (theta, the tiled groupings, reads,
    eumaps, 1 / denom, t1, t2, the two row sums), each output written once
    (t1, t2, r * r, v * v; cand and the gain terms); the operations those
    of em_step, counted as its row counts them (two EM steps, then the
    squares' 5 T), and of cycle_extrap, one EM step and pair_gain."""
    from emsar_tpu_torch.kernels import measure
    dt = p.reads.dtype
    item = p.reads.element_size()
    C, T = p.by_cid.n_groups, p.by_tid.n_groups
    E = p.by_cid.idx.shape[0]
    groups = measure.nbytes(*(t for g in (plan.cid, plan.tid) for t in (
        g.mult, g.idx, g.offsets, g.orig, g.tile_off)))
    ops = {"cluster_em_pair": R * (2 * (4 * E + C + 2 * T) + 5 * T),
           "cluster_extrap_gain": R * (10 * T + 4 * E + C + 2 * T + 4 * E
                                       + 14 * C)}
    vecs = {"cluster_em_pair": measure.nbytes(p.reads, p.inv_denom)
            + item * R * 5 * T,
            "cluster_extrap_gain": measure.nbytes(p.reads, p.eumaps,
                                                  p.inv_denom)
            + item * R * (4 * T + 2 + C)}
    return {k: measure.bound_ms(groups + vecs[k], ops[k], dt) for k in ops}


def check_csr_cluster(p, theta, label: str) -> dict:
    """The cluster kernels (``kernels/csr_cluster.py``) on the card against
    their plain versions on the same inputs, bit for bit: cluster_em_pair
    from theta and from a cycle's accept (theta, t1, t2, r * r, v * v)
    against the CPU's; cluster_extrap_gain's cand against the CPU's, its
    gain terms against torch's on the card over intensities summed on the
    CPU (CUDA's log1p on both sides), and the intensities it writes in a
    block's last cycle against those; eight cycles on clusters (five
    launches a cycle, block_end after the last) against eight of ten
    launches, and on two calls.  ``p`` is a DeviceProblem or
    ShardedProblem on the card, theta [R, T].  Times each kernel (device
    and host ms) and its plain version on the card, and the eight cycles
    both ways replayed from a CUDA graph (``bench.cluster_sweep.
    graph_ms``).  Returns {kernel: what it measured, "plan": the tile
    plan's shape, "block": the eight cycles' times}."""
    import torch

    from emsar_tpu_torch.bench.cluster_sweep import graph_ms
    from emsar_tpu_torch.kernels import csr_cluster as cc
    from emsar_tpu_torch.kernels import csr_cycle
    from emsar_tpu_torch.kernels import measure
    from emsar_tpu_torch.kernels import segment_sum as ss
    from emsar_tpu_torch.model.solver import _squarem_cycles, cycle_plan

    theta = theta.contiguous()
    R = theta.shape[0]
    plan = cycle_plan(p, R, clusters=True)
    cpu = (cpu_groups(p.by_cid), cpu_groups(p.by_tid))
    reads_c, inv_c = p.reads.cpu(), p.inv_denom.cpu()
    failed = []
    got = cc.em_pair(theta, plan, p.reads, p.inv_denom)
    again = cc.em_pair(theta, plan, p.reads, p.inv_denom)
    torch.cuda.synchronize()
    want = cc.em_pair_ref(theta.cpu(), *cpu, reads_c, inv_c)
    if not all(_same_bits(a, w) and _same_bits(a, b)
               for a, b, w in zip(got, again, want)):
        failed.append("cluster_em_pair")
    _, t1, t2, r_sq, v_sq = got
    rs = torch.sum(r_sq, dim=1, keepdim=True)
    vs = torch.sum(v_sq, dim=1, keepdim=True)
    ex = (theta, t1, t2, rs, vs, plan, p.reads, p.eumaps, p.inv_denom)
    cand, terms = cc.extrap_gain(*ex)
    torch.cuda.synchronize()
    # the extrapolation by torch on the card (CUDA's sqrt, as the
    # kernel's: torch's CPU sqrt may be an ulp off), its EM step on the CPU
    x = csr_cycle.cycle_extrap_ref(theta, t1, t2, rs, vs).cpu()
    want_cand = ss.em_step_ref(x, *cpu, reads_c, inv_c)
    s_t2, s_cand = (ss.segment_sum_ref(a.cpu(), cpu[0].mult, cpu[0].idx,
                                       cpu[0].offsets).to(theta.device)
                    for a in (t2, cand))
    cand_i, terms_i, s_t2_k, s_cand_k = cc.extrap_gain(*ex,
                                                       intensities=True)
    if not (_same_bits(cand, want_cand) and _same_bits(
            terms, csr_cycle.gain_terms(p.reads, p.eumaps, s_t2, s_cand))
            and _same_bits(cand_i, cand) and _same_bits(terms_i, terms)
            and _same_bits(s_t2_k, s_t2) and _same_bits(s_cand_k, s_cand)):
        failed.append("cluster_extrap_gain")
    # the main path's gain: the same candidate, the repaired terms
    terms_r = csr_cycle.gain_terms(p.reads, p.eumaps, s_t2, s_cand, True)
    cand_r, got_r = cc.extrap_gain(*ex, skip_unread=True)
    cand_ri, got_ri, _, _ = cc.extrap_gain(*ex, intensities=True,
                                           skip_unread=True)
    if not (_same_bits(cand_r, cand) and _same_bits(cand_ri, cand)
            and _same_bits(got_r, terms_r) and _same_bits(got_ri, terms_r)):
        failed.append("cluster_extrap_gain skip_unread=True")
    gain = torch.sum(terms, dim=-1)
    src = (gain, cand, t2)
    got = cc.em_pair(src, plan, p.reads, p.inv_denom)
    torch.cuda.synchronize()
    want = cc.em_pair_ref(tuple(a.cpu() for a in src), *cpu, reads_c, inv_c)
    if not all(_same_bits(a, w) for a, w in zip(got, want)):
        failed.append("cluster_em_pair from an accept")
    blocks = [_squarem_cycles(p, theta, N_ITERS, plan)
              for _ in range(2)]
    launches = _squarem_cycles(p, theta, N_ITERS, None)
    if not (_same_bits(blocks[0], blocks[1])
            and _same_bits(blocks[0], launches)):
        failed.append(f"{N_ITERS} cycles")
    n_nan = int(torch.isnan(terms).sum())
    if failed:
        raise AssertionError(f"csr_cluster {label}: {failed} differ from "
                             f"their plain versions")
    bounds = cluster_bounds(p, plan, R)
    out = {}
    for name, fn, plain in (
            ("cluster_em_pair",
             lambda: cc.em_pair(theta, plan, p.reads, p.inv_denom),
             lambda: cc.em_pair_ref(theta, p.by_cid, p.by_tid, p.reads,
                                    p.inv_denom)),
            ("cluster_extrap_gain", lambda: cc.extrap_gain(*ex),
             lambda: cc.extrap_gain_ref(theta, t1, t2, rs, vs, p.by_cid,
                                        p.by_tid, p.reads, p.eumaps,
                                        p.inv_denom))):
        host = measure.host_ms(fn)
        out[name] = {"err": 0.0, "ms": measure.device_ms(
            fn, host_per_call_ms=host), "host_ms": host,
            "plain_ms": measure.device_ms(plain, n=20), "library_ms": None,
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
    block = {"cluster_ms": graph_ms(lambda: _squarem_cycles(
        p, theta, N_ITERS, plan)),
        "launches_ms": graph_ms(lambda: _squarem_cycles(
            p, theta, N_ITERS, None))}
    C, T, E = p.by_cid.n_groups, p.by_tid.n_groups, p.by_cid.idx.shape[0]
    log(f"csr_cluster {label} {str(theta.dtype)[6:]} R={R} C={C} T={T} "
        f"E={E}, {plan.n_tiles} tiles of clusters of {plan.cluster} "
        f"blocks, {plan.rows} row(s) a cluster, {plan.smem} B of shared "
        f"memory a block: cluster_em_pair (from theta and from an accept), "
        f"cluster_extrap_gain and {N_ITERS} cycles bit-equal to their "
        f"plain versions ({n_nan} NaN gain terms); " + "; ".join(
            f"{k} {m['ms']:.5f} ms on the card ({m['bound_ms'] / m['ms']:.1%}"
            f" of its bound {m['bound_ms']:.5f} ms, {m['bound_by']}), "
            f"{m['host_ms']:.4f} ms host, plain {m['plain_ms']:.4f} ms"
            for k, m in out.items())
        + f"; {N_ITERS} cycles from a graph {block['cluster_ms']:.4f} ms "
        f"on clusters, {block['launches_ms']:.4f} ms off clusters")
    out["plan"] = {"tiles": plan.n_tiles, "cluster": plan.cluster,
                   "rows": plan.rows, "smem_bytes": plan.smem}
    out["block"] = block
    return out


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


def phase_cluster_sweep(dev) -> dict:
    """The crossovers of the CSR cycle's paths
    (``emsar_tpu_torch.bench.cluster_sweep``): random CSR problems of
    modules from 10,000 to 11.5 M edges at R 1 (float64), and some at R 3,
    R 16 and in float32, each a block's eight cycles on clusters and as
    twelve launches a cycle, bit-equal and timed from CUDA graphs.  Then
    the launch path through ``solver.solve``, a user's entry point: on a
    problem above ``CLUSTER_MAX_EDGES`` (four blocks), and, unforced, on
    the sweep's modules with one module above the 8-block cluster's limit
    (``bench.cycle_ab.oversized_problem``: no tile plan; to its
    convergence), each with em_step, pair_gain, cycle_extrap,
    cycle_select and block_end launched and the cluster kernels not; the
    second's ms per replayed block (``bench.cycle_ab.solve_ms``); the
    csr_cycle kernels at both shapes (``check_csr_cycle``).  Returns what
    it measured."""
    import numpy as np
    import torch

    from emsar_tpu_torch.bench import cluster_sweep as cs
    from emsar_tpu_torch.bench.cycle_ab import oversized_problem
    from emsar_tpu_torch.model import solver
    out = {"sweeps": [cs.sweep(dev, R=1, log=log)]}
    for R, dt, sizes in ((3, torch.float64, (25_000, 90_000, 360_000)),
                         (16, torch.float64, (25_000, 90_000, 360_000)),
                         (1, torch.float32, (90_000, 720_000))):
        out["sweeps"].append(cs.sweep(dev, sizes, R=R, dtype=dt, log=log))
    out["tilings"] = cs.tilings(dev, log=log)
    out["row_layouts"] = cs.row_layouts(dev, log=log)
    out["largest_module"] = [cs.largest_module(dt) for dt in (
        torch.float64, torch.float32)]
    log(f"the largest module of the sweep's shape a cluster of 8 blocks "
        f"stages: {out['largest_module']}")
    log(f"cluster sweep: the cluster path faster up to "
        f"{out['sweeps'][0]['crossover_edges']} edges at R 1 (the largest "
        f"size measured {out['sweeps'][0]['sizes'][-1]['edges']}); "
        f"CLUSTER_MAX_EDGES {solver.CLUSTER_MAX_EDGES}")
    rng = np.random.default_rng(7)
    problem = cs.random_problem(rng, solver.CLUSTER_MAX_EDGES * 101 // 100)
    E = len(problem.edge_cid)
    reset_launches()
    _, ll, it = solver.solve(problem, dev, max_iters=N_ITERS * 3 * 4,
                             dtype=np.float64)
    launched = read_launches()
    log(f"CSR solve above the crossovers ({E} edges): {it} blocks, logL "
        f"{ll!r}, launches {launched}")
    if (E <= solver.CLUSTER_MAX_EDGES
            or min(launched[k] for k in ("em_step", "pair_gain",
                                         "cycle_extrap", "cycle_select",
                                         "block_end")) <= 0
            or launched["cluster_em_pair"] or not np.isfinite(ll)):
        raise AssertionError("the solve above the crossovers did not take "
                             "the twelve launches")
    out["above"] = {"edges": E, "blocks": it, "launches": launched}
    p = solver.problem_to_device(problem, dev, torch.float64)
    th = torch.as_tensor(solver.read_attribution_start(problem))[None].to(dev)
    out["above"]["csr_cycle"] = check_csr_cycle(p, th, "above the "
                                                "crossovers")
    del p, th
    # one module too large for a cluster sends the whole problem to the
    # launches
    from emsar_tpu_torch.bench.cycle_ab import solve_ms
    problem = oversized_problem()
    p = solver.problem_to_device(problem, dev, torch.float64)
    if solver.cycle_plan(p, 1) is not None:
        raise AssertionError("the oversized module found a tile plan")
    reset_launches()
    _, ll, it = solver.solve(problem, dev, dtype=np.float64)
    launched = read_launches()
    E = len(problem.edge_cid)
    th = torch.as_tensor(solver.read_attribution_start(problem))[None].to(dev)
    timed = solve_ms(solver, p, th)
    over = {"edges": E, "segments": len(problem.eumaps),
            "transcripts": problem.n_transcripts, "blocks": it,
            "launches": launched, **timed["median"]}
    log(f"CSR solve with one module above the 8-block cluster's limit "
        f"({E} edges, unforced: no tile plan): {it} blocks, logL {ll!r}, "
        f"launches {launched}; {over['replay_ms_per_block']:.4f} ms a "
        f"replayed block, first block {over['first_block_ms']:.3f} ms, "
        f"capture {over['capture_ms']:.3f} ms ({timed['blocks']} blocks a "
        f"solve, medians of {len(timed['runs'])})")
    if (it != timed["blocks"] or min(launched[k] for k in (
            "em_step", "pair_gain", "cycle_extrap", "cycle_select",
            "block_end")) <= 0
            or launched["cluster_em_pair"] or not np.isfinite(ll)):
        raise AssertionError("the solve with an oversized module did not "
                             "take the launch path")
    over["csr_cycle"] = check_csr_cycle(p, th, "oversized module")
    out["oversized"] = over
    return out


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
    and float32; the CSR cycle's kernels (``check_csr_cycle``) there and
    at the restart rounds' shape (R 3 on ``restart_problem``'s problem
    from ``restart_inits``' draws, float64 and float32).  Returns
    ({kernel: measured}, the SolverProblem); the segment-sum times are the
    two sums' together, its host time their mean."""
    import numpy as np
    import torch

    from emsar_tpu_torch.model.quantify import restart_problem
    from emsar_tpu_torch.model.solver import (build_problem, problem_to_device,
                                              read_attribution_start,
                                              restart_inits)
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
    check_csr_cycle(p32, theta.float(), "main path")
    cycle = check_csr_cycle(p, theta, "main path")
    cluster = check_csr_cluster(p, theta, "main path")
    # the restart rounds' shape: R 3 on the restricted problem
    sub = restart_problem(problem)[0]
    for np_dt, dt in ((np.float64, torch.float64),
                      (np.float32, torch.float32)):
        inits = torch.as_tensor(restart_inits(sub, 3, 0, np_dt)).to(dev)
        ps = problem_to_device(sub, dev, dt)
        check_csr_cycle(ps, inits, "restart rounds R=3")
        check_csr_cluster(ps, inits, "restart rounds R=3")
    measured = {"segment_sum": seg, "em_step": em,
                "block_end": cycle["block_end"], "csr_cycle_main": cycle,
                "cluster_em_pair": cluster["cluster_em_pair"],
                "cluster_extrap_gain": cluster["cluster_extrap_gain"],
                "cluster_plan": cluster["plan"],
                "cluster_block": cluster["block"]}
    return measured, problem


def _profiled(run):
    """(``run()``'s result, wall seconds, device kernels, device busy
    seconds) of one ``run()`` under torch.profiler: the kernels the card
    ran and their summed time (a graph's kernels each count)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    return out, wall, len(kernels), busy_s


def phase_csr_profile(problem, dev) -> dict:
    """The CSR solve of the main path on the card, its blocks replayed
    from a CUDA graph (``model/loop.py``) through ``solver.solve``'s own
    dispatch (the cycles on clusters below ``CLUSTER_MAX_EDGES``): it must
    stop after CSR_BLOCKS blocks at CSR_LOGL's solve, and launch the
    cluster kernels; then, after a warm solve, the whole solve timed (ms
    per block, host clock around work that ends in a sync), counted (the
    port's kernel launches and every kernel the profiler saw, per block
    run) and profiled (device busy share: kernel time on the card over the
    wall time of the solve, torch.profiler), on clusters and, forced, as
    twelve launches a cycle."""
    import numpy as np
    import torch

    from emsar_tpu_torch.model import loop
    from emsar_tpu_torch.model.solver import (clear_plans, cycle_plan,
                                              em_solve, problem_to_device,
                                              read_attribution_start, solve)
    for skip, want in ((False, CSR_BLOCKS), (True, CSR_BLOCKS_REPAIRED)):
        reset_launches()
        _, ll, blocks = solve(problem, dev, dtype=np.float64,
                              skip_unread=skip)
        cluster_launches = {k: v for k, v in read_launches().items()
                            if k.startswith("cluster")}
        gain = "repaired" if skip else "jax"
        log(f"CSR solve ({gain} gain): {blocks} blocks (want {want}), "
            f"stop {loop.LAST.stop}, logL {ll!r}, cluster launches "
            f"{cluster_launches}")
        if want is not None and blocks != want:
            raise AssertionError(f"the CSR solve ({gain} gain) took "
                                 f"{blocks} blocks, not {want}")
        if skip and loop.LAST.stop != "converged":
            raise AssertionError(f"the CSR solve ({gain} gain) stopped on "
                                 f"{loop.LAST.stop}")
        if min(cluster_launches.values()) <= 0:
            raise AssertionError("the CSR solve did not run on clusters")
    p = problem_to_device(problem, dev, torch.float64)
    th0 = torch.as_tensor(read_attribution_start(problem))[None].to(dev)
    cycle_plan(p, 1, clusters=True)
    clear_plans()
    t0 = time.perf_counter()
    plan = cycle_plan(p, 1, clusters=True)
    made = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cycle_plan(p, 1, clusters=True)
    out = {"plan": {"host_ms": made,
                    "cached_host_ms": (time.perf_counter() - t0) * 1e3,
                    "tiles": plan.n_tiles, "cluster": plan.cluster,
                    "rows": plan.rows, "smem_bytes": plan.smem,
                    "bytes": plan.nbytes()}}
    log(f"CSR solve's tile plan: {out['plan']} (host ms to make it, and to "
        f"take it from the plan cache as the timed solves below do)")
    for path, clusters in (("cluster", True), ("launches", False)):
        def run():
            res = em_solve(p, th0, 1e-9, N_ITERS, 200000, clusters=clusters)
            torch.cuda.synchronize()
            return res

        run()
        reset_launches()
        t0 = time.perf_counter()
        _, _, it = run()
        wall = time.perf_counter() - t0
        stats = loop.LAST
        per_block = sum(read_launches().values()) / stats.blocks_run
        _, prof_wall, n_kernels, busy_s = _profiled(run)
        out[path] = {
            "blocks": it, "blocks_run": stats.blocks_run,
            "ms_per_block": wall * 1e3 / it, "solve_ms": wall * 1e3,
            "capture_ms": stats.capture_s * 1e3,
            "port_kernel_launches_per_block": per_block,
            "device_kernels_per_block": n_kernels / stats.blocks_run,
            "device_busy_share": busy_s / prof_wall,
            "profiled_wall_s": prof_wall}
        log(f"CSR solve on the card (graph loop, {path}): {out[path]}")
    return out


def phase_cycle_ab(rsh: str, aln: str, dev) -> dict:
    """``bench.cycle_ab`` on this checkout alone (no parent) at the
    smoke's CSR shapes and on the oversized module's problem: the block
    end, pair_gain, eight cycles of ten and of twelve launches (bit-equal)
    and the oversized problem's solve, timed.  Returns what it
    measured."""
    from emsar_tpu_torch.bench import cycle_ab
    return cycle_ab.run(dev, cycle_ab.cases(rsh, aln, large=False),
                        log=log)


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
    return {"wall_s": wall, "peak_bytes": peak, "n_multi": index.n_multi,
            "phases_s": groups, "bp": n_bp,
            "window_hash_ms": wh_times[True][0],
            "window_hash_plain_ms": wh_times[True][1],
            "window_hash_ss_ms": list(wh_times[False]),
            "rsh_check_s": check_s}


def pe_smoke_fixture():
    """(names, seqs, smoke FASTA, wide FASTA) of the PE build checks: a
    PE_SMOKE_GENES-gene family transcriptome, and its first PE_WIDE_GENES
    genes for the wide fragment range (written under CACHE)."""
    import numpy as np

    from emsar_tpu_torch.bench.pe_fixture import PE_SEED
    from emsar_tpu_torch.sim import gene_family_transcriptome

    os.makedirs(CACHE, exist_ok=True)
    names, seqs, genes = gene_family_transcriptome(
        np.random.default_rng(PE_SEED + 1), PE_SMOKE_GENES)
    fa = os.path.join(CACHE, "pe_smoke.fa")
    fa_wide = os.path.join(CACHE, "pe_wide.fa")
    write_fasta(fa, names, seqs)
    k = sum(int(g[1:]) < PE_WIDE_GENES for g in genes)
    write_fasta(fa_wide, names[:k], seqs[:k])
    return fa, fa_wide


def random_pe_tables(rng, S: int, rl: int, n_members: int, dev):
    """Random PE tables of a sequence of S + 1 positions (ranks, 10% of
    them invalid, their flip, tids, separators every ~300 positions) and
    n_members members anywhere in [0, S], past the rank and tid tables'
    ends too, with sorted ranks in clusters of one to a few members; a
    quarter of the members carry the rank R[p] instead: (spos, srank, R,
    RF, t32, nsep)."""
    import numpy as np
    import torch

    from emsar_tpu_torch.kernels.pe_candidates import BIG_RANK
    n_rank = S - rl + 1
    R = rng.integers(0, 1 << 29, n_rank)
    R[rng.random(n_rank) < 0.1] = BIG_RANK
    t32 = np.sort(rng.integers(0, 1 << 23, n_rank))
    sep = np.unique(np.concatenate([rng.integers(0, S, S // 300), [S]]))
    nsep = sep[np.searchsorted(sep, np.arange(S + 1))]
    mpos = rng.integers(0, S + 1, n_members)
    mrank = np.sort(rng.integers(0, n_members // 2, n_members)) << 8
    own = (rng.random(n_members) < 0.25) & (mpos < n_rank)
    mrank[own] = np.minimum(R[mpos[own]], (1 << 29) - 1)
    return tuple(torch.as_tensor(a.astype(np.int32)).to(dev)
                 for a in (mpos, mrank, R, R[::-1].copy(), t32, nsep))


def check_pe_candidates(args, label: str, n_time: int = 20,
                        capacity=None) -> dict:
    """pe_candidates against its plain version on the card: the same bits
    (tolerance 0) in the written keys and payloads, their count and the
    singleton counts.  Times the kernel's launch (device and host ms) and
    the plain version; the bound is ``pe_candidates.bytes_moved`` of this
    call's written candidates and changed singleton entries.  Returns what
    it measured."""
    import torch

    from emsar_tpu_torch.kernels import measure
    from emsar_tpu_torch.kernels import pe_candidates as kpe
    spos, srank, lo, hi, tn, nfl, unstranded = (args[0], args[1], args[2],
                                                args[3], args[6], args[8],
                                                args[12])
    # past 2^24 entries (random tids up to 2^23) the index is dropped, by
    # the kernel and by the plain version
    n_single = min((int((tn & 0xFFFFFFFF).max()) + 1) * nfl, 1 << 24)
    single = torch.zeros(n_single, dtype=torch.int64, device=spos.device)
    got = kpe.pe_candidates(*args, single, capacity=capacity)
    torch.cuda.synchronize()
    want_single = torch.zeros_like(single)
    want = kpe.pe_candidates_ref(*args, want_single, capacity=capacity)
    n_written, n_kept = want[0].shape[0], int(want_single.sum())
    n_entries = int(torch.count_nonzero(want_single))
    n_bad = int((single != want_single).sum())
    if got[0].shape[0] != n_written:
        n_bad += 1 + abs(got[0].shape[0] - n_written)
    else:
        n_bad += int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
    n_sng = int(kpe.singleton_members(srank, lo, hi).sum())
    del got, want, want_single

    def kernel():
        return kpe.launch(*args, single, capacity=capacity)

    host = measure.host_ms(kernel, n=n_time)
    k_ms = measure.device_ms(kernel, n=n_time, host_per_call_ms=host)
    p_ms = measure.device_ms(lambda: kpe.pe_candidates_ref(*args, single),
                             n=2)
    n_bytes = kpe.bytes_moved(spos[lo:hi], nfl, unstranded, n_written,
                              n_entries)
    bound, by = measure.bound_ms(n_bytes, 0)
    log(f"pe_candidates {label}: {hi - lo} members ({n_sng} singleton) x "
        f"{nfl}, {n_written} written, {n_kept} singleton slots counted "
        f"into {n_entries} entries, "
        f"{n_bad} keys, payloads or counts differ from the plain version; "
        f"kernel {k_ms:.4f} ms on the card, {host:.4f} ms host per call; "
        f"plain {p_ms:.4f} ms; bound {bound:.4f} ms ({by}, {n_bytes} B), "
        f"share {bound / k_ms:.1%}")
    if n_bad or n_written + n_kept == 0:
        raise AssertionError(f"pe_candidates {label}: {n_bad} differ from "
                             f"the plain version ({n_written} written, "
                             f"{n_kept} counted)")
    return {"err": float(n_bad), "ms": k_ms, "host_ms": host,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "written": n_written, "kept": n_kept,
            "entries": n_entries}


def pe_tables(fa: str, rl: int, unstranded: bool, dev):
    """The PE build's tables of a FASTA on the card: (ref, t32, nsep, R,
    RF or None, rank-sorted positions, their ranks)."""
    from emsar_tpu_torch.index.device_build import DeviceRef
    from emsar_tpu_torch.index.device_build_pe import rank_pass
    from emsar_tpu_torch.io.fasta import read_fasta
    ref = DeviceRef(read_fasta(fa, "E"), dev)
    t32, nsep = ref.t32(rl), ref.nsep()
    R, spos, srank = rank_pass(ref, t32, rl, unstranded, 0)
    return (ref, t32, nsep, R, R.flip(0).contiguous() if unstranded
            else None, spos, srank)


def phase_pe_kernel_check(fa: str, dev) -> None:
    """pe_candidates against its plain version on random tables and on the
    PE smoke transcriptome's tables at l101: ns and ssfr, d0 0 and 189,
    nfl 1, 11 and 400; bit-equal, with times and bounds."""
    import numpy as np
    import torch

    from emsar_tpu_torch.kernels.pe_candidates import pack_tables
    rl = 101
    for unstranded in (True, False):
        tab = pe_tables(fa, rl, unstranded, dev)
        ref, t32, nsep, R, RF, spos, srank = tab
        tn = pack_tables(t32, nsep)
        mpos, mrank, Rr, RFr, tr, nr = random_pe_tables(
            np.random.default_rng(int(unstranded)), 1 << 22, rl, 1 << 16,
            dev)
        tnr = pack_tables(tr, nr)
        for d0, nfl in itertools.product((0, 189), (1, 11, 400)):
            strand = "ns" if unstranded else "ssfr"
            check_pe_candidates(
                (spos, srank, 0, spos.shape[0], R, RF, tn, d0, nfl, rl,
                 ref.borderpos, ref.seqlength, unstranded),
                f"smoke {strand} d0 {d0}", 5)
            check_pe_candidates(
                (mpos, mrank, 1, mpos.shape[0] - 1, Rr,
                 RFr if unstranded else None, tnr, d0, nfl, rl, (1 << 21),
                 1 << 22, unstranded),
                f"random {strand} d0 {d0}", 5)
        del tab, ref, t32, nsep, tn, R, RF, spos, srank
        del mpos, mrank, Rr, RFr, tr, nr, tnr
        torch.cuda.empty_cache()


def phase_pe_build_smoke(fa: str, fa_wide: str, out_root: str) -> None:
    """``emsar-build-torch --PE`` on the card against the port's NumPy PE
    builder: l101 F290-300 ns and ssfr on the PE smoke transcriptome, and
    F1-400 ns on its first genes; every .rsh byte-equal."""
    from emsar_tpu_torch.config import BuildConfig, StrandType
    from emsar_tpu_torch.index.build import build_pe_index
    from emsar_tpu_torch.io.fasta import read_fasta
    from emsar_tpu_torch.utils.timing import phase_times, reset_phases
    from emsar_tpu_torch.cli import emsar_build

    out = os.path.join(out_root, "pe_build")
    for strand, fmin, fmax, fasta in (("ns", 290, 300, fa),
                                      ("ssfr", 290, 300, fa),
                                      ("ns", 1, 400, fa_wide)):
        name = f"{os.path.basename(fasta)[:-3]}_{strand}_F{fmin}-{fmax}"
        cfg = BuildConfig(pe=True, strand=StrandType.parse(strand, True),
                          min_fraglength=fmin, max_fraglength=fmax,
                          verbose=0)
        t0 = time.perf_counter()
        want = os.path.join(out, name + ".numpy.rsh")
        os.makedirs(out, exist_ok=True)
        build_pe_index(read_fasta(fasta, "E"), 101, cfg,
                       backend="numpy").write_text(want)
        t_np = time.perf_counter() - t0
        reset_phases()
        reset_launches()
        t0 = time.perf_counter()
        rc = emsar_build.main(["-q", "--PE", "-s", strand, "-f", str(fmin),
                               "-F", str(fmax), fasta, "101", out, name])
        wall = time.perf_counter() - t0
        launches = read_launches()
        if rc != 0:
            raise AssertionError(f"emsar-build-torch --PE {name} exited {rc}")
        with open(want, "rb") as a, open(os.path.join(out, name + ".rsh"),
                                         "rb") as b:
            same = a.read() == b.read()
        log(f"PE build {name} on the card: {wall:.2f} s (NumPy builder "
            f"{t_np:.1f} s), launches {launches}, .rsh byte-equal to the "
            f"NumPy builder's {same}; phases "
            + ", ".join(f"{k} {v:.3f}" for k, v in phase_times().items()))
        if not same:
            raise AssertionError(f"the card-built {name}.rsh differs from "
                                 f"the NumPy builder's")
        if launches["pe_candidates"] <= 0 or launches["window_hash"] <= 0:
            raise AssertionError(f"the PE build {name} skipped a kernel")


def _pe_loglik(rsh: str, bam: str, fpkm_cols):
    """logL of an .fpkm's FPKM column on the PE sample of ``bam``."""
    from emsar_tpu_torch.bench.pe_fixture import PE_FMAX, PE_FMIN
    from emsar_tpu_torch.config import QuantConfig
    from emsar_tpu_torch.ingest import native as native_mod
    from emsar_tpu_torch.io.rsh import RshIndex
    from emsar_tpu_torch.model.quantify import _host_loglik, prepare_sample
    from emsar_tpu_torch.model.solver import build_problem

    index = RshIndex.load(rsh)
    cfg = QuantConfig(verbose=0, pe=True, min_fraglength=PE_FMIN,
                      max_fraglength=PE_FMAX)
    counts = native_mod.NativeCollapser(index).collapse_file(
        bam, "bam", True, ord("+"), cfg.max_repeat, PE_FMIN, PE_FMAX,
        [index.readlength])
    x = prepare_sample(index, counts, cfg)
    problem = build_problem(x.graph, x.modules, x.eumaps, x.read_count)
    return _host_loglik(problem, fpkm_cols), counts.total_read_count


def phase_pe_fasta_path(out_root: str):
    """bench.py's PE shape through the port's CLI: ``emsar-torch --PE -B
    -s ssfr -f 290 -F 300 -R -x benchpe.fa`` on 500,000 fragments' exact
    alignments (a BAM the port writes), then ``emsar-torch -I`` on the
    written .rsh: logL rel 1e-9, gene iReadcount 1e-3, gene TPM rel 1e-3
    of max(TPM, 1), .fraglength_effect byte-equal.  Returns (the -x run's
    launches, its phase seconds, the FASTA)."""
    import numpy as np

    from emsar_tpu_torch.bench.pe_fixture import (
        PE_FMAX, PE_FMIN, PE_GENES, PE_PAIRS, PE_READLEN, PE_SEED,
        pe_alignments, write_pe_bam)
    from emsar_tpu_torch.io.fasta import build_transcriptome
    from emsar_tpu_torch.sim import gene_family_transcriptome
    from emsar_tpu_torch.utils.timing import phase_times, reset_phases
    from emsar_tpu_torch.cli import emsar as cli

    t0 = time.perf_counter()
    rng = np.random.default_rng(PE_SEED)
    names, seqs, _ = gene_family_transcriptome(rng, PE_GENES)
    fa = os.path.join(CACHE, "benchpe.fa")
    bam = os.path.join(CACHE, "benchpe.bam")
    write_fasta(fa, names, seqs)
    tx = build_transcriptome(names, seqs)
    n_rec = write_pe_bam(bam, names, [len(s_) for s_ in seqs],
                         *pe_alignments(tx, PE_READLEN, PE_FMIN, PE_FMAX,
                                        PE_PAIRS, rng), PE_READLEN)
    log(f"PE fixture: {PE_GENES} genes, {tx.n_transcripts} transcripts, "
        f"{tx.borderpos} bp, {PE_PAIRS} fragments as {n_rec} BAM records in "
        f"{time.perf_counter() - t0:.1f} s")
    flags = ["-q", "--PE", "-B", "-s", "ssfr", "-f", str(PE_FMIN), "-F",
             str(PE_FMAX)]
    outs = {k: os.path.join(out_root, k) for k in ("pe_x", "pe_I")}
    reset_phases()
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(flags + ["-R", "-x", fa, outs["pe_x"], "s", bam])
    wall = time.perf_counter() - t0
    launches = read_launches()
    seconds = dict(phase_times(), total=wall)
    if rc != 0:
        raise AssertionError(f"emsar-torch --PE -x exited {rc}")
    rsh = os.path.join(outs["pe_x"], "s.rsh")
    reset_phases()
    t0 = time.perf_counter()
    rc = cli.main(flags + ["-I", rsh, outs["pe_I"], "s", bam])
    wall_i = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"emsar-torch --PE -I exited {rc}")
    res = {}
    for k, out in outs.items():
        names_k, cols = _parse_fpkm(os.path.join(out, "s.0.fpkm"))
        if not np.isfinite(cols).all() or names_k != names:
            raise AssertionError(f"{k}: unexpected .fpkm")
        ll, n_reads = _pe_loglik(rsh, bam, cols[:, 0])
        with open(os.path.join(out, "s.0.fraglength_effect"), "rb") as fh:
            res[k] = (ll, _gene_sum(names, cols[:, 3]),
                      _gene_sum(names, cols[:, 5]), fh.read())
    (ll_x, irc_x, tpm_x, fl_x), (ll_i, irc_i, tpm_i, fl_i) = \
        res["pe_x"], res["pe_I"]
    rel = abs(ll_x - ll_i) / abs(ll_i)
    d_irc = float(np.abs(irc_x - irc_i).max())
    d_tpm = float((np.abs(tpm_x - tpm_i) / np.maximum(tpm_i, 1.0)).max())
    fpkm_same = all(open(os.path.join(o, "s.0.fpkm"), "rb").read()
                    == open(os.path.join(outs["pe_I"], "s.0.fpkm"),
                            "rb").read() for o in outs.values())
    log(f"PE -x run: {wall:.2f} s, launches {launches}, {n_reads} fragments "
        f"counted; -I run {wall_i:.2f} s; logL {ll_x!r} vs {ll_i!r} (rel "
        f"diff {rel:.3e}, tol 1e-9), gene iReadcount max abs diff "
        f"{d_irc:.3e} (tol 1e-3), gene TPM max rel diff {d_tpm:.3e} (tol "
        f"1e-3), .fraglength_effect equal {fl_x == fl_i}, .fpkm "
        f"byte-identical {fpkm_same}; phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    if rel > 1e-9 or d_irc > 1e-3 or d_tpm > 1e-3 or fl_x != fl_i:
        raise AssertionError("the PE -x run disagrees with the -I run")
    if n_reads < PE_PAIRS // 2:
        raise AssertionError(f"the PE sample counted {n_reads} fragments")
    for kernel in ("window_hash", "pe_candidates"):
        if launches[kernel] <= 0:
            raise AssertionError(f"the PE -x run never launched {kernel}")
    return launches, seconds, fa


def measure_pe_main_path(fa: str, dev) -> dict:
    """pe_candidates at the PE -x run's own chunks (of the ssfr l101
    F290-300 build, sized as the build sizes them): bit-equal to the plain
    version; times and bounds summed over the chunks, host ms per call
    their mean."""
    from emsar_tpu_torch.bench.pe_fixture import (PE_FMAX, PE_FMIN,
                                                  PE_READLEN)
    from emsar_tpu_torch.index.device_build_pe import chunk_budget, plan_chunks
    from emsar_tpu_torch.kernels.pe_candidates import pack_tables
    rl, nfl = PE_READLEN, PE_FMAX - PE_FMIN + 1
    ref, t32, nsep, R, RF, spos, srank = pe_tables(fa, rl, False, dev)
    tn = pack_tables(t32, nsep)
    bounds = plan_chunks(srank, nfl, chunk_budget(dev, ref.seqlength + 1))
    tot = {"err": 0.0, "ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "library_ms": None, "bound_by": "bytes"}
    for lo, hi, weight in bounds:
        m = check_pe_candidates(
            (spos, srank, lo, hi, R, None, tn, PE_FMIN - rl, nfl, rl,
             ref.borderpos, ref.seqlength, False),
            "main path (PE -x build, ssfr l101 F290-300)", capacity=weight)
        for k in ("ms", "plain_ms", "bound_ms"):
            tot[k] += m[k]
        tot["host_ms"] += m["host_ms"] / len(bounds)
        tot["err"] = max(tot["err"], m["err"])
    return tot


def check_pe_scale_counts(fa: str, index, dev, unstranded: bool) -> dict:
    """A scale PE .rsh (l101 F290-300) against candidate groups
    counted apart from the builder: per chunk of whole mate1 clusters,
    pe_candidates against its plain version (written candidates, their
    count, singleton counts), then ``torch.unique`` over the valid keys
    (mate1 rank, mate2 rank) of the full candidate grid
    (``pe_candidate_grid_ref``, every member, no singleton route) with
    each group's fragment lengths.  Per fragment length, the size-1 groups
    must number Σ single_euma, the kept groups (1 < size < max_repeat, one
    fragment length) Σ multi_euma, and their members Σ multi_euma x
    signature size.  Also the singleton members' share of the members and
    the valid candidates' share of the grid.  Raises on a difference;
    returns what it measured."""
    import numpy as np
    import torch

    from emsar_tpu_torch.config import BuildConfig
    from emsar_tpu_torch.index.device_build_pe import chunk_budget, plan_chunks
    from emsar_tpu_torch.kernels import measure
    from emsar_tpu_torch.kernels import pe_candidates as kpe

    t0 = time.perf_counter()
    rl, fmin, fmax = 101, 290, 300
    nfl, d0 = fmax - fmin + 1, fmin - rl
    max_repeat = BuildConfig().max_repeat
    ref, t32, nsep, R, RF, spos, srank = pe_tables(fa, rl, unstranded, dev)
    bp, sl = ref.borderpos, ref.seqlength
    n_single = index.n_transcripts * nfl
    tn = kpe.pack_tables(t32, nsep)
    del ref
    torch.cuda.empty_cache()
    bounds = plan_chunks(srank, nfl, min(chunk_budget(dev, sl + 1), 1 << 28))
    got = {k: torch.zeros(nfl, dtype=torch.int64, device=dev)
           for k in ("single", "groups", "members")}
    single = torch.zeros(n_single, dtype=torch.int64, device=dev)
    want_single = torch.zeros_like(single)
    n = {k: 0 for k in ("bad", "members", "singleton", "grid", "valid",
                        "written", "kept", "entries", "bytes")}
    k_ms, p_ms = 0.0, 0.0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for lo, hi, weight in bounds:
        args = (spos, srank, lo, hi, R, RF, tn, d0, nfl, rl, bp, sl,
                unstranded)
        before = want_single.clone()
        ev[0].record()
        keys, pay, count = kpe.launch(*args, single, capacity=weight)
        ev[1].record()
        want = kpe.pe_candidates_ref(*args, want_single, capacity=weight)
        ev[2].record()
        ev[2].synchronize()
        k_ms += ev[0].elapsed_time(ev[1])
        p_ms += ev[1].elapsed_time(ev[2])
        c = int(count)
        if c != want[0].shape[0]:
            n["bad"] += 1 + abs(c - want[0].shape[0])
        else:
            n["bad"] += int((keys[:c] != want[0]).sum()
                            + (pay[:c] != want[1]).sum())
        kept = int((want_single - before).sum())
        entries = int(torch.count_nonzero(want_single != before))
        n["members"] += hi - lo
        n["singleton"] += int(kpe.singleton_members(srank, lo, hi).sum())
        n["written"] += c
        n["kept"] += kept
        n["entries"] += entries
        n["bytes"] += kpe.bytes_moved(spos[lo:hi], nfl, unstranded, c,
                                      entries)
        del keys, pay, count, want, before
        keys, pay = kpe.pe_candidate_grid_ref(
            spos[lo:hi], srank[lo:hi], R, RF, t32, nsep, d0, nfl, rl, bp, sl,
            unstranded)
        n["grid"] += keys.shape[0]
        valid = keys != kpe.INVALID_KEY
        kv = keys[valid]
        dd = (pay[valid] & 0x1FF).to(torch.int64)
        del keys, pay, valid
        n["valid"] += kv.shape[0]
        _, inv, cnt = torch.unique(kv, return_inverse=True,
                                   return_counts=True)
        del kv
        G = cnt.shape[0]
        dmin = torch.full((G,), nfl, dtype=torch.int64, device=dev)
        dmin.scatter_reduce_(0, inv, dd, "amin")
        dmax = torch.zeros(G, dtype=torch.int64, device=dev)
        dmax.scatter_reduce_(0, inv, dd, "amax")
        del inv, dd
        kept = (cnt > 1) & (cnt < max_repeat) & (dmin == dmax)
        got["single"] += torch.bincount(dmin[cnt == 1], minlength=nfl)
        got["groups"] += torch.bincount(dmin[kept], minlength=nfl)
        got["members"].index_add_(0, dmin[kept], cnt[kept])
        del cnt, dmin, dmax, kept
    n["bad"] += int((single != want_single).sum())
    del R, RF, t32, nsep, tn, spos, srank, single, want_single
    torch.cuda.empty_cache()
    sizes = np.diff(index.sig_offsets)
    want = {"single": np.asarray(index.single_euma).sum(axis=0),
            "groups": np.asarray(index.multi_euma).sum(axis=0),
            "members": (np.asarray(index.multi_euma)
                        * sizes[:, None]).sum(axis=0)}
    checks = {k: np.array_equal(got[k].cpu().numpy(), want[k])
              for k in want}
    secs = time.perf_counter() - t0
    bound, _ = measure.bound_ms(n["bytes"], 0)
    shares = {"singleton_members": n["singleton"] / max(n["members"], 1),
              "valid": n["valid"] / max(n["grid"], 1),
              "written_of_valid": n["written"] / max(n["valid"], 1)}
    log(f"scale PE {'ns' if unstranded else 'ssfr'} .rsh against "
        f"torch.unique candidate groups: {n['members']} members in "
        f"{len(bounds)} chunks, singleton members "
        f"{shares['singleton_members']:.4f} of them; {n['grid']} "
        f"candidates in the grid, valid {shares['valid']:.4f} of them, {n['written']} written "
        f"({shares['written_of_valid']:.4f} of the valid), {n['kept']} "
        f"singleton slots counted into {n['entries']} entries (summed over "
        f"the chunks); {n['bad']} keys, payloads or counts "
        f"differ from the plain version (kernel {k_ms:.3f} ms, plain "
        f"{p_ms:.3f} ms in all, one launch a chunk; bound {bound:.3f} ms, "
        f"bytes); per fragment length "
        + ", ".join(f"{k} equal {v}" for k, v in checks.items())
        + f" (size-1 groups {int(want['single'].sum())}, kept groups "
        f"{int(want['groups'].sum())}); {secs:.1f} s")
    if n["bad"] or not all(checks.values()):
        raise AssertionError(f"the scale PE check failed: {n['bad']} "
                             f"differ, {checks}")
    return {"check_s": secs, "candidates": n["grid"], "kernel_ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound, "check_chunks": len(bounds),
            "members": n["members"], "written": n["written"],
            "singleton_slots": n["kept"], **shares}


def phase_scale_pe_build(dev, out_root: str, fa: str, strand: str) -> dict:
    """The PE l101 F290-300 build of the scale transcriptome on the card
    through ``emsar-build-torch --PE -s strand``: wall time, phases,
    chunks, peak device memory; then ``check_pe_scale_counts``.  Returns
    what it measured."""
    import torch

    from emsar_tpu_torch.io.rsh import RshIndex
    from emsar_tpu_torch.utils.timing import phase_times, reset_phases
    from emsar_tpu_torch.cli import emsar_build

    out = os.path.join(out_root, "scale_pe")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_phases()
    reset_launches()
    t0 = time.perf_counter()
    rc = emsar_build.main(["-q", "--PE", "-s", strand, "-f", "290", "-F",
                           "300", fa, "101", out, "scalepe"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"scale PE build exited {rc}")
    phases = {k: round(v, 3) for k, v in phase_times().items()}
    n_chunks = launches["pe_candidates"]  # one launch a chunk
    index = RshIndex.load(os.path.join(out, "scalepe.rsh"))
    log(f"scale build PE l101 F290-300 {strand}: {wall:.2f} s wall, peak "
        f"device memory {peak / 2**30:.2f} GiB, {n_chunks} chunks, n_multi "
        f"{index.n_multi}, launches {launches}; phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    if n_chunks <= 0 or index.n_multi <= 0:
        raise AssertionError("the scale PE build did not run as expected")
    torch.cuda.empty_cache()
    check = check_pe_scale_counts(fa, index, dev, strand == "ns")
    return {"wall_s": wall, "peak_bytes": peak, "chunks": n_chunks,
            "n_multi": index.n_multi,
            "phases_s": phases, **check}


def _sample_checks(index, counts, runs: dict):
    """Per sample (``counts``, its SampleCounts against ``index``) of the
    multisample runs ``runs`` ({name: out dir}): its problem's logL of
    each run's FPKM, gene iReadcount and gene TPM, and the
    .fraglength_effect and .fpkm bytes.  Returns ({name: [per-sample
    (logL, iReadcount, TPM, fl bytes, fpkm bytes)]}, the samples'
    problems)."""
    import numpy as np

    from emsar_tpu_torch.config import QuantConfig
    from emsar_tpu_torch.model.quantify import _host_loglik, prepare_sample
    from emsar_tpu_torch.model.solver import build_problem

    cfg = QuantConfig(verbose=0, min_fraglength=index.min_fraglength,
                      max_fraglength=index.max_fraglength)
    out = {name: [] for name in runs}
    problems = []
    for i, c in enumerate(counts):
        x = prepare_sample(index, c, cfg)
        problem = build_problem(x.graph, x.modules, x.eumaps, x.read_count)
        problems.append(problem)
        for name, d in runs.items():
            names, cols = _parse_fpkm(os.path.join(d, f"s.{i}.fpkm"))
            if not np.isfinite(cols).all() or names != index.names:
                raise AssertionError(f"{name} sample {i}: unexpected .fpkm")
            with open(os.path.join(d, f"s.{i}.fraglength_effect"),
                      "rb") as fh, open(os.path.join(d, f"s.{i}.fpkm"),
                                        "rb") as fp:
                out[name].append((_host_loglik(problem, cols[:, 0]),
                                  _gene_sum(names, cols[:, 3]),
                                  _gene_sum(names, cols[:, 5]), fh.read(),
                                  fp.read()))
    return out, problems


def phase_multisample(rsh: str, aln: str, out_root: str, dev):
    """Phase 13 (a) and (b): the 16-sample run as the per-sample loop and
    batched, checked; the batched solve against itself on the CPU and
    timed on the card; em_step at its shape.  Returns (what it measured,
    the batched solve's ShardedProblem on the card)."""
    import numpy as np
    import torch

    from emsar_tpu_torch.bench import MS_SAMPLES, batched_sample
    from emsar_tpu_torch.cli import emsar as cli
    from emsar_tpu_torch.config import QuantConfig
    from emsar_tpu_torch.model import loop, solver
    from emsar_tpu_torch.model.quantify import _host_loglik
    from emsar_tpu_torch.model.solver import gain_of
    from emsar_tpu_torch.parallel import mesh
    from emsar_tpu_torch.parallel.mesh import (_block, make_mesh,
                                               shard_problem, solve_sharded)
    from emsar_tpu_torch.utils.timing import phase_times, reset_phases

    t0 = time.perf_counter()
    index, paths, counts, b = batched_sample(rsh, aln)
    listfile = os.path.join(os.path.dirname(paths[0]), "ms.list")
    log(f"multisample: {MS_SAMPLES} samples split by read name, collapsed "
        f"and batched in {time.perf_counter() - t0:.1f} s")
    walls = {"loop": [], "batched": []}
    runs, launches, plans_made = {}, {}, {}
    # the batched solve's own launches, apart from the per-sample CSR
    # restart loops of the same run
    in_solve = []

    def counted_solve(*args, **kwargs):
        before = read_launches()
        plans = solver.PLANS_MADE
        out = solve_sharded(*args, **kwargs)
        in_solve.append({k: v - before[k] for k, v in
                         read_launches().items()})
        in_solve[-1]["plans_made"] = solver.PLANS_MADE - plans
        return out

    for name, rep in (("loop", 0), ("batched", 0), ("batched", 1),
                      ("loop", 1)):
        out = os.path.join(out_root, f"ms_{name}{rep}")
        flags = ["--batch_samples"] if name == "batched" else []
        reset_phases()
        reset_launches()
        solver.clear_plans()  # each run makes its own plans
        plans = solver.PLANS_MADE
        t0 = time.perf_counter()
        mesh.solve_sharded = counted_solve
        try:
            rc = cli.main(["-q", "-M", *flags, "-I", rsh, out, "s",
                           listfile])
        finally:
            mesh.solve_sharded = solve_sharded
        walls[name].append(time.perf_counter() - t0)
        if rc != 0:
            raise AssertionError(f"-M {name} run exited {rc}")
        runs[f"{name}{rep}"] = out
        launches.setdefault(name, read_launches())
        plans_made.setdefault(name, []).append(solver.PLANS_MADE - plans)
        phases = {}
        for k, v in phase_times().items():  # summed over the samples' files
            k = k.split(" /")[0]
            phases[k] = phases.get(k, 0.0) + v
        log(f"-M {name} run {rep}: {walls[name][-1]:.2f} s, launches "
            f"{read_launches()}, tile plans made {plans_made[name][-1]}; "
            f"phases " + ", ".join(
                f"{k} {v:.3f}" for k, v in phases.items()))
    solve_launches = in_solve[0]
    restart_plans = plans_made["batched"][0] - solve_launches.pop(
        "plans_made")
    log(f"-M batched: launches in its batched solve {solve_launches}, in "
        f"the whole run {launches['batched']}; tile plans made: "
        f"{plans_made['batched'][0] - restart_plans} by the batched solve, "
        f"{restart_plans} by the {MS_SAMPLES} samples' CSR restart loops")
    if restart_plans != 1:
        raise AssertionError(f"the {MS_SAMPLES} restart loops made "
                             f"{restart_plans} tile plans, not one")
    # its cycles run on clusters (a row's problem is below
    # CLUSTER_MAX_EDGES): em_step launches only above it
    if min(solve_launches[k] for k in ("block_end", "cluster_em_pair",
                                       "cluster_extrap_gain")) <= 0 or (
            solve_launches["pair_gain"] or solve_launches["cycle_select"]):
        raise AssertionError("the batched solve did not run on the cluster "
                             "kernels and block_end alone")
    res, problems = _sample_checks(index, counts, runs)
    cfg = QuantConfig(verbose=0)

    # the batched solve with each gain: on the CPU (the plain versions) as
    # the reference, on the card timed.  With the JAX package's gain both
    # stop on the first block's NaN, bit for bit the same blocks; with the
    # repaired one both run to a real stop, whose last blocks' gains, near
    # epsilon, the card's and the CPU's roundings may take across it a few
    # blocks apart: the logL must agree, and both stop converged
    solved = {}
    for gain in ("jax", "repaired"):
        for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
            sp = shard_problem(b.problem, b.R, make_mesh(device=d),
                               dtype=np.float64, eumaps_per_sample=b.E,
                               denom_per_sample=b.denom,
                               skip_unread=gain == "repaired")
            solve_sharded(sp, epsilon=cfg.epsilon, block_iters=N_ITERS)
            t0 = time.perf_counter()
            theta, ll, it = solve_sharded(sp, epsilon=cfg.epsilon,
                                          block_iters=N_ITERS)
            solved[gain, where] = (theta, ll, it, time.perf_counter() - t0,
                                   sp, loop.LAST.stop)
        _, ll_c, it_c, _, _, stop_c = solved[gain, "cpu"]
        _, ll_g, it_g, wall_g, _, stop_g = solved[gain, "card"]
        log(f"batched solve ({MS_SAMPLES} x {b.R.shape[1]} segments, "
            f"{len(b.problem.edge_cid)} edges, {b.problem.n_transcripts} "
            f"transcripts, f64, {gain} gain): card {it_g} blocks after the "
            f"first, stop {stop_g}, logL {ll_g!r}, {wall_g * 1e3:.1f} ms, "
            f"{wall_g * 1e3 / (it_g + 1):.3f} ms per block; CPU {it_c} "
            f"blocks, stop {stop_c}, logL {ll_c!r}")
        if abs(ll_g - ll_c) > 1e-9 * abs(ll_c) or (
                gain == "jax" and it_g != it_c) or (
                gain == "repaired" and not stop_g == stop_c == "converged"):
            raise AssertionError(f"the batched solve on the card disagrees "
                                 f"with the CPU ({gain} gain)")
    # the CLI's runs took the default gain
    theta_c = solved[cfg.solver_gain, "cpu"][0]
    _, _, it_g, wall_g, sp, _ = solved[cfg.solver_gain, "card"]
    ms_per_block = wall_g * 1e3 / (it_g + 1)
    # each sample's gain over the first loop block with either gain.  With
    # the JAX package's, one NaN ends every sample there, in both packages
    # (one stop test over the summed gain; tests/test_torch_mesh.py::
    # test_nan_gain_stops_the_batch_as_in_jax holds the port to emsar_tpu
    # on such a batch); the repaired gain has no NaN
    th1, s1, _ = _block(sp, sp.theta0, N_ITERS)
    s2 = _block(sp, th1, N_ITERS)[1]
    nans = {}
    for name, skip_unread in (("jax", False), ("repaired", True)):
        g = gain_of(sp.reads, sp.eumaps, s1, s2,
                    skip_unread).cpu().numpy()[:MS_SAMPLES]
        nans[name] = np.flatnonzero(np.isnan(g)).tolist()
        log(f"batched solve's first loop block, {name} gain: NaN in "
            f"samples {nans[name]}, the other samples' gains sum to "
            f"{float(np.nansum(g))!r} (epsilon {cfg.epsilon})")
    nan_samples = nans["jax"]
    if nans["repaired"]:
        raise AssertionError("the repaired gain was NaN")
    if nan_samples and solved["jax", "card"][2] != 1:
        raise AssertionError("a NaN block gain did not stop the batch")

    failed = []
    gaps = {"ll": 0.0, "tpm": 0.0, "irc": 0.0}
    for i in range(MS_SAMPLES):
        ll_ref = _host_loglik(problems[i], theta_c[i])
        ll_loop, irc_loop, tpm_loop, fl_loop, _ = res["loop0"][i]
        ll_bat, irc_bat, tpm_bat, fl_bat, fpkm_bat = res["batched0"][i]
        rel_ref = abs(ll_bat - ll_ref) / abs(ll_ref)
        gaps["ll"] = max(gaps["ll"], abs(ll_bat - ll_loop) / abs(ll_loop))
        gaps["tpm"] = max(gaps["tpm"], float(
            (np.abs(tpm_bat - tpm_loop) / np.maximum(tpm_loop, 1.0)).max()))
        d_irc = float(np.abs(irc_bat - irc_loop).max())
        gaps["irc"] = max(gaps["irc"], d_irc)
        same = (fl_loop == fl_bat and fpkm_bat == res["batched1"][i][4]
                and res["loop0"][i][4] == res["loop1"][i][4])
        if rel_ref > 1e-9 or d_irc > 1e-3 or not same:
            failed.append((i, rel_ref, d_irc, same))
    log(f"-M loop vs batched over {MS_SAMPLES} samples: max logL rel gap "
        f"{gaps['ll']:.3e}, gene TPM max rel gap {gaps['tpm']:.3e}, gene "
        f"iReadcount max abs diff {gaps['irc']:.3e} (tol 1e-3); "
        f".fraglength_effect equal, repeated runs' .fpkm byte-identical, "
        f"batched logL within 1e-9 of the CPU solve: "
        f"{'all' if not failed else failed}")
    if failed:
        raise AssertionError(f"multisample checks failed: {failed}")

    em = check_em_step(sp, sp.theta0, f"batched R={MS_SAMPLES} per-sample")
    cycle = check_csr_cycle(sp, sp.theta0,
                            f"batched R={MS_SAMPLES} per-sample")
    cluster = check_csr_cluster(sp, sp.theta0,
                                f"batched R={MS_SAMPLES} per-sample")
    return {"loop_s": min(walls["loop"]), "batched_s": min(walls["batched"]),
            "walls_s": walls, "batched_blocks": it_g,
            "batched_ms_per_block": ms_per_block,
            "batched_nan_gain_samples": nan_samples,
            "loop_vs_batched_gaps": gaps, "em_step_batched": em,
            "block_end_batched": cycle.pop("block_end"),
            "pair_gain_batched": cycle.pop("pair_gain"),
            "csr_cycle_batched": cycle,
            "cluster_em_pair_batched": cluster["cluster_em_pair"],
            "cluster_extrap_gain_batched": cluster["cluster_extrap_gain"],
            "cluster_batched_plan": cluster["plan"],
            "cluster_batched_block": cluster["block"],
            "batched_solve_launches": solve_launches,
            "batched_run_launches": launches["batched"],
            "plans_made": plans_made, "restart_plans": restart_plans}, sp


def _launch_world(argvs, label: str, dev, timeout: float = 300.0) -> list:
    """Run each argv as one rank of a world of len(argvs) processes on
    ``dev`` (gloo over 127.0.0.1, torch's environment; LOCAL_RANK 0 for
    every rank: they share the card).  Returns their standard outputs; raises, with every
    process stopped, when one fails or outlives ``timeout``."""
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = []
    for rank, argv in enumerate(argvs):
        # one intra-op thread a rank, as torchrun sets it
        env = dict(os.environ, PYTHONPATH=REPO, EMSAR_TORCH_DEVICE=dev.type,
                   RANK=str(rank), WORLD_SIZE=str(len(argvs)),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   LOCAL_RANK="0", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(argv, env=env, cwd=REPO, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{label}: rank {rank} exited "
                                 f"{p.returncode}:\n{err[-3000:]}")
    return [o for o, _ in outs]


def phase_distribution(rsh: str, aln: str, pe_fa: str, out_root: str,
                       dev) -> dict:
    """Phase 13 (c) and (d): --dist_merge_shards in one process and in two
    sharing the card, the sharded PE build in two.  Returns wall times and
    the sharded build's chunks."""
    import torch

    from emsar_tpu_torch.bench.multisample import split_by_qname
    from emsar_tpu_torch.cli import emsar as cli
    from emsar_tpu_torch.index.device_build_pe import plan_chunks

    def fpkm(d):
        with open(os.path.join(d, "s.0.fpkm"), "rb") as fh:
            return fh.read()

    flags = ["-q", "-M", "--dist_merge_shards", "-I", rsh]
    lists = {}
    for n in (MERGE_SHARDS, MERGE_SHARDS_2PROC):
        d = os.path.join(CACHE, f"shards{n}")
        split_by_qname(aln, d, "shard", n)
        lists[n] = os.path.join(d, "shard.list")
    out1 = os.path.join(out_root, "merge1")
    t0 = time.perf_counter()
    if cli.main(flags + [out1, "s", lists[MERGE_SHARDS]]) != 0:
        raise AssertionError("--dist_merge_shards in one process failed")
    wall1 = time.perf_counter() - t0
    # the whole-file run of the default route: on the card the smoke's
    # classes take the hand kernel, as the --solver_pallas run does
    same1 = fpkm(out1) == fpkm(os.path.join(out_root, "kernel"))
    torch.cuda.empty_cache()
    out2 = os.path.join(out_root, "merge2")
    t0 = time.perf_counter()
    _launch_world([[sys.executable, "-m", "emsar_tpu_torch.cli.emsar",
                    *flags, out2, "s", lists[MERGE_SHARDS_2PROC]]] * 2,
                  "--dist_merge_shards in two processes", dev)
    wall2 = time.perf_counter() - t0
    same2 = fpkm(out2) == fpkm(out1)
    log(f"--dist_merge_shards: one process over {MERGE_SHARDS} shards "
        f"{wall1:.2f} s, .fpkm byte-equal to the whole-file run {same1}; two "
        f"processes on the card over {MERGE_SHARDS_2PROC} shards {wall2:.2f} "
        f"s, byte-equal to one process's {same2}")
    if not (same1 and same2):
        raise AssertionError("a merge of shards changed the .fpkm bytes")

    # the sharded PE build: a chunk budget of a sixth of the candidates
    rl, nfl = 101, 11
    srank = pe_tables(pe_fa, rl, False, dev)[6]
    total = plan_chunks(srank, nfl, 1 << 62)[-1][2]
    budget = max(total // 6, 1)
    n_chunks = len(plan_chunks(srank, nfl, budget))
    del srank
    torch.cuda.empty_cache()
    launcher = (
        "import sys\n"
        "from emsar_tpu_torch.index import device_build_pe\n"
        f"device_build_pe.CHUNK_CANDIDATES = {budget}\n"
        "from emsar_tpu_torch.cli import emsar_build\n"
        "from emsar_tpu_torch.kernels import pe_candidates\n"
        "rc = emsar_build.main(sys.argv[1:])\n"
        "print('pe_candidates launches', pe_candidates.LAUNCHES)\n"
        "sys.exit(rc)\n")
    out = os.path.join(out_root, "pe_build_sharded")
    name = "pe_smoke_ssfr_F290-300"
    t0 = time.perf_counter()
    stdout = _launch_world(
        [[sys.executable, "-c", launcher, "-q", "--PE", "-s", "ssfr", "-f",
          "290", "-F", "300", pe_fa, str(rl), out, name]] * 2,
        "the sharded PE build", dev)
    wall_pe = time.perf_counter() - t0
    per_rank = [int(o.split("pe_candidates launches")[1].split()[0])
                for o in stdout]
    with open(os.path.join(out, name + ".rsh"), "rb") as a, open(
            os.path.join(out_root, "pe_build", name + ".rsh"), "rb") as b:
        same_pe = a.read() == b.read()
    log(f"sharded PE build (2 processes on the card, ssfr l101 F290-300, "
        f"budget {budget} of {total} candidates): {n_chunks} chunks planned, "
        f"{per_rank} launched per rank, {wall_pe:.2f} s; .rsh byte-equal to "
        f"the unsharded build {same_pe}")
    if (not same_pe or n_chunks < PE_SHARD_MIN_CHUNKS
            or sum(per_rank) != n_chunks or min(per_rank) <= 0):
        raise AssertionError("the sharded PE build failed its checks")
    return {"merge_1proc_s": wall1, "merge_2proc_s": wall2,
            "pe_sharded_s": wall_pe, "pe_sharded_chunks": n_chunks,
            "pe_sharded_launches_per_rank": per_rank}


def _bits(x):
    """float64 bit patterns of a tensor, array or float (NaN equals
    itself)."""
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64)).view(
        np.uint64)


def csr_block_bound_ms(p) -> float:
    """A CSR block's bound off clusters (twelve launches a cycle): 8
    cycles, then the block's end, each kernel of them at its own bound
    (its inputs read once, its outputs written once: ``bench.cycle_ab.
    kernel_bounds``) summed: per cycle cycle_select (not in the first),
    two em_step and one em_step_cycle (an EM step that also reads theta
    and writes r * r and v * v), the two row sums of those,
    cycle_extrap, pair_gain (writing both intensities in the last cycle)
    and the gain's row sum; then block_end and its row sum.  The loop's
    own bookkeeping (the masked state update, the stop test: a few
    scalars and two state copies) is left out.  ``p`` is a DeviceProblem,
    R = 1."""
    from emsar_tpu_torch.bench.cycle_ab import kernel_bounds
    from emsar_tpu_torch.kernels import measure
    dt = p.reads.dtype
    C, T = p.by_cid.n_groups, p.by_tid.n_groups
    item = p.reads.element_size()
    b = {k: v[0] for k, v in kernel_bounds(p, 1).items()}

    def bound(n_items, n_ops):
        return measure.bound_ms(item * n_items, n_ops, dt)[0]
    em_cycle = b["em_step"] + bound(3 * T, 5 * T)
    row_sums = 2 * bound(T + 1, T)
    gain_sum = bound(C + 1, C)
    cycle = (b["cycle_select"] + 2 * b["em_step"] + em_cycle + row_sums
             + b["cycle_extrap"] + b["pair_gain"] + gain_sum)
    return (N_ITERS * cycle - b["cycle_select"] - b["pair_gain"]
            + b["pair_gain intensities"] + b["block_end"] + gain_sum)


def csr_cluster_block_bound_ms(p) -> float:
    """A CSR block's bound on clusters, as ``csr_block_bound_ms`` counts
    it: per cycle cluster_em_pair, the two row sums, cluster_extrap_gain
    (writing both intensities in the last cycle) and the gain's row sum
    (``cluster_bounds``); then block_end and its row sum.  ``p`` is a
    DeviceProblem, R = 1."""
    from emsar_tpu_torch.bench.cycle_ab import kernel_bounds
    from emsar_tpu_torch.kernels import measure
    from emsar_tpu_torch.model.solver import cycle_plan
    dt = p.reads.dtype
    C, T = p.by_cid.n_groups, p.by_tid.n_groups
    item = p.reads.element_size()

    def bound(n_items, n_ops):
        return measure.bound_ms(item * n_items, n_ops, dt)[0]
    kernels = cluster_bounds(p, cycle_plan(p, 1, clusters=True), 1)
    cycle = (sum(b for b, _ in kernels.values()) + 2 * bound(T + 1, T)
             + bound(C + 1, C))
    return (N_ITERS * cycle + bound(2 * C, 0)
            + kernel_bounds(p, 1)["block_end"][0] + bound(C + 1, C))


def phase_loops(problem, x, sp, dev) -> dict:
    """Phase 14: the convergence loops on the card, each replayed from a
    CUDA graph against the plain loop (the stop flag read after every
    block, no capture: the parent's loop), on the main path's problems at
    full width: the CSR solve of phase 6 and its restart rounds (R = 3,
    ``restart_inits``' draws on ``restart_problem``'s problem), both dense
    size classes with torch.bmm and with ``squarem_block``, their restart
    rounds (R = 3, ``_make_rounds_dense``'s inits) and the 16-sample
    batched solve of phase 13.  Each must give the plain loop's theta,
    logL and block count bit for bit.  Per loop: ms per block both ways
    (after a warm solve each), the blocks the graph ran after the stop,
    the capture's ms, and the device busy share and kernels per block run
    of each (torch.profiler).  Returns what it measured."""
    import numpy as np
    import torch

    from emsar_tpu_torch.bench import MS_SAMPLES
    from emsar_tpu_torch.config import QuantConfig
    from emsar_tpu_torch.model import loop
    from emsar_tpu_torch.model.dense import (_dense_solve_pallas, _pad_b,
                                             _solve_loop, _theta0,
                                             batch_to_device,
                                             partition_modules, subset_batch)
    from emsar_tpu_torch.model.quantify import _restart_eps, restart_problem
    from emsar_tpu_torch.model.solver import (em_solve, problem_to_device,
                                              read_attribution_start,
                                              restart_inits)
    from emsar_tpu_torch.parallel.mesh import solve_sharded

    cfg = QuantConfig(verbose=0)
    eps = cfg.epsilon
    p = problem_to_device(problem, dev, torch.float64)
    th0 = torch.as_tensor(read_attribution_start(problem))[None].to(dev)
    sub = restart_problem(problem)[0]
    ps = problem_to_device(sub, dev, torch.float64)
    n_extra = cfg.num_round - 1
    ths = torch.as_tensor(restart_inits(sub, n_extra, 0, np.float64)).to(dev)
    cases = [("csr", lambda plain, c=None: em_solve(
        p, th0, eps, N_ITERS, 200000, plain=plain, clusters=c)),
             (f"csr restarts R={n_extra}", lambda plain, c=None: em_solve(
                 ps, ths, _restart_eps(cfg), N_ITERS, cfg.max_niter_mle,
                 plain=plain, clusters=c))]
    part = partition_modules(x.graph, x.modules, x.eumaps, x.read_count,
                             dtype=np.float64)
    rng = np.random.default_rng(np.uint64(0x5EED_0001))
    for batch in part.batches:
        cls = "x".join(map(str, batch.shape[1:]))
        padded = batch_to_device(_pad_b(batch)[0], dev, torch.float64)
        db = batch_to_device(batch, dev, torch.float64)
        cases.append((f"bmm {cls}", lambda plain, d=padded: _solve_loop(
            d, _theta0(d)[None], eps, N_ITERS, 2048, plain=plain)))
        cases.append((f"kernel {cls}", lambda plain, d=db: (
            _dense_solve_pallas(d, eps, N_ITERS, 2048, plain=plain))))
        rows = np.flatnonzero((batch.tid_map >= 0).sum(axis=1) >= 2)
        sub, nB = _pad_b(subset_batch(batch, rows))
        inits = rng.uniform(0.0, 100.0, size=(n_extra, nB, sub.shape[2]))
        inits = np.where(sub.tid_map[None, :nB] >= 0, inits, 0.0)
        inits = np.pad(inits, ((0, 0), (0, sub.shape[0] - nB), (0, 0)))
        dr = batch_to_device(sub, dev, torch.float64)
        tr = torch.as_tensor(inits).to(dev)
        cases.append((f"restarts {cls} R={n_extra}",
                      lambda plain, d=dr, t=tr: _solve_loop(
                          d, t, _restart_eps(cfg), N_ITERS, 2048,
                          plain=plain)))
    cases.append((f"batched S={MS_SAMPLES}", lambda plain, c=None:
                  solve_sharded(sp, epsilon=eps, block_iters=N_ITERS,
                                plain=plain, clusters=c)))
    # the CSR loops again, their cycles forced off clusters (twelve
    # launches)
    csr_loops = [cases[0][0], cases[1][0], cases[-1][0]]
    cases += [(f"{label} launches", lambda plain, fn=fn: fn(plain, False))
              for label, fn in cases if label in csr_loops]

    def result(out):
        """(theta, logL or None, blocks) of a solve's return."""
        return (out[0], None, out[1]) if len(out) == 2 else out

    measured, failed, graph_out = {}, [], {}
    for label, fn in cases:
        runs = {}
        for plain in (True, False):
            fn(plain)  # warm: the graph loop builds, captures, replays
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            out = result(fn(plain))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = read_launches()
            stats = loop.LAST
            _, prof_wall, n_kernels, busy_s = _profiled(lambda: fn(plain))
            runs["plain" if plain else "graph"] = (out, wall, stats, dict(
                busy_share=busy_s / prof_wall,
                kernels_per_block=n_kernels / stats.blocks_run,
                launches=launched))
        (pl, p_wall, _, p_prof), (gr, g_wall, g_st, g_prof) = (
            runs["plain"], runs["graph"])
        graph_out[label] = gr
        it = gr[2]
        same = (it == pl[2] and np.array_equal(_bits(gr[0]), _bits(pl[0]))
                and (gr[1] is None or np.array_equal(_bits(gr[1]),
                                                     _bits(pl[1]))))
        m = {"blocks": it, "graph_ms_per_block": g_wall * 1e3 / it,
             "plain_ms_per_block": p_wall * 1e3 / it,
             "graph_solve_ms": g_wall * 1e3, "plain_solve_ms": p_wall * 1e3,
             "blocks_after_stop": g_st.blocks_run - it,
             "flag_reads": g_st.reads, "capture_ms": g_st.capture_s * 1e3,
             "graph_busy_share": g_prof["busy_share"],
             "plain_busy_share": p_prof["busy_share"],
             "graph_kernels_per_block": g_prof["kernels_per_block"],
             "plain_kernels_per_block": p_prof["kernels_per_block"],
             "graph_launches": g_prof["launches"], "bit_equal": same}
        if label == "csr":
            m["bound_ms_per_block"] = csr_cluster_block_bound_ms(p)
        if label == "csr launches":
            m["bound_ms_per_block"] = csr_block_bound_ms(p)
        measured[label] = m
        log(f"loop {label}: {it} blocks; graph {m['graph_ms_per_block']:.4f}"
            f" ms a block ({g_wall * 1e3:.2f} ms, capture "
            f"{m['capture_ms']:.2f} ms, {m['blocks_after_stop']} blocks after "
            f"the stop, {g_st.reads} flag reads, busy "
            f"{m['graph_busy_share']:.3f}, "
            f"{m['graph_kernels_per_block']:.1f} kernels a block); plain "
            f"{m['plain_ms_per_block']:.4f} ms a block ({p_wall * 1e3:.2f} "
            f"ms, busy {m['plain_busy_share']:.3f}, "
            f"{m['plain_kernels_per_block']:.1f} kernels a block); theta, "
            f"logL and blocks bit-equal {same}")
        if not same:
            failed.append(label)
    for label in csr_loops:  # on clusters against twelve launches
        a, b = graph_out[label], graph_out[f"{label} launches"]
        same = (a[2] == b[2] and np.array_equal(_bits(a[0]), _bits(b[0]))
                and (a[1] is None or np.array_equal(_bits(a[1]),
                                                    _bits(b[1]))))
        measured[label]["bit_equal_to_launches"] = same
        log(f"loop {label}: on clusters and as twelve launches a cycle, "
            f"theta, logL and blocks bit-equal {same}")
        if not same:
            failed.append(f"{label} on clusters")
    if failed:
        raise AssertionError(f"graph loops differ from the plain loop or "
                             f"the launch path: {failed}")
    return measured


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
    from emsar_tpu_torch.bench import MS_SAMPLES
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
    sweep = phase_cluster_sweep(dev)
    log(f"cluster sweep: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    fa, rsh, aln = ensure_fixture()
    log(f"fixture: {time.perf_counter() - t0:.1f} s")
    measured = {"window_hash": phase_window_hash_check(fa, dev)}

    out_root = os.path.join(CACHE, "out")
    launches, seconds, sample = phase_main_path(rsh, aln, out_root)
    stops = dense_stops(sample, dev)
    measured["squarem_block"] = phase_main_path_shapes(sample, dev)
    csr_measured, problem = phase_segment_sum_main(sample, dev)
    measured.update(csr_measured)
    csr_blocks = phase_csr_profile(problem, dev)
    t0 = time.perf_counter()
    cycle_ab = phase_cycle_ab(rsh, aln, dev)
    seconds["cycle_ab"] = {"total": time.perf_counter() - t0}
    build_launches = phase_build_smoke(fa, rsh, out_root)
    phase_fasta_path(fa, aln, out_root, sample)

    t0 = time.perf_counter()
    pe_fa, pe_fa_wide = pe_smoke_fixture()
    phase_pe_kernel_check(pe_fa, dev)
    log(f"PE kernel check: {time.perf_counter() - t0:.1f} s")
    phase_pe_build_smoke(pe_fa, pe_fa_wide, out_root)
    pe_launches, pe_seconds, bench_pe_fa = phase_pe_fasta_path(out_root)
    measured["pe_candidates"] = measure_pe_main_path(bench_pe_fa, dev)
    seconds["pe_x"] = pe_seconds

    scale = phase_scale_build(dev, out_root)
    scale_fa = os.path.join(out_root, "scale.fa")
    scale_pe = {strand: phase_scale_pe_build(dev, out_root, scale_fa, strand)
                for strand in ("ssfr", "ns")}
    os.remove(scale_fa)

    t0 = time.perf_counter()
    multisample, batched_sp = phase_multisample(rsh, aln, out_root, dev)
    multisample.update(phase_distribution(rsh, aln, pe_fa, out_root, dev))
    seconds["multisample"] = {"total": time.perf_counter() - t0}
    log(f"multisample and distribution: {seconds['multisample']['total']:.1f}"
        f" s")

    t0 = time.perf_counter()
    loops = phase_loops(problem, sample, batched_sp, dev)
    seconds["loops"] = {"total": time.perf_counter() - t0}
    log(f"convergence loops: {seconds['loops']['total']:.1f} s")
    log(f"all phases: {time.perf_counter() - t_start:.1f} s")

    main_launches = {"squarem_block": launches["kernel"]["squarem_block"],
                     "segment_sum": launches["csr"]["segment_sum"],
                     "em_step": sweep["above"]["launches"]["em_step"],
                     "window_hash": build_launches["window_hash"],
                     "pe_candidates": pe_launches["pe_candidates"],
                     "pair_gain": sweep["oversized"]["launches"]["pair_gain"],
                     "block_end": launches["csr"]["block_end"],
                     "cycle_extrap": sweep["above"]["launches"]["cycle_extrap"],
                     "cycle_select": sweep["above"]["launches"]["cycle_select"],
                     "cluster_em_pair": launches["csr"]["cluster_em_pair"],
                     "cluster_extrap_gain":
                         launches["csr"]["cluster_extrap_gain"]}
    # em_step, pair_gain, cycle_extrap and cycle_select run off clusters
    # only: their launches are those of phase 3's solves there (above
    # CLUSTER_MAX_EDGES; with a module too large for a cluster), their
    # times at those problems
    above = (f"CSR solve above CLUSTER_MAX_EDGES "
             f"({sweep['above']['edges']} edges)")
    paths = {"em_step": above, "cycle_extrap": above, "cycle_select": above,
             "pair_gain": f"CSR solve with a module above the 8-block "
                          f"cluster's limit, no tile plan "
                          f"({sweep['oversized']['edges']} edges)"}
    for k in ("cycle_extrap", "cycle_select"):
        measured[k] = sweep["above"]["csr_cycle"][k]
    measured["pair_gain"] = sweep["oversized"]["csr_cycle"]["pair_gain"]
    rows = [(k, dict(KERNELS[k], **({"path": paths[k]} if k in paths
                                    else {})), main_launches[k], measured[k])
            for k in KERNELS]
    # the second shape of the CSR kernels: the batched multisample solve
    # (its launches counted in the solve alone; em_step's in phase 14's
    # batched loop forced off clusters)
    batched = f"R={MS_SAMPLES} per-sample operands"
    forced = loops[f"batched S={MS_SAMPLES} launches"]["graph_launches"]
    for k in ("em_step", "pair_gain", "block_end", "cluster_em_pair",
              "cluster_extrap_gain"):
        row = dict(KERNELS[k], shape=batched)
        n = multisample["batched_solve_launches"][k]
        if k in ("em_step", "pair_gain"):
            row["path"] = "batched solve forced off clusters"
            n = forced[k]
        rows.append((k, row, n, multisample.pop(f"{k}_batched")))
    print(json.dumps({"kernels": [
        dict(row, launches=n, max_abs_err=m["err"], ms=m["ms"],
             host_ms=m["host_ms"], plain_ms=m["plain_ms"],
             bound_ms=m["bound_ms"], bound_by=m["bound_by"],
             library_ms=m["library_ms"])
        for _, row, n, m in rows]}))
    print(json.dumps({"phase_seconds": seconds, "csr_blocks": csr_blocks,
                      "cycle_ab": cycle_ab,
                      "csr_cycle_main": measured["csr_cycle_main"],
                      "dense_stops": stops, "cluster_sweep": sweep,
                      "scale_build": scale, "scale_pe_build": scale_pe,
                      "multisample": multisample, "loops": loops,
                      "ptxas": ptxas}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
