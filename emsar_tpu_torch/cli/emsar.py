"""emsar CLI (PyTorch port): quantify transcript abundance from
alignments.

The port of ``emsar_tpu/cli/emsar.py``, flag-compatible with the reference
quantifier (src/emsar_main.c):

    emsar-torch <options> -x fastafile outdir outprefix alnfile|alnfilelist
    emsar-torch <options> -I rshfile outdir outprefix alnfile|alnfilelist
    bowtie ... | emsar-torch <options> -I rshfile outdir outprefix

The device comes from ``EMSAR_TORCH_DEVICE`` (default ``cuda``).  ``-x``
builds the index on it (``index.build.build_se_index`` over the SE
read-length range learned from the whole alignment file, or
``build_pe_index`` with ``--PE`` for the read length of its first
alignment); ``-R`` writes that index and ``-m 1`` the positional-bias
table.  ``--solver_pallas`` selects the hand-written CUDA SQUAREM kernel
for the dense module batches.  ``-M --batch_samples`` solves every sample
of the list in one batched solve over the processes' (dp, tp) mesh
(``parallel/mesh.py``); ``-M --dist_merge_shards`` reads the list as
shards of ONE sample, each process ingesting its strided slice, merges
the counts across processes and writes from process 0
(``parallel/dist.py``, which names the environment of a multi-process
run).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import getopt
import os
import sys
import threading
from typing import List, Optional

import numpy as np
import torch

from ..config import BuildConfig, MAX_N_ALNFILES, QuantConfig, StrandType
from ..device import resolve_device
from ..index.build import build_pe_index, build_se_index
from ..ingest import native as native_mod
from ..ingest.collapse import (PosBias, ReadCollapser, SampleCounts,
                               group_alignments)
from ..io import bowtie
from ..io.bam import read_bam_records
from ..io.fasta import read_fasta
from ..io.outputs import (write_fpkm, write_fraglength_dist, write_posbias,
                          write_segments)
from ..io.rsh import RshIndex
from ..io.sam import (probe_readlength_range_sam_bam,
                      probe_readlength_sam_bam, read_sam_records,
                      stream_alignments_pe, stream_alignments_se)
from ..model.quantify import (index_modules, quantify_sample,
                              quantify_samples_batched)
from ..parallel import dist
from ..utils.timing import phase
from .common import die

SHORT = "vqPs:b:p:h:t:F:f:n:e:r:d:gm:MHBSW:w:k:i:l:TRI:x:"
LONG = ["rsh=", "fasta=", "print_segments", "print_sfa", "print_rsh", "BAM",
        "SAM", "PE", "strand_type=", "multisample", "bias_model=",
        "posbias_training_len=", "posbias_impute_len=", "binsize=",
        "maxthread=", "header=", "taglen=", "maxfraglen=", "minfraglen=",
        "max_repeat=", "nround=", "epsilon=", "precision=", "delta=",
        "max_niter_mle=", "max_nloop_mle=", "verbose", "no_verbose",
        "batch_samples", "solver_dtype=", "solver_mode=", "solver_pallas",
        "dist_merge_shards"]


def usage(prog: str) -> None:
    print(f"Usage : {prog} <options> -x fastafile outdir outprefix "
          f"alignmentfile|alignmentfilelist")
    print(f"Usage2 : {prog} <options> -I rshfile outdir outprefix "
          f"alignmentfile|alignmentfilelist")
    print(f"Usage3 : bowtie command | {prog} <options> -I rshfile outdir "
          f"outprefix")
    print("\t(see the reference emsar for the full option list; flags are "
          "compatible)")
    print("\t--solver_pallas : solve dense module batches with the "
          "hand-written CUDA SQUAREM kernel")
    print("\t--batch_samples : with -M, solve every sample in one batched "
          "solve; run over several processes, each needs a card of its "
          "own (LOCAL_RANK)")
    print("\tdevice: $EMSAR_TORCH_DEVICE (default cuda; 'cpu' runs the "
          "kernel's plain PyTorch version)")


def _sam_bam_records(path: str, fmt: str):
    if fmt == "bam":
        return read_bam_records(path if path else sys.stdin.buffer)
    return read_sam_records(path if path else sys.stdin)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        usage("emsar-torch")
        return 0

    cfg = QuantConfig()
    strand_str = "ns"
    rshfile = ""
    fastafile = ""
    try:
        opts, args = getopt.gnu_getopt(argv, SHORT, LONG)
    except getopt.GetoptError as e:
        die(f"error: {e}")
    for o, a in opts:
        if o in ("-I", "--rsh"):
            rshfile = a
        elif o in ("-x", "--fasta"):
            fastafile = a
        elif o in ("-P", "--PE"):
            cfg.pe = True
        elif o in ("-s", "--strand_type"):
            strand_str = a
        elif o in ("-b", "--binsize"):
            cfg.binsize = int(a)
        elif o in ("-p", "--maxthread"):
            cfg.max_threads = int(a)
        elif o in ("-h", "--header"):
            cfg.header_fmt = a[:1]
        elif o in ("-t", "--taglen"):
            cfg.taglen = int(a)
        elif o in ("-F", "--maxfraglen"):
            cfg.max_fraglength = int(a)
        elif o in ("-f", "--minfraglen"):
            cfg.min_fraglength = int(a)
        elif o in ("-k", "--max_repeat"):
            cfg.max_repeat = int(a)
        elif o in ("-n", "--nround"):
            cfg.num_round = int(a)
            if cfg.num_round <= 0:
                die("option -n must be a natural number.")
        elif o in ("-e", "--epsilon"):
            cfg.epsilon = float(a)
        elif o in ("-r", "--precision"):
            cfg.epsilon_stepsize = float(a)
        elif o in ("-i", "--max_niter_mle"):
            cfg.max_niter_mle = int(a)
        elif o in ("-l", "--max_nloop_mle"):
            cfg.max_nloop_mle = int(a)
        elif o in ("-d", "--delta"):
            cfg.delta = float(a)
        elif o in ("-g", "--print_segments"):
            cfg.print_segments = True
        elif o in ("-m", "--bias_model"):
            cfg.posmodel = int(a)
        elif o in ("-M", "--multisample"):
            cfg.multisample = True
        elif o == "-H":
            pass  # reference ignores it too
        elif o in ("-B", "--BAM"):
            if cfg.aln_format == "sam":
                die("error: Options -B(--BAM) and -S(--SAM) cannot be used "
                    "simultaneously.")
            cfg.aln_format = "bam"
        elif o in ("-S", "--SAM"):
            if cfg.aln_format == "bam":
                die("error: Options -B(--BAM) and -S(--SAM) cannot be used "
                    "simultaneously.")
            cfg.aln_format = "sam"
        elif o in ("-W", "--posbias_training_len"):
            cfg.perpos_freq_len = int(a)
            if cfg.perpos_freq_len <= 0 or cfg.perpos_freq_len >= 10000:
                die("error: Option -W(--posbias_training_len) must be "
                    "between 1 and 10000.")
        elif o in ("-w", "--posbias_impute_len"):
            cfg.perpos_freq_impute_len = int(a)
            if (cfg.perpos_freq_impute_len <= 0
                    or cfg.perpos_freq_impute_len > cfg.perpos_freq_len):
                die("error: Option -w(--posbias_impute_len) must be "
                    "between 1 and posbias_training_len.")
        elif o in ("-T", "--print_sfa"):
            cfg.print_sfa = True
        elif o in ("-R", "--print_rsh"):
            cfg.print_rsh = True
        elif o == "--batch_samples":
            cfg.batch_samples = True
        elif o == "--dist_merge_shards":
            cfg.dist_merge_shards = True
        elif o == "--solver_dtype":
            cfg.solver_dtype = a
        elif o == "--solver_mode":
            cfg.solver_mode = a
        elif o == "--solver_pallas":
            cfg.solver_pallas = True
        elif o in ("-v", "--verbose"):
            cfg.verbose = 2
        elif o in ("-q", "--no_verbose"):
            cfg.verbose = 0

    if not rshfile and not fastafile:
        die("error: either fasta file or an rsh file must be used as an "
            "input.")
    if cfg.min_fraglength > cfg.max_fraglength or cfg.min_fraglength < 1 \
            or cfg.max_fraglength < 1:
        die("error: invalid fragment length range.")
    try:
        cfg.strand = StrandType.parse(strand_str, cfg.pe)
    except ValueError:
        die("error: invalid strand type.")

    if cfg.verbose > 0:
        _echo_params(cfg, fastafile, rshfile, strand_str)

    if len(args) < 2:
        usage("emsar-torch")
        return 0
    outdir, outprefix = args[0], args[1]
    alnarg = args[2] if len(args) > 2 else ""

    # alignment file list
    if not cfg.multisample:
        alnfiles = [alnarg]
    else:
        try:
            with open(alnarg) as fh:
                alnfiles = [ln.rstrip("\n") for ln in fh if ln.rstrip("\n")]
        except OSError:
            die("Can't open alignment list file.")
        if not alnfiles:
            die("No alignment files in the alignment list")
        if len(alnfiles) > MAX_N_ALNFILES:
            die(f"error: too many alignment files (max {MAX_N_ALNFILES})")

    os.makedirs(outdir, exist_ok=True)
    # a multi-process run (WORLD_SIZE > 1) joins its process group first
    dist.maybe_init_from_env()
    try:
        device = dist.rank_device(resolve_device())
        return run_quantifier(cfg, rshfile, outdir, outprefix, alnfiles,
                              device, fastafile=fastafile)
    finally:
        dist.shutdown()


def _echo_params(cfg: QuantConfig, fastafile: str, rshfile: str,
                 strand_str: str) -> None:
    """Startup parameter echo (reference src/emsar_main.c:225-248)."""
    fmt = {"bowtie": "default bowtie output", "sam": "SAM",
           "bam": "BAM"}[cfg.aln_format]
    print(f"input fastafile name= {fastafile}")
    print(f"input rshfile name= {rshfile}")
    print(f"Input type= {fmt}")
    print(f"Paired-end= {'y' if cfg.pe else 'n'}")
    print(f"strand type= {strand_str}")
    print(f"Multisample= {'y' if cfg.multisample else 'n'}")
    print(f"Max_Fraglen= {cfg.max_fraglength}")
    print(f"Min_Fraglen= {cfg.min_fraglength}")
    print(f"MAX_REPEAT= {cfg.max_repeat}")
    # exact "%d %s" spelling: trailing space when posmodel != 0
    print(f"bias model= {cfg.posmodel} "
          f"{'(no bias model)' if cfg.posmodel == 0 else ''}")
    print(f"positional bias training length= {cfg.perpos_freq_len}")
    print(f"positional bias impute training length= "
          f"{cfg.perpos_freq_impute_len}")
    print(f"fasta header option= {cfg.header_fmt}")
    print(f"MAX_Thread= {cfg.max_threads}")
    print(f"NUM_ROUND= {cfg.num_round}")
    print(f"CONVERGENCE_EPSILON= {cfg.epsilon:g}")
    print(f"CONVERGENCE_EPSILON_STEPSIZE= {cfg.epsilon_stepsize:g}")
    print(f"MAX_NITER_MLE= {cfg.max_niter_mle}")
    print(f"MAX_NLOOP_MLE= {cfg.max_nloop_mle}")
    print(f"binsize = {cfg.binsize}")
    print(f"taglen = {cfg.taglen}")
    print(f"print segments = {'y' if cfg.print_segments else 'n'}")
    print(f"print suffix aray = {'y' if cfg.print_sfa else 'n'}")
    print(f"print rsh structure = {'y' if cfg.print_rsh else 'n'}")


def _build_index(cfg: QuantConfig, fastafile: str, outdir: str,
                 outprefix: str, alnfile: str, device: torch.device):
    """``-x``: read the FASTA, learn the read length (PE: from the first
    alignment; SE: the range, by scanning the alignment file; reference
    src/emsar_main.c:307-316) and build the index.  Returns (transcriptome,
    index)."""
    with phase("reading fasta file", cfg.verbose):
        tx = read_fasta(fastafile, cfg.header_fmt)
    with phase("probing read length", cfg.verbose):
        if cfg.pe:
            if cfg.aln_format == "bowtie":
                rl_lo = rl_hi = bowtie.probe_readlength(
                    alnfile if alnfile else sys.stdin)
            else:
                rl_lo = rl_hi = probe_readlength_sam_bam(
                    _sam_bam_records(alnfile, cfg.aln_format))
        elif not alnfile:
            # the reference has the same limitation (SURVEY quirk (b))
            die("error: single-end -x requires a file (not stdin): the "
                "read-length range is learned by scanning the whole "
                "alignment file. Build an rsh index first and use -I for "
                "streaming.")
        elif cfg.aln_format == "bowtie":
            rl_lo, rl_hi = bowtie.probe_readlength_range(alnfile)
        else:
            rl_lo, rl_hi = probe_readlength_range_sam_bam(
                _sam_bam_records(alnfile, cfg.aln_format))
    bcfg = BuildConfig(pe=cfg.pe, strand=cfg.strand,
                       min_fraglength=cfg.min_fraglength,
                       max_fraglength=cfg.max_fraglength,
                       max_repeat=cfg.max_repeat, header_fmt=cfg.header_fmt,
                       binsize=cfg.binsize, taglen=cfg.taglen,
                       verbose=cfg.verbose)
    sfa_path = os.path.join(outdir, outprefix + ".sfa") \
        if cfg.print_sfa else None
    with phase("building rsh index", cfg.verbose):
        if cfg.pe:
            index = build_pe_index(tx, rl_lo, bcfg, sfa_path=sfa_path,
                                   device=device)
        else:
            index = build_se_index(tx, rl_lo, rl_hi, bcfg,
                                   sfa_path=sfa_path, device=device)
    return tx, index


def run_quantifier(cfg: QuantConfig, rshfile: str, outdir: str,
                   outprefix: str, alnfiles: List[str],
                   device: torch.device, fastafile: str = "") -> int:
    os.makedirs(outdir, exist_ok=True)
    rshfile_out = os.path.join(outdir, outprefix + ".rsh")

    if not rshfile:
        tx, index = _build_index(cfg, fastafile, outdir, outprefix,
                                 alnfiles[0], device)
    else:
        with phase("reading rsh file", cfg.verbose):
            try:
                index = RshIndex.load(rshfile)
            except OSError:
                die("can't open input rsh file.")
        # -I overrides the fragment-length filter with the header's values
        # (reference parse_rsh_headerline :1406-1430)
        cfg.min_fraglength = index.min_fraglength
        cfg.max_fraglength = index.max_fraglength

    name_to_tid = {n: i for i, n in enumerate(index.names)}
    pe_readlength = [index.readlength if index.readlength > 0 else -1]

    posbias = None
    if cfg.posmodel == 1:
        # positional-bias accumulation needs transcript lengths, so it
        # requires the -x (fasta) path, as in the reference
        if not fastafile or rshfile:
            die("error: positional bias model (-m 1) requires -x fastafile "
                "(not -I).")
        posbias = PosBias(tx.transcript_lengths(), cfg.perpos_freq_len)

    native_collapser = None
    if native_mod.available():
        with phase("building native ingest tables", cfg.verbose):
            native_collapser = native_mod.NativeCollapser(index)
    ingest = functools.partial(_collapse, cfg, index, name_to_tid,
                               native_collapser, pe_readlength)

    if cfg.dist_merge_shards:
        return _run_dist_shards(cfg, index, ingest, outdir, outprefix,
                                alnfiles, device)
    if cfg.batch_samples and cfg.multisample and len(alnfiles) > 1:
        if cfg.verbose > 0 and dist.process_count() == 1:
            print("[emsar] note: --batch_samples targets meshes of several "
                  "processes; on one device the per-sample loop (default) "
                  "overlaps each solve with the next file's ingest")
        rc = _run_batched(cfg, index, ingest, outdir, outprefix, alnfiles,
                          device)
        if rc is not None:
            return rc
        # EUMAcut re-clustering triggered: the per-sample loop

    # Multisample ingest/solve overlap: while sample i solves on the
    # device, a worker thread ingests file i+1 (the C++ collapser releases
    # the GIL and brings its own threads).  Counts are private per file,
    # so results are bit-identical to the serial loop.  Not for stdin, and
    # not with -m 1 (it accumulates into one PosBias in file order).
    prefetch_ok = (native_collapser is not None and posbias is None
                   and len(alnfiles) > 1 and all(alnfiles))
    # the module decomposition is index-only at EUMAcut 0: compute it on a
    # worker thread while the alignment file streams
    threading.Thread(target=index_modules, args=(index,), daemon=True).start()

    executor = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                if prefetch_ok else None)
    pending = None
    try:
        for i, alnfile in enumerate(alnfiles):
            with phase(f"reading alignment file {alnfile or '<stdin>'}",
                       cfg.verbose):
                counts = (pending.result() if pending is not None
                          else ingest(alnfile, posbias))
            pending = (executor.submit(ingest, alnfiles[i + 1])
                       if executor is not None and i + 1 < len(alnfiles)
                       else None)

            if posbias is not None and i == 0:
                write_posbias(os.path.join(outdir, outprefix + ".posbias"),
                              posbias)

            if cfg.print_rsh:
                with phase("writing rsh file", cfg.verbose):
                    index.write_text(rshfile_out)
                    index.write_npz(rshfile_out + ".npz")

            result = quantify_sample(index, counts, cfg, device)
            _write_sample(cfg, index, outdir, outprefix, i, result,
                          counts.fraglength_counts)
    finally:
        if executor is not None:
            executor.shutdown(wait=True)
    return 0


def _write_sample(cfg: QuantConfig, index: RshIndex, outdir: str,
                  outprefix: str, i: int, result, fraglength_counts) -> None:
    """Sample i's .fpkm, .fraglength_effect and (-g) .segments."""
    fpkm_path = os.path.join(outdir, f"{outprefix}.{i}.fpkm")
    write_fpkm(fpkm_path, index.names, result.fpkm_rounds, result.ieuma,
               result.total_read_count, cfg.verbose)
    fl_path = os.path.join(outdir, f"{outprefix}.{i}.fraglength_effect")
    write_fraglength_dist(fl_path, index.fraglen_min, index.n_fraglen,
                          fraglength_counts, result.wf)
    if cfg.print_segments:
        write_segments(os.path.join(outdir, f"{outprefix}.{i}.segments"),
                       index.names, result.graph.ct_offsets,
                       result.graph.ct_tids, result.modules.cs,
                       result.adj_euma, result.graph.read_count,
                       result.fpkm, result.total_read_count)
    if cfg.verbose > 0:
        print(f"Complete: Output file :\n  {fpkm_path}\n  {fl_path}")


def _run_dist_shards(cfg: QuantConfig, index: RshIndex, ingest, outdir: str,
                     outprefix: str, alnfiles: List[str],
                     device: torch.device) -> int:
    """--dist_merge_shards: the alignment list holds shards of ONE sample.
    Each process collapses its strided slice, the counts merge across
    processes (exact integer sums), every process quantifies the
    identical merged counts, and process 0 writes the single output.  In
    one process it is an in-process shard loop."""
    merged = None
    for alnfile in dist.shard_list(alnfiles):
        with phase(f"reading alignment shard {alnfile}", cfg.verbose):
            c = ingest(alnfile)
        merged = c if merged is None else dataclasses.replace(
            merged, single_counts=merged.single_counts + c.single_counts,
            multi_counts=merged.multi_counts + c.multi_counts,
            fraglength_counts=merged.fraglength_counts + c.fraglength_counts,
            total_read_count=merged.total_read_count + c.total_read_count)
    if merged is None:  # more processes than shards
        merged = SampleCounts(
            single_counts=np.zeros(index.n_transcripts, dtype=np.int64),
            multi_counts=np.zeros(index.n_multi, dtype=np.int64),
            fraglength_counts=np.zeros(
                max(cfg.max_fraglength, index.fraglen_max) + 1,
                dtype=np.int64),
            total_read_count=0)
    with phase("merging shard counts across processes", cfg.verbose):
        merged = dist.allreduce_counts(merged)
    result = quantify_sample(index, merged, cfg, device)
    if dist.is_main():
        _write_sample(cfg, index, outdir, outprefix, 0, result,
                      merged.fraglength_counts)
    dist.barrier()
    return 0


def _run_batched(cfg: QuantConfig, index: RshIndex, ingest, outdir: str,
                 outprefix: str, alnfiles: List[str], device: torch.device
                 ) -> Optional[int]:
    """-M --batch_samples: collapse every file, then solve all samples in
    one sharded solve.  Returns None to ask for the per-sample loop."""
    counts_list = []
    for alnfile in alnfiles:
        with phase(f"reading alignment file {alnfile}", cfg.verbose):
            counts_list.append(ingest(alnfile))
    with phase(f"batched solve over {len(counts_list)} samples",
               cfg.verbose):
        results = quantify_samples_batched(index, counts_list, cfg, device)
    if results is None:
        return None
    if dist.is_main():
        for i, (counts, result) in enumerate(zip(counts_list, results)):
            _write_sample(cfg, index, outdir, outprefix, i, result,
                          counts.fraglength_counts)
    return 0


def _collapse(cfg: QuantConfig, index: RshIndex, name_to_tid,
              native_collapser, pe_readlength, alnfile: str, posbias=None):
    """One alignment file's SampleCounts: the C++ collapser where it
    built, else the Python one."""
    if native_collapser is not None:
        return native_collapser.collapse_file(
            alnfile, cfg.aln_format, cfg.pe, cfg.strand.code,
            cfg.max_repeat, cfg.min_fraglength, cfg.max_fraglength,
            pe_readlength if cfg.pe else None, nthreads=cfg.max_threads,
            posbias=posbias)
    return _collapse_python(index, name_to_tid, cfg, alnfile, pe_readlength,
                            posbias)


def _collapse_python(index: RshIndex, name_to_tid, cfg: QuantConfig,
                     alnfile: str, pe_readlength, posbias=None):
    collapser = ReadCollapser(index, cfg.min_fraglength,
                              cfg.max_fraglength, cfg.max_repeat, cfg.pe,
                              posbias=posbias)
    if cfg.aln_format == "bowtie":
        src = alnfile if alnfile else sys.stdin
        if cfg.pe:
            stream = bowtie.read_bowtie_pe(src, name_to_tid,
                                           cfg.strand.code, pe_readlength)
        else:
            stream = bowtie.read_bowtie_se(src, name_to_tid, cfg.strand.code)
    else:
        records = _sam_bam_records(alnfile, cfg.aln_format)
        if cfg.pe:
            stream = stream_alignments_pe(records, name_to_tid,
                                          cfg.strand.code, pe_readlength)
        else:
            stream = stream_alignments_se(records, name_to_tid,
                                          cfg.strand.code)
    collapser.consume(group_alignments(stream))
    return collapser.finish()


if __name__ == "__main__":
    raise SystemExit(main())
