"""emsar-build CLI (PyTorch port): construct an SE rsh index from a
transcriptome FASTA.

The port of ``emsar_tpu/cli/emsar_build.py``'s SE path, flag-compatible
with the reference builder (src/emsar_build_main.c):

    emsar-build-torch <options> fastafile readlength(range) outdir outprefix

The index is built on the device named by ``EMSAR_TORCH_DEVICE`` (default
``cuda``); ``EMSAR_TORCH_BUILD_BACKEND=numpy`` builds on the host instead.
``--PE`` is not ported yet and exits with an error.
"""

from __future__ import annotations

import getopt
import os
import sys

from emsar_tpu.cli.common import die
from emsar_tpu.config import BuildConfig, StrandType
from emsar_tpu.io.fasta import read_fasta
from emsar_tpu.utils.timing import phase

from ..index.build import build_se_index
from .emsar import NOT_PORTED

SHORT = "vqPs:b:p:h:t:F:f:m:W:w:Tk:"
LONG = ["print_sfa", "PE", "strand_type=", "bias_model=",
        "posbias_training_len=", "posbias_impute_len=", "binsize=",
        "maxthread=", "max_repeat=", "header=", "taglen=", "maxfraglen=",
        "minfraglen=", "verbose", "no_verbose"]


def usage(prog: str) -> None:
    print(f"Usage : {prog} <options> fastafile readlength(range) outdir "
          f"outprefix")
    print("\t(see the reference emsar-build for the full option list; "
          "flags are compatible)")
    print("\tdevice: $EMSAR_TORCH_DEVICE (default cuda); "
          "$EMSAR_TORCH_BUILD_BACKEND=numpy builds on the host")
    print(f"\t--PE: {NOT_PORTED}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 4:
        usage("emsar-build-torch")
        return 0

    cfg = BuildConfig()
    strand_str = "ns"
    # positional-bias build surface: validated and echoed only, as in the
    # reference builder (src/emsar_build_main.c:96-112)
    posmodel = 0
    perpos_freq_len = 1000
    perpos_freq_impute_len = 200
    try:
        opts, args = getopt.gnu_getopt(argv, SHORT, LONG)
    except getopt.GetoptError as e:
        die(f"error: {e}")
    for o, a in opts:
        if o in ("-P", "--PE"):
            cfg.pe = True
        elif o in ("-s", "--strand_type"):
            strand_str = a
        elif o in ("-b", "--binsize"):
            cfg.binsize = int(a)
        elif o in ("-p", "--maxthread"):
            cfg.max_threads = int(a)
        elif o in ("-k", "--max_repeat"):
            cfg.max_repeat = int(a)
        elif o in ("-h", "--header"):
            cfg.header_fmt = a[:1]
        elif o in ("-t", "--taglen"):
            cfg.taglen = int(a)
            if cfg.taglen not in (1, 2, 3):
                die("error: currently taglength (-t) up to 3 is supported.")
        elif o in ("-F", "--maxfraglen"):
            cfg.max_fraglength = int(a)
        elif o in ("-f", "--minfraglen"):
            cfg.min_fraglength = int(a)
        elif o in ("-T", "--print_sfa"):
            cfg.print_sfa = True
        elif o in ("-v", "--verbose"):
            cfg.verbose = 2
        elif o in ("-q", "--no_verbose"):
            cfg.verbose = 0
        elif o in ("-m", "--bias_model"):
            posmodel = int(a)
        elif o in ("-W", "--posbias_training_len"):
            perpos_freq_len = int(a)
            if perpos_freq_len <= 0 or perpos_freq_len >= 10000:
                die("error: Option -W(--posbias_training_len) must be "
                    "between 1 and 10000.")
        elif o in ("-w", "--posbias_impute_len"):
            perpos_freq_impute_len = int(a)
            if (perpos_freq_impute_len <= 0
                    or perpos_freq_impute_len > perpos_freq_len):
                die("error: Option -w(--posbias_impute_len) must be "
                    "between 1 and posbias_training_len.")

    if cfg.min_fraglength > cfg.max_fraglength or cfg.min_fraglength < 1 \
            or cfg.max_fraglength < 1:
        die("error: invalid fragment length range.")
    try:
        cfg.strand = StrandType.parse(strand_str, cfg.pe)
    except ValueError:
        die("error: invalid strand type.")

    if cfg.verbose > 0:
        # startup parameter echo (reference src/emsar_build_main.c:131-145)
        print(f"Paired-end= {'y' if cfg.pe else 'n'}")
        print(f"strand type= {strand_str}")
        print(f"Max_Fraglen= {cfg.max_fraglength}")
        print(f"Min_Fraglen= {cfg.min_fraglength}")
        print(f"MAX_REPEAT= {cfg.max_repeat}")
        print(f"bias model= {posmodel} "
              f"{'(no bias model)' if posmodel == 0 else ''}")
        print(f"positional bias training length= {perpos_freq_len}")
        print(f"positional bias impute training length= "
              f"{perpos_freq_impute_len}")
        print(f"fasta header option= {cfg.header_fmt}")
        print(f"MAX_Thread= {cfg.max_threads}")
        print(f"binsize = {cfg.binsize}")
        print(f"taglen = {cfg.taglen}")
        print(f"print suffix aray = {'y' if cfg.print_sfa else 'n'}")

    if len(args) < 4:
        usage("emsar-build-torch")
        return 0
    if cfg.pe:
        die(f"error: the paired-end index build (--PE) is {NOT_PORTED}.")
    fastafile, readlength_str, outdir, outprefix = args[:4]
    os.makedirs(outdir, exist_ok=True)

    with phase("reading fasta file", cfg.verbose):
        tx = read_fasta(fastafile, cfg.header_fmt)

    sfa_path = os.path.join(outdir, outprefix + ".sfa") if cfg.print_sfa \
        else None
    if "-" in readlength_str:
        lo_s, hi_s = readlength_str.split("-", 1)
        lo, hi = int(lo_s), int(hi_s)
    else:
        lo = hi = int(readlength_str)
    idx = build_se_index(tx, lo, hi, cfg, sfa_path=sfa_path)

    rsh_path = os.path.join(outdir, outprefix + ".rsh")
    with phase("writing rsh file", cfg.verbose):
        idx.write_text(rsh_path)
        idx.write_npz(rsh_path + ".npz")
    if cfg.verbose > 0:
        print(f"Complete: Output file :\n  {rsh_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
