"""readgen CLI: minimal RNA-seq read simulator for test runs.

Flag-compatible with the reference readgenerator (src/readgenerator.c):

    readgen <options> fastafile readlength numreads outdir outfilename
    -P/--PE, -s/--ss, -f <fraglen>, -h <header_prefix>
"""

from __future__ import annotations

import getopt
import os
import sys

import numpy as np

from ..io.fasta import read_fasta
from ..sim import fragments_to_reads, simulate_fragments, write_reads_fasta
from .common import die


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    pe = False
    ss = False
    fraglen = 0
    prefix = ""
    seed = None
    try:
        opts, args = getopt.gnu_getopt(argv, "Psf:h:", ["PE", "ss", "f=",
                                                        "header_prefix=",
                                                        "seed="])
    except getopt.GetoptError as e:
        die(f"error: {e}")
    for o, a in opts:
        if o in ("-P", "--PE"):
            pe = True
        elif o in ("-s", "--ss"):
            ss = True
        elif o in ("-f", "--f"):
            fraglen = int(a)
        elif o in ("-h", "--header_prefix"):
            prefix = a
        elif o == "--seed":
            seed = int(a)

    if len(args) < 5:
        print(f"Usage: readgen <options> fastafile readlength numreads "
              f"outdir outfilename")
        return 0
    fastafile = args[0]
    readlength = int(args[1])
    numreads = int(args[2])
    outdir, outfile = args[3], args[4]
    if pe and fraglen == 0:
        die("fraglen must be provided for PE.(-f)")
    if fraglen == 0:
        fraglen = readlength

    os.makedirs(outdir, exist_ok=True)
    tx = read_fasta(fastafile)
    rng = np.random.default_rng(seed)
    pos = simulate_fragments(tx, fraglen, numreads, rng, strand_specific=ss)
    names, r1, r2 = fragments_to_reads(tx, pos, readlength, fraglen, pe,
                                       header_prefix=prefix)
    if pe:
        write_reads_fasta(os.path.join(outdir, outfile + ".R1"), names, r1,
                          mate=1)
        write_reads_fasta(os.path.join(outdir, outfile + ".R2"), names, r2,
                          mate=2)
    else:
        write_reads_fasta(os.path.join(outdir, outfile), names, r1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
