"""A configuration's data, made once per checkout, and a run's inputs, made
from the run's seed.

A quantification configuration's transcriptome comes from its own fixed
seed; its index is built by the benchmark's plain builder
(``refbuild.build``, on the card when there is one) and kept, with the
transcriptome's exon structure, under ``benchmark/_data/<config>-<hash of
the configuration file>/``: the ``.rsh`` text the program reads, and the
arrays the reference reads.  A run's read samples (and a build cell's
transcriptome) come from the run's seed and live under the run's work
directory.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import List

import numpy as np

from . import gen

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "_data")

# input streams of a seed
SAMPLE_STREAM = 1
TRANSCRIPTOME_STREAM = 2
PROFILE_STREAM = 3


def config_dir(config: dict, config_path: str) -> str:
    with open(config_path, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:12]
    return os.path.join(DATA, f"{config['name']}-{digest}")


def config_paths(config: dict, config_path: str) -> dict:
    """{"rsh", "index", "structure"}: where the configuration's index (text
    for the program, arrays for the reference) and exon structure live."""
    d = config_dir(config, config_path)
    return {"rsh": os.path.join(d, "index.rsh"),
            "index": os.path.join(d, "index.npz"),
            "structure": os.path.join(d, "structure.npz")}


def ensure_config_data(config: dict, config_path: str, device) -> dict:
    """``config_paths``, their files built if this checkout has not built
    them yet."""
    paths = config_paths(config, config_path)
    if all(os.path.exists(p) for p in paths.values()):
        return paths
    d = os.path.dirname(paths["rsh"])
    from . import refbuild

    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    shape = config["transcriptome"]
    seqs, st = gen.transcriptome(shape, np.random.default_rng(shape["seed"]))
    idx = refbuild.build(seqs, st.names, config["read_length"], device,
                         unstranded=config["strand"] == "ns",
                         max_repeat=config["max_repeat"])
    del seqs
    tmp = paths["rsh"] + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(idx.rsh_text())
    os.replace(tmp, paths["rsh"])
    idx.save(paths["index"] + ".tmp")
    os.replace(paths["index"] + ".tmp", paths["index"])
    with open(paths["structure"] + ".tmp", "wb") as fh:
        np.savez(fh, names=np.array(st.names), gene_of=st.gene_of,
                 exon_lens=st.exon_lens, keeps=st.keeps)
    os.replace(paths["structure"] + ".tmp", paths["structure"])
    with open(os.path.join(d, "made.json"), "w") as fh:
        json.dump({"seconds": time.perf_counter() - t0,
                   "device": str(device)}, fh)
    return paths


def load_structure(path: str) -> gen.Structure:
    with np.load(path) as z:
        return gen.Structure(names=[str(n) for n in z["names"]],
                             gene_of=z["gene_of"], exon_lens=z["exon_lens"],
                             keeps=z["keeps"])


def minus_share(config: dict) -> float:
    """The share of reads on the reverse strand that the configuration's
    library gives: one half unstranded (``ns``), else every read on the
    strand the protocol keeps."""
    return {"ns": 0.5, "ssf": 0.0, "ssr": 1.0}[config["strand"]]


def _make_sample(structure_path: str, rl: int, n_reads: int, sigma: float,
                 profile_seed: int, seed: int, k: int, out: str,
                 minus: float) -> str:
    st = load_structure(structure_path)
    weight = gen.abundance(len(st.names), sigma,
                           gen.rng_for(profile_seed, PROFILE_STREAM, k))
    aln = gen.sample_reads(st, rl, n_reads, weight,
                           gen.rng_for(seed, SAMPLE_STREAM, k), minus)
    gen.write_bowtie(out, aln, st.names, rl)
    with open(out + ".npz", "wb") as fh:
        np.savez(fh, n_reads=aln.n_reads, read=aln.read, tid=aln.tid,
                 pos=aln.pos, minus=aln.minus)
    return out


def make_samples(structure_path: str, rl: int, n_reads: int, sigma: float,
                 profile_seed: int, seed: int, n: int, work: str,
                 workers: int, minus: float = 0.5) -> List[str]:
    """``n`` samples as bowtie files under ``work`` (sample k's alignments
    also as ``<file>.npz``, for the reference).  Sample k's abundance
    profile comes from ``profile_seed``, the traffic's, so that every run
    does the same work; its reads from the run's ``seed``."""
    paths = [os.path.join(work, f"sample{k:02d}.bowtieout") for k in range(n)]
    args = [(structure_path, rl, n_reads, sigma, profile_seed, seed, k, p,
             minus)
            for k, p in enumerate(paths)]
    if workers <= 1:
        return [_make_sample(*a) for a in args]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(workers, n), mp_context=ctx) as ex:
        return [f.result() for f in [ex.submit(_make_sample, *a)
                                     for a in args]]


def load_alignments(path: str) -> gen.Alignments:
    with np.load(path + ".npz") as z:
        return gen.Alignments(n_reads=int(z["n_reads"]), read=z["read"],
                              tid=z["tid"], pos=z["pos"], minus=z["minus"])


def make_transcriptome_fasta(config: dict, seed: int, path: str):
    """A transcriptome of the configuration's shape drawn from the run's
    seed, written as FASTA; returns (names, seqs)."""
    seqs, st = gen.transcriptome(config["transcriptome"],
                                 gen.rng_for(seed, TRANSCRIPTOME_STREAM))
    gen.write_fasta(path, st.names, seqs)
    return st.names, seqs


if __name__ == "__main__":
    import sys

    import torch

    path, device = sys.argv[1], sys.argv[2]
    with open(path) as fh:
        conf = json.load(fh)
    ensure_config_data(conf, path, torch.device(device))
