"""The plain reference against the port on the CPU, on tiny transcriptomes:
the index builder byte for byte against the port's NumPy builder, the read
counts against the port's ingest, and the solve against the port's
``emsar-torch -I`` run with ``EMSAR_TORCH_DEVICE=cpu``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import gen, refbuild, refquant, run

CPU = torch.device("cpu")


def _port_index(names, seqs, rl, strand="ns"):
    from emsar_tpu_torch.config import BuildConfig, StrandType
    from emsar_tpu_torch.index.build import build_se_index
    from emsar_tpu_torch.io.fasta import build_transcriptome
    cfg = BuildConfig(verbose=0, strand=StrandType.parse(strand, False))
    return build_se_index(build_transcriptome(names, seqs), rl, rl, cfg,
                          backend="numpy")


@pytest.mark.parametrize("rl", [16, 50, 76])
@pytest.mark.parametrize("strand", ["ns", "ssf"])
def test_index_is_the_ports(rl, strand, tmp_path):
    seqs, st = gen.gene_family(np.random.default_rng(5), 20, 2, 8, 8, 80,
                               400)
    _port_index(st.names, seqs, rl, strand).write_text(str(tmp_path / "a"))
    mine = refbuild.build(seqs, st.names, rl, CPU,
                          unstranded=strand == "ns")
    assert open(tmp_path / "a", "rb").read() == mine.rsh_text()


def test_index_with_repeats(tmp_path):
    rng = np.random.default_rng(1)
    base = np.frombuffer(b"ACGT", np.uint8)
    ex = base[rng.integers(0, 4, 200)].tobytes()
    seqs = [ex + base[rng.integers(0, 4, 60)].tobytes() + ex,
            ex[:120] + b"NNAC" + ex, base[rng.integers(0, 4, 90)].tobytes(),
            b"ACGT" * 40]
    names = ["a", "b", "c", "d"]
    for rl in (16, 40):
        _port_index(names, seqs, rl).write_text(str(tmp_path / "a"))
        assert open(tmp_path / "a", "rb").read() == \
            refbuild.build(seqs, names, rl, CPU).rsh_text()


def test_hashed_keys_differ():
    seqs, st = gen.gene_family(np.random.default_rng(5), 20, 2, 8, 8, 80,
                               400)
    assert refbuild.build(seqs, st.names, 50, CPU, key_bits=10).rsh_text() \
        != refbuild.build(seqs, st.names, 50, CPU).rsh_text()


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("quant")
    seqs, st = gen.gene_family(np.random.default_rng(7), 25, 2, 8, 8, 80,
                               400)
    idx = refbuild.build(seqs, st.names, 50, CPU)
    rsh = str(d / "idx.rsh")
    open(rsh, "wb").write(idx.rsh_text())
    aln = gen.sample_reads(st, 50, 20000,
                           gen.abundance(len(st.names), 2.0,
                                         gen.rng_for(11, 3, 0)),
                           gen.rng_for(11, 1, 0))
    path = str(d / "s.bowtieout")
    gen.write_bowtie(path, aln, st.names, 50)
    return d, idx, rsh, aln, path


def test_counts_are_the_ports(sample):
    from emsar_tpu_torch.ingest import native
    from emsar_tpu_torch.io.rsh import RshIndex
    d, idx, rsh, aln, path = sample
    port = native.NativeCollapser(RshIndex.read_text(rsh)).collapse_file(
        path, "bowtie", False, 0, 100, 50, 50)
    mine = refquant.count_reads(idx, aln)
    assert (port.readcount_per_cid() == mine.read_count).all()
    assert port.total_read_count == mine.total == aln.n_reads


def test_port_meets_reference(sample):
    d, idx, rsh, aln, path = sample
    env = {**run.child_env("cpu")}
    out = str(d / "out")
    subprocess.run([sys.executable, "-m", "emsar_tpu_torch.cli.emsar", "-I",
                    rsh, out, "s", path], cwd=run.ROOT, env=env, check=True,
                   capture_output=True)
    ref = refquant.Reference(idx, aln, CPU)
    nums = refquant.judge(ref, os.path.join(out, "s.0.fpkm"),
                          os.path.join(out, "s.0.fraglength_effect"))
    assert abs(nums["loglik_gap"]) < 1e-3 and nums["count_gap"] < 1e-5
    assert nums["efflen_gap"] == 0 and nums["fraglen_gap"] == 0
    # the control, float32 in the program's place, reads worse
    refquant.control_outputs(ref, str(d / "control"))
    c = refquant.judge(ref, str(d / "control.fpkm"),
                       str(d / "control.fraglength_effect"))
    assert c["count_gap"] > 3 * nums["count_gap"]
    # a solve stopped after its first EM step keeps each module's reads
    # and is caught by the likelihood alone
    refquant.fault_outputs(ref, str(d / "fault"))
    f = refquant.judge(ref, str(d / "fault.fpkm"),
                       str(d / "fault.fraglength_effect"))
    assert f["count_gap"] < 1e-4 and f["loglik_gap"] > 100
