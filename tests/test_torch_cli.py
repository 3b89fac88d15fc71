"""The port's ``emsar -I`` CLI against the JAX package's on the same .rsh
and bowtie alignments: .fraglength_effect byte-equal, .segments structural
columns equal, gene-level TPM and logL equal; plus stdin, -M, -R and the
flags that are not ported yet or need -x."""

import os
import subprocess
import sys

import numpy as np
import pytest

from emsar_tpu.cli import emsar as jax_cli
from emsar_tpu.config import BuildConfig, QuantConfig
from emsar_tpu.index.build import build_se_index
from emsar_tpu.io.fasta import build_transcriptome
from emsar_tpu.io.rsh import RshIndex
from emsar_tpu.sim import (fragments_to_reads, gene_family_transcriptome,
                           simulate_fragments)
from emsar_tpu_torch.cli import emsar as torch_cli
from emsar_tpu_torch.model.quantify import _host_loglik, prepare_sample
from emsar_tpu_torch.model.solver import build_problem
from tests.aligner import bowtie_lines_se

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READLEN = 20


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("EMSAR_TORCH_DEVICE", "cpu")


def _make_fixture(tmp_path, seed=60, n_genes=12, n_reads=2500):
    rng = np.random.default_rng(seed)
    names, seqs, _ = gene_family_transcriptome(rng, n_genes, n_exons=5,
                                               min_exon=40, max_exon=120)
    tx = build_transcriptome(names, seqs)
    rsh = str(tmp_path / "idx.rsh")
    build_se_index(tx, READLEN, READLEN, BuildConfig(verbose=0)).write_text(
        rsh)
    pos = simulate_fragments(tx, READLEN, n_reads, rng)
    rnames, r1, _ = fragments_to_reads(tx, pos, READLEN, READLEN, pe=False)
    aln = str(tmp_path / "aln.bowtieout")
    with open(aln, "w") as fh:
        for i, name in enumerate(rnames):
            for ln in bowtie_lines_se(name, r1[i], names, seqs):
                fh.write(ln + "\n")
    return rsh, aln


def _parse_fpkm(path):
    names, cols = [], []
    with open(path) as fh:
        next(fh)
        for line in fh:
            f = line.rstrip("\n").split("\t")
            names.append(f[0])
            cols.append([float(x) for x in f[1:]])
    return names, np.array(cols)


def _gene_tpm(names, cols):
    genes = np.array([n.split("T")[0] for n in names])
    uniq, inv = np.unique(genes, return_inverse=True)
    return np.bincount(inv, weights=cols[:, 5], minlength=len(uniq))


def _loglik(rsh, aln, fpkm):
    index = RshIndex.load(rsh)
    cfg = QuantConfig(verbose=0, min_fraglength=index.min_fraglength,
                      max_fraglength=index.max_fraglength)
    counts = torch_cli._collapse_python(
        index, {n: i for i, n in enumerate(index.names)}, cfg, aln, [-1])
    x = prepare_sample(index, counts, cfg)
    return _host_loglik(build_problem(x.graph, x.modules, x.eumaps,
                                      x.read_count), fpkm)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return _make_fixture(tmp_path_factory.mktemp("cli"))


@pytest.mark.parametrize("flags", [[], ["--solver_pallas"],
                                   ["--solver_mode", "csr"]],
                         ids=["dense_bmm", "dense_kernel", "csr"])
def test_cli_matches_jax(fixture, tmp_path, flags):
    rsh, aln = fixture
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    args = ["-q", "-g"]
    assert jax_cli.main(args + flags + ["-I", rsh, str(out_j), "s",
                                        aln]) == 0
    assert torch_cli.main(args + flags + ["-I", rsh, str(out_t), "s",
                                          aln]) == 0
    pj, pt = out_j / "s.0", out_t / "s.0"
    assert (open(f"{pt}.fraglength_effect", "rb").read()
            == open(f"{pj}.fraglength_effect", "rb").read())
    with open(f"{pj}.segments") as fj, open(f"{pt}.segments") as ft:
        seg_j = [ln.split("\t")[:6] for ln in fj]
        seg_t = [ln.split("\t")[:6] for ln in ft]
    assert seg_t == seg_j
    names_j, cols_j = _parse_fpkm(f"{pj}.fpkm")
    names_t, cols_t = _parse_fpkm(f"{pt}.fpkm")
    assert names_t == names_j
    # eff.length is index-only: equal as printed
    np.testing.assert_array_equal(cols_t[:, 2], cols_j[:, 2])
    # gene TPM: rel 1e-6, plus the %.6f print rounding of up to 10
    # isoforms per gene
    np.testing.assert_allclose(_gene_tpm(names_t, cols_t),
                               _gene_tpm(names_j, cols_j),
                               rtol=1e-6, atol=1e-5)
    ll_j = _loglik(rsh, aln, cols_j[:, 0])
    ll_t = _loglik(rsh, aln, cols_t[:, 0])
    assert abs(ll_t - ll_j) <= 1e-9 * abs(ll_j), (ll_t, ll_j)


def test_stdin_matches_file(fixture, tmp_path):
    rsh, aln = fixture
    out_f, out_s = tmp_path / "file", tmp_path / "stdin"
    assert torch_cli.main(["-q", "-I", rsh, str(out_f), "s", aln]) == 0
    env = dict(os.environ, PYTHONPATH=REPO, EMSAR_TORCH_DEVICE="cpu")
    with open(aln) as fh:
        subprocess.run([sys.executable, "-m", "emsar_tpu_torch.cli.emsar",
                        "-q", "-I", rsh, str(out_s), "s"], stdin=fh,
                       check=True, capture_output=True, env=env, cwd=REPO)
    _, a = _parse_fpkm(str(out_f / "s.0.fpkm"))
    _, b = _parse_fpkm(str(out_s / "s.0.fpkm"))
    np.testing.assert_array_equal(a, b)


def test_multisample_equals_single_runs(fixture, tmp_path):
    """-M with ingest/solve overlap: each sample's outputs equal its
    single-sample run."""
    rsh, aln1 = fixture
    lines = open(aln1).readlines()
    aln2 = str(tmp_path / "aln2.bowtieout")
    with open(aln2, "w") as fh:
        fh.writelines(lines[: len(lines) // 2])
    listfile = str(tmp_path / "samples.list")
    with open(listfile, "w") as fh:
        fh.write(aln1 + "\n" + aln2 + "\n")
    out_m = tmp_path / "multi"
    assert torch_cli.main(["-q", "-M", "-I", rsh, str(out_m), "s",
                           listfile]) == 0
    for i, aln in enumerate((aln1, aln2)):
        out_1 = tmp_path / f"single{i}"
        assert torch_cli.main(["-q", "-I", rsh, str(out_1), "s", aln]) == 0
        for ext in ("fpkm", "fraglength_effect"):
            assert (open(out_m / f"s.{i}.{ext}", "rb").read()
                    == open(out_1 / f"s.0.{ext}", "rb").read())


def test_print_rsh_matches_jax(fixture, tmp_path):
    rsh, aln = fixture
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    assert jax_cli.main(["-q", "-R", "-I", rsh, str(out_j), "s", aln]) == 0
    assert torch_cli.main(["-q", "-R", "-I", rsh, str(out_t), "s", aln]) == 0
    assert (open(out_t / "s.rsh", "rb").read()
            == open(out_j / "s.rsh", "rb").read()
            == open(rsh, "rb").read())


NOT_PORTED = "not yet ported to emsar_tpu_torch"


@pytest.mark.parametrize("flags,message", [
    (["--PE", "-x", "t.fa"], NOT_PORTED),
    (["-m", "1", "-I"], "requires -x fastafile (not -I)"),
    (["-M", "--batch_samples", "-I"], NOT_PORTED),
    (["-M", "--dist_merge_shards", "-I"], NOT_PORTED)],
    ids=["fasta", "posbias", "batch_samples", "dist_merge_shards"])
def test_unported_flags_exit(fixture, tmp_path, flags, message, capsys):
    """What is not ported exits with an error: the PE build behind -x,
    batched and sharded multisample runs; -m 1 needs -x, as in the JAX
    package."""
    rsh, aln = fixture
    with pytest.raises(SystemExit) as exc:
        torch_cli.main(flags + [rsh, str(tmp_path), "s", aln])
    assert exc.value.code == 1
    assert message in capsys.readouterr().err
