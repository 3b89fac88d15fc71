"""The port's index-building entry points against the JAX package's CLIs
on the CPU: ``emsar-build-torch`` against ``emsar_tpu.cli.emsar_build``
(.rsh bytes), and ``emsar-torch -x`` against ``emsar_tpu.cli.emsar -x`` on
readgen reads (.rsh from -R, .fraglength_effect and .posbias bytes, logL,
gene TPM)."""

import numpy as np
import pytest

from emsar_tpu.cli import emsar as jax_cli
from emsar_tpu.cli import emsar_build as jax_build_cli
from emsar_tpu.cli import readgen
from emsar_tpu.sim import gene_family_transcriptome
from emsar_tpu_torch.cli import emsar as torch_cli
from emsar_tpu_torch.cli import emsar_build as torch_build_cli
from tests.aligner import bowtie_lines_se
from tests.test_torch_cli import _gene_tpm, _loglik, _parse_fpkm
from tests.util import write_fasta

READLEN = 20


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("EMSAR_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("EMSAR_TORCH_BUILD_BACKEND", raising=False)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(fasta, bowtie alignments of readgen reads)."""
    tmp = tmp_path_factory.mktemp("xcli")
    rng = np.random.default_rng(71)
    names, seqs, _ = gene_family_transcriptome(rng, 10, n_exons=5,
                                               min_exon=40, max_exon=120)
    fa = str(tmp / "tx.fa")
    write_fasta(fa, names, seqs)
    assert readgen.main(["--seed", "5", fa, str(READLEN), "2000", str(tmp),
                         "reads.fa"]) == 0
    with open(tmp / "reads.fa") as fh:
        lines = fh.read().split()
    aln = str(tmp / "aln.bowtieout")
    with open(aln, "w") as fh:
        for name, read in zip(lines[0::2], lines[1::2]):
            for ln in bowtie_lines_se(name[1:], read.encode(), names, seqs):
                fh.write(ln + "\n")
    return fa, aln


@pytest.mark.parametrize("strand", ["ns", "ssf"])
def test_build_cli_matches_jax(fixture, tmp_path, strand):
    fa, _ = fixture
    args = ["-q", "-s", strand, fa, "19-21"]
    assert jax_build_cli.main(args + [str(tmp_path / "j"), "idx"]) == 0
    assert torch_build_cli.main(args + [str(tmp_path / "t"), "idx"]) == 0
    want = (tmp_path / "j" / "idx.rsh").read_bytes()
    assert (tmp_path / "t" / "idx.rsh").read_bytes() == want
    assert (tmp_path / "t" / "idx.rsh.npz").exists()


def test_build_cli_pe_not_ported(fixture, tmp_path, capsys):
    fa, _ = fixture
    with pytest.raises(SystemExit) as exc:
        torch_build_cli.main(["-q", "--PE", fa, "20", str(tmp_path), "i"])
    assert exc.value.code == 1
    assert "not yet ported to emsar_tpu_torch" in capsys.readouterr().err


def _run_both(fixture, tmp_path, flags):
    fa, aln = fixture
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    assert jax_cli.main(["-q"] + flags + ["-x", fa, str(out_j), "s",
                                          aln]) == 0
    assert torch_cli.main(["-q"] + flags + ["-x", fa, str(out_t), "s",
                                            aln]) == 0
    return out_j, out_t


def test_fasta_path_matches_jax(fixture, tmp_path):
    """``-x ... -R``: the index built from the FASTA over the read-length
    range learned from the alignments, and the sample quantified on it."""
    out_j, out_t = _run_both(fixture, tmp_path, ["-R"])
    assert (out_t / "s.rsh").read_bytes() == (out_j / "s.rsh").read_bytes()
    assert ((out_t / "s.0.fraglength_effect").read_bytes()
            == (out_j / "s.0.fraglength_effect").read_bytes())
    names_j, cols_j = _parse_fpkm(str(out_j / "s.0.fpkm"))
    names_t, cols_t = _parse_fpkm(str(out_t / "s.0.fpkm"))
    assert names_t == names_j
    rsh_path, aln = str(out_t / "s.rsh"), fixture[1]
    ll_j = _loglik(rsh_path, aln, cols_j[:, 0])
    ll_t = _loglik(rsh_path, aln, cols_t[:, 0])
    assert abs(ll_t - ll_j) <= 1e-9 * abs(ll_j), (ll_t, ll_j)
    # at equal logL (3e-13 here) the two solves may stop at different
    # points of a gene's flat maximizer directions, whose isoforms differ
    # in effective length: gene TPM then moves by ~1e-5 relative (PERF.md
    # Findings), so it is held to rel 1e-4 of max(TPM, 1)
    tpm_j, tpm_t = _gene_tpm(names_j, cols_j), _gene_tpm(names_t, cols_t)
    assert np.all(np.abs(tpm_t - tpm_j) <= 1e-4 * np.maximum(tpm_j, 1.0))
    # and -x is -I on the index it built, byte for byte
    out_i = tmp_path / "torch_I"
    assert torch_cli.main(["-q", "-I", rsh_path, str(out_i), "s", aln]) == 0
    for ext in ("fpkm", "fraglength_effect"):
        assert ((out_i / f"s.0.{ext}").read_bytes()
                == (out_t / f"s.0.{ext}").read_bytes())


def test_posbias_matches_jax(fixture, tmp_path):
    out_j, out_t = _run_both(fixture, tmp_path, ["-m", "1", "-W", "300"])
    want = (out_j / "s.posbias").read_bytes()
    assert len(want) > 0
    assert (out_t / "s.posbias").read_bytes() == want
    assert ((out_t / "s.0.fraglength_effect").read_bytes()
            == (out_j / "s.0.fraglength_effect").read_bytes())


def test_fasta_path_needs_a_file(fixture, tmp_path, capsys):
    fa, _ = fixture
    with pytest.raises(SystemExit) as exc:
        torch_cli.main(["-q", "-x", fa, str(tmp_path), "s"])
    assert exc.value.code == 1
    assert "single-end -x requires a file" in capsys.readouterr().err
