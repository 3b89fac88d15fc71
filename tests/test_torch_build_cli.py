"""The port's index-building entry points against the JAX package's CLIs
on the CPU: ``emsar-build-torch`` (SE and ``--PE``) against
``emsar_tpu.cli.emsar_build`` (.rsh bytes), ``emsar-torch -x`` (SE and
``--PE``) against ``emsar_tpu.cli.emsar -x`` on simulated reads (.rsh
from -R, .fraglength_effect and .posbias bytes, logL, gene TPM), and PE
quantification from a SAM file through ``-I``."""

import numpy as np
import pytest

from emsar_tpu.cli import emsar as jax_cli
from emsar_tpu.cli import emsar_build as jax_build_cli
from emsar_tpu.cli import readgen
from emsar_tpu.io.fasta import build_transcriptome
from emsar_tpu.sim import (fragments_to_reads, gene_family_transcriptome,
                           simulate_fragments)
from emsar_tpu_torch.cli import emsar as torch_cli
from emsar_tpu_torch.cli import emsar_build as torch_build_cli
from emsar_tpu_torch.config import QuantConfig, StrandType
from emsar_tpu_torch.io.rsh import RshIndex
from emsar_tpu_torch.model.quantify import _host_loglik, prepare_sample
from emsar_tpu_torch.model.solver import build_problem
from tests.aligner import bowtie_lines_pe, bowtie_lines_se
from tests.test_torch_cli import _gene_tpm, _loglik, _parse_fpkm
from tests.util import write_fasta

READLEN = 20


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("EMSAR_TORCH_DEVICE", "cpu")


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


@pytest.mark.parametrize("strand", ["ns", "ssfr"])
def test_build_cli_pe_matches_jax(fixture, tmp_path, strand):
    fa, _ = fixture
    args = ["-q", "--PE", "-s", strand, "-f", "45", "-F", "80", fa, "20"]
    assert jax_build_cli.main(args + [str(tmp_path / "j"), "idx"]) == 0
    assert torch_build_cli.main(args + [str(tmp_path / "t"), "idx"]) == 0
    want = (tmp_path / "j" / "idx.rsh").read_bytes()
    assert want.split(b"\n")[0].endswith(b",45,80,20")
    assert (tmp_path / "t" / "idx.rsh").read_bytes() == want
    assert (tmp_path / "t" / "idx.rsh.npz").exists()


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


PE_FRAGS = (50, 62, 75)  # fragment lengths of the simulated pairs
PE_FLAGS = ["-f", "45", "-F", "80"]


@pytest.fixture(scope="module")
def pe_fixture(tmp_path_factory):
    """(fasta, PE bowtie alignments, the same pairs as SAM) of simulated
    fragments of three lengths."""
    tmp = tmp_path_factory.mktemp("pecli")
    rng = np.random.default_rng(72)
    names, seqs, _ = gene_family_transcriptome(rng, 8, n_exons=5,
                                               min_exon=40, max_exon=120)
    fa = str(tmp / "tx.fa")
    write_fasta(fa, names, seqs)
    tx = build_transcriptome(names, seqs)
    lines = []
    for F in PE_FRAGS:
        pos = simulate_fragments(tx, F, 250, rng)
        rn, r1, r2 = fragments_to_reads(tx, pos, READLEN, F, pe=True,
                                        header_prefix=f"f{F}_")
        for i, name in enumerate(rn):
            lines += bowtie_lines_pe(name, r1[i], r2[i], names, seqs)
    aln = str(tmp / "aln.bowtieout")
    with open(aln, "w") as fh:
        fh.writelines(ln + "\n" for ln in lines)
    sam = str(tmp / "aln.sam")
    with open(sam, "w") as fh:
        for a, b in zip(lines[0::2], lines[1::2]):
            mates = [m.split("\t") for m in (a, b)]
            for k, (rid, strand, tname, pos, seq) in enumerate(
                    m[:5] for m in mates):
                flag = 0x1 | (0x40 if k == 0 else 0x80) | (
                    0x10 if strand == "-" else 0)
                other = mates[1 - k]
                fh.write(f"{rid[:-2]}\t{flag}\t{tname}\t{int(pos) + 1}\t255"
                         f"\t{READLEN}M\t=\t{int(other[3]) + 1}\t0\t{seq}\t"
                         f"{'I' * READLEN}\tMD:Z:{READLEN}\n")
    return fa, aln, sam


def _loglik_pe(rsh, aln, fmt, strand, fpkm):
    index = RshIndex.load(rsh)
    cfg = QuantConfig(verbose=0, pe=True, aln_format=fmt,
                      strand=StrandType.parse(strand, True),
                      min_fraglength=index.min_fraglength,
                      max_fraglength=index.max_fraglength)
    counts = torch_cli._collapse_python(
        index, {n: i for i, n in enumerate(index.names)}, cfg, aln,
        [index.readlength])
    x = prepare_sample(index, counts, cfg)
    return _host_loglik(build_problem(x.graph, x.modules, x.eumaps,
                                      x.read_count), fpkm)


def _agree(out_j, out_t, rsh, aln, fmt, strand):
    """.fraglength_effect bytes, gene TPM and logL, as in
    tests/test_torch_cli.py::test_cli_matches_jax."""
    pj, pt = out_j / "s.0", out_t / "s.0"
    want = open(f"{pj}.fraglength_effect", "rb").read()
    assert open(f"{pt}.fraglength_effect", "rb").read() == want
    names_j, cols_j = _parse_fpkm(f"{pj}.fpkm")
    names_t, cols_t = _parse_fpkm(f"{pt}.fpkm")
    assert names_t == names_j
    assert cols_j[:, 3].sum() > 100  # reads were counted
    np.testing.assert_allclose(_gene_tpm(names_t, cols_t),
                               _gene_tpm(names_j, cols_j),
                               rtol=1e-6, atol=1e-5)
    ll_j = _loglik_pe(rsh, aln, fmt, strand, cols_j[:, 0])
    ll_t = _loglik_pe(rsh, aln, fmt, strand, cols_t[:, 0])
    assert abs(ll_t - ll_j) <= 1e-9 * abs(ll_j), (ll_t, ll_j)


@pytest.mark.parametrize("strand", ["ns", "ssfr"])
def test_fasta_path_pe_matches_jax(pe_fixture, tmp_path, strand):
    """``--PE -x ... -R``: the PE index built from the FASTA for the read
    length of the first alignment, and the pairs quantified on it."""
    fa, aln, _ = pe_fixture
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    flags = ["-q", "--PE", "-s", strand, "-R"] + PE_FLAGS
    assert jax_cli.main(flags + ["-x", fa, str(out_j), "s", aln]) == 0
    assert torch_cli.main(flags + ["-x", fa, str(out_t), "s", aln]) == 0
    rsh = str(out_t / "s.rsh")
    assert open(rsh, "rb").read() == (out_j / "s.rsh").read_bytes()
    assert RshIndex.load(rsh).readlength == READLEN
    _agree(out_j, out_t, rsh, aln, "bowtie", strand)


def test_pe_sam_quantify_matches_jax(pe_fixture, tmp_path):
    """``--PE -S -I``: PE quantification of SAM pairs on an index built by
    the JAX package."""
    fa, _, sam = pe_fixture
    rsh = tmp_path / "idx"
    assert jax_build_cli.main(["-q", "--PE"] + PE_FLAGS
                              + [fa, str(READLEN), str(rsh), "idx"]) == 0
    rsh = str(rsh / "idx.rsh")
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    flags = ["-q", "--PE", "-S", "-I", rsh]
    assert jax_cli.main(flags + [str(out_j), "s", sam]) == 0
    assert torch_cli.main(flags + [str(out_t), "s", sam]) == 0
    _agree(out_j, out_t, rsh, sam, "sam", "ns")
