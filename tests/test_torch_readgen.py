"""``readgen-torch`` (``emsar_tpu_torch/cli/readgen.py``) writes the JAX
package's ``readgen`` bytes for the same ``--seed``: SE reads, and PE
mates (``-P -f 300``) with a strand-specific draw and a header prefix."""

import os

import numpy as np
import pytest

from emsar_tpu.cli import readgen as jax_readgen
from emsar_tpu.sim import gene_family_transcriptome
from emsar_tpu_torch.cli import readgen as torch_readgen
from tests.util import write_fasta


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(31)
    names, seqs, _ = gene_family_transcriptome(rng, 8, n_exons=5,
                                               min_exon=60, max_exon=150)
    path = str(tmp_path_factory.mktemp("readgen") / "t.fa")
    write_fasta(path, names, seqs)
    return path


@pytest.mark.parametrize("flags,outputs", [
    ([], ["r"]),
    (["-s", "-h", "sim"], ["r"]),
    (["-P", "-f", "300"], ["r.R1", "r.R2"]),
    (["-P", "-s", "-f", "300"], ["r.R1", "r.R2"]),
], ids=["se", "se_ss_prefix", "pe", "pe_ss"])
def test_readgen_writes_the_jax_bytes(tmp_path, fasta, flags, outputs):
    args = ["--seed", "7", *flags, fasta, "50", "400"]
    for name, cli in (("jax", jax_readgen), ("torch", torch_readgen)):
        assert cli.main(args + [str(tmp_path / name), "r"]) == 0
    for out in outputs:
        with open(tmp_path / "jax" / out, "rb") as a, \
                open(tmp_path / "torch" / out, "rb") as b:
            want, got = a.read(), b.read()
        assert got == want and got.count(b">") == 400, out


def test_readgen_pe_needs_a_fragment_length(tmp_path, fasta, capsys):
    with pytest.raises(SystemExit) as e:
        torch_readgen.main(["-P", fasta, "50", "10", str(tmp_path), "r"])
    assert e.value.code == 1
    assert "fraglen must be provided" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "r.R1")
