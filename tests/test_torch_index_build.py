"""The port's host NumPy SE builder writes the same .rsh bytes as
``emsar_tpu.index.build.build_se_index`` (default backend)."""

import numpy as np
import pytest

from emsar_tpu.config import BuildConfig, StrandType
from emsar_tpu.index.build import build_se_index as jax_build_se_index
from emsar_tpu.io.fasta import build_transcriptome
from emsar_tpu_torch.index.build import build_se_index
from tests.util import random_transcriptome

CASES = {
    # name: (seed, n_tx, n_frac, strand, rl_min, rl_max, chunk_positions)
    "unstranded": (20, 40, 0.0, "ns", 20, 20, 1 << 20),
    "stranded": (21, 40, 0.0, "ssf", 18, 18, 1 << 20),
    "with_N": (22, 40, 0.02, "ns", 16, 16, 1 << 20),
    "readlength_range": (23, 30, 0.0, "ns", 18, 21, 1 << 20),
    "radix_chunked": (24, 60, 0.0, "ns", 20, 20, 512),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_se_rsh_byte_identical(case, tmp_path):
    seed, n_tx, n_frac, strand, lo, hi, chunk = CASES[case]
    rng = np.random.default_rng(seed)
    names, seqs = random_transcriptome(rng, n_tx, shared_frac=0.6,
                                       n_frac=n_frac)
    tx = build_transcriptome(names, seqs)
    cfg = BuildConfig(verbose=0, strand=StrandType.parse(strand, False),
                      chunk_positions=chunk)
    want = jax_build_se_index(tx, lo, hi, cfg)
    got = build_se_index(tx, lo, hi, cfg)
    assert got.n_multi > 0
    pw, pg = tmp_path / "jax.rsh", tmp_path / "torch.rsh"
    want.write_text(str(pw))
    got.write_text(str(pg))
    assert pg.read_bytes() == pw.read_bytes()
