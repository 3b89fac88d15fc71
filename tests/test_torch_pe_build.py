"""The port's PE index build against the JAX package's, on the CPU (the
kernels' plain versions): the ``.rsh`` bytes of the port's device build
against ``emsar_tpu.index.build.build_pe_index`` with its device and NumPy
backends, on the cases of the JAX package's PE goldens."""

import numpy as np
import pytest
import torch

from emsar_tpu.config import BuildConfig as JaxBuildConfig
from emsar_tpu.config import StrandType as JaxStrandType
from emsar_tpu.index import device_build as jdb
from emsar_tpu.index.build import build_pe_index as jax_build_pe_index
from emsar_tpu.io.fasta import build_transcriptome as jax_transcriptome
from emsar_tpu_torch.config import BuildConfig, StrandType
from emsar_tpu_torch.index import build as tbuild
from emsar_tpu_torch.index import device_build_pe as tpe
from emsar_tpu_torch.io.fasta import build_transcriptome
from tests.util import random_transcriptome

torch.set_num_threads(1)


def _bases(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _multi_d_drop():
    """A singleton mate1 whose mate2 window repeats at two distinct d in
    the fragment range (tests/test_device_build.py::
    test_singleton_multi_d_drop)."""
    rng = np.random.default_rng(404)
    base, rep = _bases(rng, 30), _bases(rng, 24)
    t0 = base + rep + rep + _bases(rng, 30)
    names = ["REP0"] + [f"D{i}" for i in range(6)]
    seqs = [t0.encode()] + [_bases(rng, 90).encode() for _ in range(6)]
    return names, seqs


def _random(seed, n, n_frac=0.0, min_len=30, max_len=400, shared=0.6):
    return random_transcriptome(np.random.default_rng(seed), n,
                                min_len=min_len, max_len=max_len,
                                n_frac=n_frac, shared_frac=shared)


# name: (transcriptome, strand, read length, min frag, max frag, chunk
# budget of the port's build (None: its default), JAX build settings)
CASES = {
    "ns": (lambda: _random(14, 15), "ns", 20, 1, 60, None, {}),
    "ssfr": (lambda: _random(15, 15), "ssfr", 20, 1, 60, None, {}),
    "with_N": (lambda: _random(16, 12, 0.02), "ns", 15, 1, 50, None, {}),
    "ssfr_with_N": (lambda: _random(29, 12, 0.02), "ssfr", 15, 1, 70, None,
                    {"global_budget": 0}),
    "min_frag_gt_rl_ssfr": (lambda: _random(30, 15), "ssfr", 20, 50, 120,
                            None, {"global_budget": 0}),
    "min_frag_gt_rl_ns": (lambda: _random(31, 15), "ns", 20, 60, 80, None,
                          {}),
    "wide_ssfr": (lambda: _random(27, 12), "ssfr", 20, 1, 400, None, {}),
    "wide_ns": (lambda: _random(28, 12), "ns", 20, 1, 400, None, {}),
    "chunks_ns": (lambda: _random(105, 20, min_len=30, max_len=150,
                                  shared=0.7), "ns", 16, 1, 50, 50 * 24,
                  {"global_budget": 0, "chunk_candidates": 1 << 12}),
    "chunks_ssfr": (lambda: _random(141, 20, min_len=100, max_len=300,
                                    shared=0.5), "ssfr", 24, 60, 100,
                    41 * 8, {"global_budget": 0}),
    "multi_d_drop_ns": (_multi_d_drop, "ns", 16, 40, 80, None, {}),
    "multi_d_drop_ssfr": (_multi_d_drop, "ssfr", 16, 40, 80, None,
                          {"global_budget": 0}),
    "jax_sig_table": (lambda: _random(32, 15), "ssfr", 18, 1, 55, None,
                      {"global_budget": 0, "sig_table": True}),
}


def _rsh_bytes(index, path):
    index.write_text(str(path))
    return path.read_bytes()


def _jax_build(monkeypatch, names, seqs, strand, rl, fmin, fmax, backend,
               global_budget=None, chunk_candidates=None, sig_table=False):
    with monkeypatch.context() as m:
        if global_budget is not None:
            m.setattr(jdb, "PE_GLOBAL_BUDGET", global_budget)
        if sig_table:
            m.setenv("EMSAR_SIG_TABLE", "1")
        cfg = JaxBuildConfig(pe=True, strand=JaxStrandType.parse(strand, True),
                             min_fraglength=fmin, max_fraglength=fmax,
                             verbose=0)
        if chunk_candidates:
            cfg.pe_chunk_candidates = chunk_candidates
        return jax_build_pe_index(jax_transcriptome(names, seqs), rl, cfg,
                                  backend=backend)


def _cfg(strand, fmin, fmax):
    return BuildConfig(pe=True, strand=StrandType.parse(strand, True),
                       min_fraglength=fmin, max_fraglength=fmax, verbose=0)


@pytest.fixture
def plans(monkeypatch):
    """The chunk bounds of every device PE build of the test, in order."""
    seen = []
    plan = tpe.plan_chunks

    def spy(*args):
        seen.append(plan(*args))
        return seen[-1]

    monkeypatch.setattr(tpe, "plan_chunks", spy)
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_pe_device_build_matches_jax(case, tmp_path, monkeypatch, plans):
    """The port's device build on the CPU writes the bytes of the JAX
    package's device build (its global or cluster-chunked pipeline, or its
    signature table) and of its NumPy build."""
    make, strand, rl, fmin, fmax, budget, jax_kw = CASES[case]
    names, seqs = make()
    want = _rsh_bytes(_jax_build(monkeypatch, names, seqs, strand, rl, fmin,
                                 fmax, "device", **jax_kw),
                      tmp_path / "jax.rsh")
    assert want == _rsh_bytes(_jax_build(monkeypatch, names, seqs, strand,
                                         rl, fmin, fmax, "numpy"),
                              tmp_path / "jax_numpy.rsh")
    monkeypatch.setattr(tpe, "CHUNK_CANDIDATES", budget)
    got = tbuild.build_pe_index(build_transcriptome(names, seqs), rl,
                                _cfg(strand, fmin, fmax), backend="device",
                                device="cpu")
    if budget is not None:
        assert len(plans[-1]) > 3
    assert _rsh_bytes(got, tmp_path / "torch.rsh") == want
