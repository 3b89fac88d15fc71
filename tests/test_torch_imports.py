"""The port imports and runs without JAX, and resolves its device loudly."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from emsar_tpu_torch import device as device_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test workers share the machine's cores: one intra-op thread each keeps
# the many tiny torch ops of the EM loops from oversubscribing them
torch.set_num_threads(1)

_NO_JAX = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # any "import jax" now raises ImportError
    import numpy as np
    import emsar_tpu_torch
    import emsar_tpu_torch.cli.emsar
    import emsar_tpu_torch.kernels.squarem
    import emsar_tpu_torch.model.quantify as quant
    from emsar_tpu.config import BuildConfig, QuantConfig
    from emsar_tpu.ingest.collapse import SampleCounts
    from emsar_tpu.io.fasta import build_transcriptome
    from emsar_tpu.sim import gene_family_transcriptome
    from emsar_tpu_torch.device import resolve_device
    from emsar_tpu_torch.index.build import build_se_index

    rng = np.random.default_rng(1)
    names, seqs, _ = gene_family_transcriptome(rng, 6, n_exons=4,
                                               min_exon=40, max_exon=90)
    idx = build_se_index(build_transcriptome(names, seqs), 20, 20,
                         BuildConfig(verbose=0))
    counts = SampleCounts(
        single_counts=rng.poisson(idx.single_euma[:, 0] * 2.0),
        multi_counts=rng.poisson(idx.multi_euma[:, 0] * 2.0),
        fraglength_counts=np.bincount([20], minlength=401) * 100,
        total_read_count=100)
    dev = resolve_device()
    assert dev.type == "cpu"
    for pallas in (False, True):
        res = quant.quantify_sample(
            idx, counts, QuantConfig(verbose=0, solver_pallas=pallas), dev)
        assert np.isfinite(res.loglik) and np.isfinite(res.fpkm).all()
    assert sys.modules["jax"] is None
    assert not [m for m in sys.modules if m.startswith("jax.")]
    print("OK")
""")


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO, EMSAR_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(device_mod.ENV_VAR, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device()
    monkeypatch.setenv(device_mod.ENV_VAR, "cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device()


def test_device_cpu_when_asked(monkeypatch):
    monkeypatch.setenv(device_mod.ENV_VAR, "cpu")
    assert device_mod.resolve_device() == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    with pytest.raises(RuntimeError, match="unsupported"):
        device_mod.resolve_device("meta")
