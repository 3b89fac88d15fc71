"""The port imports and runs without JAX and without the JAX package, and
resolves its device loudly."""

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
    import os
    import sys
    import tempfile
    # any "import jax" or "import emsar_tpu..." now raises ImportError
    sys.modules["jax"] = None
    sys.modules["emsar_tpu"] = None
    import numpy as np
    import emsar_tpu_torch
    import emsar_tpu_torch.bench.kernel_ab
    import emsar_tpu_torch.bench.multisample
    import emsar_tpu_torch.bench.segment_sum_ab
    import emsar_tpu_torch.cli.emsar as cli
    import emsar_tpu_torch.cli.emsar_build as build_cli
    import emsar_tpu_torch.cli.readgen as readgen_cli
    import emsar_tpu_torch.index.device_build
    import emsar_tpu_torch.index.device_build_pe
    import emsar_tpu_torch.kernels.pe_candidates
    import emsar_tpu_torch.kernels.measure
    import emsar_tpu_torch.kernels.segment_sum
    import emsar_tpu_torch.kernels.squarem
    import emsar_tpu_torch.kernels.window_hash
    import emsar_tpu_torch.model.loop
    import emsar_tpu_torch.model.quantify as quant
    import emsar_tpu_torch.parallel.dist
    import emsar_tpu_torch.parallel.mesh
    from emsar_tpu_torch.config import BuildConfig, QuantConfig
    from emsar_tpu_torch.device import resolve_device
    from emsar_tpu_torch.index.build import build_se_index
    from emsar_tpu_torch.ingest.collapse import SampleCounts
    from emsar_tpu_torch.io.fasta import build_transcriptome, revcomp_bytes
    from emsar_tpu_torch.sim import (fragments_to_reads,
                                     gene_family_transcriptome,
                                     simulate_fragments)

    rng = np.random.default_rng(1)
    names, seqs, _ = gene_family_transcriptome(rng, 6, n_exons=4,
                                               min_exon=40, max_exon=90)
    tx = build_transcriptome(names, seqs)
    # the device backend (the default) on the CPU: the kernels' plain
    # versions
    idx = build_se_index(tx, 20, 20, BuildConfig(verbose=0))
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
    res = quant.quantify_sample(
        idx, counts, QuantConfig(verbose=0, solver_mode="csr"), dev)
    assert np.isfinite(res.loglik) and np.isfinite(res.fpkm).all()
    # the batched multisample solve (parallel/mesh.py, a world of one)
    for res in quant.quantify_samples_batched(
            idx, [counts, counts], QuantConfig(verbose=0), dev):
        assert np.isfinite(res.loglik) and np.isfinite(res.fpkm).all()

    # the CLIs end to end: the SE build, then -I on a bowtie file (native
    # ingest, its own C++ library) and -x with -m 1 on the same file
    d = tempfile.mkdtemp()
    fa = os.path.join(d, "t.fa")
    with open(fa, "w") as fh:
        for n, s in zip(names, seqs):
            fh.write(f">{n}\\n{s.decode()}\\n")
    assert build_cli.main(["-q", fa, "20", d, "idx"]) == 0
    # readgen-torch: SE reads and PE mates
    assert readgen_cli.main(["--seed", "3", fa, "20", "50", d, "rg"]) == 0
    assert readgen_cli.main(["--seed", "3", "-P", "-f", "60", fa, "20",
                             "50", d, "rg"]) == 0
    for out in ("rg", "rg.R1", "rg.R2"):
        with open(os.path.join(d, out)) as fh:
            assert fh.read().count(">") == 50
    _, r1, _ = fragments_to_reads(tx, simulate_fragments(tx, 20, 300, rng),
                                  20, 20, pe=False)
    aln = os.path.join(d, "a.bowtieout")
    with open(aln, "w") as fh:
        for i, read in enumerate(r1):
            for strand, q in (("+", read), ("-", revcomp_bytes(read))):
                for n, s in zip(names, seqs):
                    p = s.find(q)
                    while p >= 0:
                        fh.write(f"r{i}\\t{strand}\\t{n}\\t{p}\\t"
                                 f"{q.decode()}\\tIIII\\t0\\t\\n")
                        p = s.find(q, p + 1)
    for flags in (["-I", os.path.join(d, "idx.rsh")],
                  ["-m", "1", "-x", fa]):
        out = os.path.join(d, flags[-2])
        assert cli.main(["-q"] + flags + [out, "s", aln]) == 0
        with open(os.path.join(out, "s.0.fpkm")) as fh:
            rows = fh.read().splitlines()
        assert len(rows) == len(names) + 1
    assert os.path.exists(os.path.join(d, "-x", "s.posbias"))

    # the PE build, then -x --PE on PE bowtie pairs of 60-base fragments
    assert build_cli.main(["-q", "--PE", "-f", "40", "-F", "70", fa, "20",
                           d, "pe"]) == 0
    pos = simulate_fragments(tx, 60, 200, rng, strand_specific=True)
    _, r1, r2 = fragments_to_reads(tx, pos, 20, 60, pe=True)
    tids = tx.transcript_of(pos, 20)
    pe_aln = os.path.join(d, "pe.bowtieout")
    with open(pe_aln, "w") as fh:
        for i, (t, p) in enumerate(zip(tids, pos - tx.cuml[tids])):
            fh.write(f"r{i}/1\\t+\\t{names[t]}\\t{p}\\t{r1[i].decode()}\\t"
                     f"IIII\\t0\\t\\nr{i}/2\\t-\\t{names[t]}\\t{p + 40}\\t"
                     f"{revcomp_bytes(r2[i]).decode()}\\tIIII\\t0\\t\\n")
    out = os.path.join(d, "pe_x")
    assert cli.main(["-q", "--PE", "-f", "40", "-F", "70", "-R", "-x", fa,
                     out, "s", pe_aln]) == 0
    with open(os.path.join(out, "s.rsh"), "rb") as a, \\
            open(os.path.join(d, "pe.rsh"), "rb") as b:
        assert a.read() == b.read()
    with open(os.path.join(out, "s.0.fpkm")) as fh:
        assert len(fh.read().splitlines()) == len(names) + 1
    from emsar_tpu_torch.ingest import native
    assert native.available()
    assert sys.modules["jax"] is None and sys.modules["emsar_tpu"] is None
    assert not [m for m in sys.modules
                if m.startswith(("jax.", "emsar_tpu."))]
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
