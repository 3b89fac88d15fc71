"""The port's multisample and multi-process paths against the JAX
package's, on the CPU: ``quantify_samples_batched``, ``emsar -M
--batch_samples``, ``--dist_merge_shards`` in one process and in two CLI
processes (a gloo group over 127.0.0.1, torch's own environment), the
count merge in a world of two, and the process-sharded ``emsar-build
--PE``.  Fixtures come from ``emsar_tpu``'s builders.

Tolerances: per-sample logL rel 1e-9 and gene TPM rel 1e-3 of max(TPM, 1)
between the packages (the batched solve stops on the batch's summed gain
and runs no f64 polish, so isoforms on flat likelihood directions may sit
apart); FPKM at ``tests/test_cli_paths.py``'s batched-vs-loop tolerances
(rtol 1e-6, atol 1e-4) against the port's own per-sample path; the
outputs of a merge of shards, and every ``.rsh`` and
``.fraglength_effect``, byte-equal."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from emsar_tpu.cli import emsar as jax_cli
from emsar_tpu.config import BuildConfig as JaxBuildConfig
from emsar_tpu.config import QuantConfig as JaxQuantConfig
from emsar_tpu.config import StrandType as JaxStrandType
from emsar_tpu.index.build import build_pe_index as jax_build_pe_index
from emsar_tpu.index.build import build_se_index as jax_build_se_index
from emsar_tpu.ingest.collapse import SampleCounts as JaxSampleCounts
from emsar_tpu.io.fasta import build_transcriptome as jax_transcriptome
from emsar_tpu.io.rsh import RshIndex as JaxRshIndex
from emsar_tpu.model.quantify import \
    quantify_sample as jax_quantify_sample
from emsar_tpu.model.quantify import \
    quantify_samples_batched as jax_quantify_batched
from emsar_tpu.sim import fragments_to_reads, simulate_fragments
from emsar_tpu_torch.bench.multisample import split_by_qname
from emsar_tpu_torch.cli import emsar as torch_cli
from emsar_tpu_torch.config import BuildConfig, QuantConfig, StrandType
from emsar_tpu_torch.index import device_build_pe as tpe
from emsar_tpu_torch.index.device_build import DeviceRef
from emsar_tpu_torch.io.fasta import build_transcriptome
from emsar_tpu_torch.io.rsh import RshIndex
from emsar_tpu_torch.model import quantify as tquant
from emsar_tpu_torch.model.solver import build_problem
from emsar_tpu_torch.parallel import dist
from tests.aligner import bowtie_lines_se
from tests.test_torch_cli import _gene_tpm, _loglik, _make_fixture, _parse_fpkm
from tests.torch_dist_workers import allreduce_counts, free_port, run_world
from tests.util import random_transcriptome, write_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("EMSAR_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(rsh, whole alignment file, list of its 4 qname-split samples)."""
    d = tmp_path_factory.mktemp("dist")
    rsh, aln = _make_fixture(d)
    split_by_qname(aln, str(d), "sample", 4)
    return rsh, aln, str(d / "sample.list")


def _counts(rsh, paths):
    """The port's SampleCounts of each alignment file, and its index."""
    index = RshIndex.load(rsh)
    cfg = QuantConfig(verbose=0, min_fraglength=index.min_fraglength,
                      max_fraglength=index.max_fraglength)
    names = {n: i for i, n in enumerate(index.names)}
    return index, [torch_cli._collapse_python(index, names, cfg, p, [-1])
                   for p in paths]


def _tpm(names, fpkm):
    return _gene_tpm(names, np.tile(fpkm[:, None] / fpkm.sum() * 1e6, 6))


def test_split_by_qname_keeps_reads_whole(fixture):
    rsh, aln, listfile = fixture
    paths = open(listfile).read().split()
    reads = [[ln.split("\t", 1)[0] for ln in open(p)] for p in paths]
    assert len(paths) == 4 and all(reads)
    owner = {}
    for i, names in enumerate(reads):
        for n in names:
            assert owner.setdefault(n, i) == i  # a read's lines stay together
    assert sorted(ln for p in paths for ln in open(p)) == sorted(open(aln))


def test_batched_matches_jax(fixture):
    """``quantify_samples_batched`` on 4 samples with the JAX package's
    gain (``solver_gain`` 'jax'): per sample, logL and gene TPM as the JAX
    package's batched path gives them; ``wf`` and iEUMA equal.  With the
    port's default gain, whose solve stops on a real gain where the JAX
    package's batched solve may stop on a NaN one first: each sample's
    logL no lower than that path's less rel 1e-9, and logL and gene TPM
    as the JAX package's per-sample path (``quantify_sample``, the ``-M``
    loop) gives them."""
    rsh, _, listfile = fixture
    paths = open(listfile).read().split()
    index, counts = _counts(rsh, paths)
    cfg = QuantConfig(verbose=0, min_fraglength=index.min_fraglength,
                      max_fraglength=index.max_fraglength)
    jcfg = JaxQuantConfig(verbose=0, min_fraglength=index.min_fraglength,
                          max_fraglength=index.max_fraglength)
    jindex = JaxRshIndex.load(rsh)
    jcounts = [JaxSampleCounts(**c.__dict__) for c in counts]
    want = jax_quantify_batched(jindex, jcounts, jcfg)
    loop = [jax_quantify_sample(jindex, c, jcfg) for c in jcounts]
    for gain in ("jax", "repaired"):
        got = tquant.quantify_samples_batched(
            index, counts, dataclasses.replace(cfg, solver_gain=gain), CPU)
        assert got is not None and len(got) == len(want) == 4
        assert got[0].loglik == got[3].loglik  # the batch's total, as in JAX
        if gain == "jax":
            assert abs(got[0].loglik - want[0].loglik) <= \
                1e-9 * abs(want[0].loglik)
        for s, (g, w) in enumerate(zip(got, want)):
            x = tquant.prepare_sample(index, counts[s], cfg)
            problem = build_problem(x.graph, x.modules, x.eumaps,
                                    x.read_count)
            ll_g, ll_w, ll_l = (tquant._host_loglik(problem, r.fpkm)
                                for r in (g, w, loop[s]))
            assert ll_g - ll_w >= -1e-9 * abs(ll_w), (gain, s, ll_g, ll_w)
            ref, ll_ref = (w, ll_w) if gain == "jax" else (loop[s], ll_l)
            assert abs(ll_g - ll_ref) <= 1e-9 * abs(ll_ref), \
                (gain, s, ll_g, ll_ref)
            tg, tw = _tpm(index.names, g.fpkm), _tpm(index.names, ref.fpkm)
            assert (np.abs(tg - tw) / np.maximum(tw, 1.0)).max() <= 1e-3
            assert np.array_equal(g.wf, w.wf)
            assert np.array_equal(g.ieuma, w.ieuma)
            assert g.fpkm_rounds.shape == w.fpkm_rounds.shape


def test_batched_matches_per_sample(tmp_path):
    """On ``tests/test_cli_paths.py``'s batched-vs-loop fixture (25 random
    transcripts sharing sequence, rl 18, a sample and its first half),
    each sample's FPKM as the port's own ``quantify_sample`` gives it, at
    that test's tolerances.  (The gene-family fixture above has collinear
    isoforms, whose FPKM no stopping rule pins down.)"""
    rng = np.random.default_rng(85)
    names, seqs = random_transcriptome(rng, 25, min_len=60, max_len=300,
                                       shared_frac=0.5)
    tx = jax_transcriptome(names, seqs)
    rsh = str(tmp_path / "idx.rsh")
    jax_build_se_index(tx, 18, 18, JaxBuildConfig(verbose=0)).write_text(rsh)
    _, r1, _ = fragments_to_reads(tx, simulate_fragments(tx, 18, 1200, rng),
                                  18, 18, pe=False)
    lines = [ln + "\n" for i, read in enumerate(r1)
             for ln in bowtie_lines_se(f"r{i}", read, names, seqs)]
    paths = [str(tmp_path / "a1"), str(tmp_path / "a2")]
    for p, part in zip(paths, (lines, lines[:len(lines) // 2])):
        with open(p, "w") as fh:
            fh.writelines(part)
    index, counts = _counts(rsh, paths)
    cfg = QuantConfig(verbose=0, min_fraglength=index.min_fraglength,
                      max_fraglength=index.max_fraglength)
    got = tquant.quantify_samples_batched(index, counts, cfg, CPU)
    for g, c in zip(got, counts):
        one = tquant.quantify_sample(index, c, cfg, CPU)
        np.testing.assert_allclose(g.fpkm, one.fpkm, rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(g.ieuma, one.ieuma)


def test_cli_batch_samples_matches_jax(fixture, tmp_path):
    """``emsar -M --batch_samples`` of the port (its default gain) against
    the JAX package's: each sample's logL no lower than its batched run's
    less rel 1e-9, and logL and gene TPM as its ``-M`` loop gives them,
    which runs each sample to its maximum; ``.fraglength_effect`` equal."""
    rsh, _, listfile = fixture
    out_j, out_l, out_t = (tmp_path / k for k in ("jax", "jax_loop",
                                                  "torch"))
    args = ["-q", "-M", "--batch_samples", "-I", rsh]
    assert jax_cli.main(args + [str(out_j), "s", listfile]) == 0
    assert jax_cli.main(["-q", "-M", "-I", rsh, str(out_l), "s",
                         listfile]) == 0
    assert torch_cli.main(args + [str(out_t), "s", listfile]) == 0
    for i, aln in enumerate(open(listfile).read().split()):
        pj, pl, pt = (d / f"s.{i}" for d in (out_j, out_l, out_t))
        assert (open(f"{pt}.fraglength_effect", "rb").read()
                == open(f"{pj}.fraglength_effect", "rb").read())
        names, cols_t = _parse_fpkm(f"{pt}.fpkm")
        cols_j, cols_l = (_parse_fpkm(f"{p}.fpkm")[1] for p in (pj, pl))
        ll_t, ll_j, ll_l = (_loglik(rsh, aln, c[:, 0])
                            for c in (cols_t, cols_j, cols_l))
        assert ll_t - ll_j >= -1e-9 * abs(ll_j), (i, ll_t, ll_j)
        assert abs(ll_t - ll_l) <= 1e-9 * abs(ll_l), (i, ll_t, ll_l)
        tt, tl = (_tpm(names, c[:, 0]) for c in (cols_t, cols_l))
        assert (np.abs(tt - tl) / np.maximum(tl, 1.0)).max() <= 1e-3


def _shards(fixture, tmp_path, n):
    _, aln, _ = fixture
    split_by_qname(aln, str(tmp_path), "shard", n)
    return str(tmp_path / "shard.list")


def test_dist_merge_shards_single_process(fixture, tmp_path):
    """The in-process shard loop writes the whole-file run's bytes, and
    the JAX package's --dist_merge_shards output's logL."""
    rsh, aln, _ = fixture
    listfile = _shards(fixture, tmp_path, 3)
    whole, sharded, jax_out = (tmp_path / k for k in ("whole", "sharded",
                                                      "jax"))
    assert torch_cli.main(["-q", "-I", rsh, str(whole), "s", aln]) == 0
    flags = ["-q", "-M", "--dist_merge_shards", "-I", rsh]
    assert torch_cli.main(flags + [str(sharded), "s", listfile]) == 0
    assert jax_cli.main(flags + [str(jax_out), "s", listfile]) == 0
    for ext in ("fpkm", "fraglength_effect"):
        assert ((whole / f"s.0.{ext}").read_bytes()
                == (sharded / f"s.0.{ext}").read_bytes())
    assert ((jax_out / "s.0.fraglength_effect").read_bytes()
            == (sharded / "s.0.fraglength_effect").read_bytes())
    ll_t, ll_j = (_loglik(rsh, aln, _parse_fpkm(str(d / "s.0.fpkm"))[1][:, 0])
                  for d in (sharded, jax_out))
    assert abs(ll_t - ll_j) <= 1e-9 * abs(ll_j), (ll_t, ll_j)


def _launch(argvs, timeout=300):
    """Run each argv as one rank of a gloo world over 127.0.0.1 (torch's
    environment); returns when all exit 0, raises otherwise."""
    port = free_port()
    procs = []
    for rank, argv in enumerate(argvs):
        env = dict(os.environ, PYTHONPATH=REPO, EMSAR_TORCH_DEVICE="cpu",
                   OMP_NUM_THREADS="1", RANK=str(rank),
                   WORLD_SIZE=str(len(argvs)), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), LOCAL_RANK="0")
        procs.append(subprocess.Popen(argv, env=env, cwd=REPO,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]


def test_dist_merge_shards_two_processes(fixture, tmp_path):
    """Two CLI processes over 4 shards write the single-process run's
    bytes (process 0 writes, process 1 writes nothing)."""
    rsh, _, _ = fixture
    listfile = _shards(fixture, tmp_path, 4)
    single, two = tmp_path / "single", tmp_path / "two"
    flags = ["-q", "-M", "--dist_merge_shards", "-I", rsh]
    assert torch_cli.main(flags + [str(single), "s", listfile]) == 0
    _launch([[sys.executable, "-m", "emsar_tpu_torch.cli.emsar", *flags,
              str(two), "s", listfile]] * 2)
    assert sorted(os.listdir(two)) == sorted(os.listdir(single))
    for ext in ("fpkm", "fraglength_effect"):
        assert ((single / f"s.0.{ext}").read_bytes()
                == (two / f"s.0.{ext}").read_bytes())


def test_cli_batch_samples_two_processes(fixture, tmp_path):
    """``-M --batch_samples`` in two CLI processes (the batched solve's
    edges split over tp = 2, its partial sums all-reduced over gloo):
    process 0 writes each sample's outputs, at the logL of one process's
    run (rel 1e-9), with the same .fraglength_effect."""
    rsh, _, listfile = fixture
    one, two = tmp_path / "one", tmp_path / "two"
    flags = ["-q", "-M", "--batch_samples", "-I", rsh]
    assert torch_cli.main(flags + [str(one), "s", listfile]) == 0
    _launch([[sys.executable, "-m", "emsar_tpu_torch.cli.emsar", *flags,
              str(two), "s", listfile]] * 2)
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))
    for i, aln in enumerate(open(listfile).read().split()):
        assert ((one / f"s.{i}.fraglength_effect").read_bytes()
                == (two / f"s.{i}.fraglength_effect").read_bytes())
        ll_1, ll_2 = (_loglik(rsh, aln, _parse_fpkm(str(d / f"s.{i}.fpkm"))
                              [1][:, 0]) for d in (one, two))
        assert abs(ll_2 - ll_1) <= 1e-9 * abs(ll_1), (i, ll_2, ll_1)


def test_allreduce_counts_two_ranks(tmp_path):
    """The count merge of a world of two: exact int64 sums past 2^53 (a
    float sum would round them), the same on both ranks; each rank's
    strided share of a list."""
    run_world(allreduce_counts, 2, str(tmp_path))
    want = 3 * 2**53 + 1
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for r, got in enumerate(ranks):
        assert int(got["world"]) == 2
        for k in ("single", "multi", "fl"):
            assert got[k].dtype == np.int64 and (got[k] == want).all()
        assert int(got["total"]) == want
        assert list(got["share"]) == list("abcde")[r::2]


def test_dist_single_process_is_the_identity(monkeypatch):
    """Without WORLD_SIZE > 1 no group forms and each function is the
    single-process case."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert dist.maybe_init_from_env() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert dist.maybe_init_from_env() is False
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    assert dist.is_main() and dist.shard_list(["a", "b"]) == ["a", "b"]
    c = JaxSampleCounts(single_counts=np.arange(3), multi_counts=np.arange(2),
                        fraglength_counts=np.arange(4), total_read_count=5)
    assert dist.allreduce_counts(c) is c
    dist.barrier()
    assert dist.rank_device(torch.device("cuda")) == torch.device("cuda")


PE_ARGS = ["-q", "--PE", "-s", "ssfr", "-f", "1", "-F", "60"]
PE_BUDGET = 300  # candidates a chunk: >= 4 chunks on the test's index


def test_sharded_pe_build_two_processes(tmp_path):
    """Two ``emsar-build-torch --PE`` processes, each building every
    second chunk of a >= 4-chunk plan (a budget the launcher sets), write
    the bytes of one process's build and of ``emsar_tpu``'s."""
    names, seqs = random_transcriptome(np.random.default_rng(402), 15,
                                       min_len=60, max_len=200,
                                       shared_frac=0.6)
    fasta = str(tmp_path / "t.fa")
    write_fasta(fasta, names, seqs)
    tx = build_transcriptome(names, seqs)
    ref = DeviceRef(tx, CPU)
    _, _, srank = tpe.rank_pass(ref, ref.t32(18), 18, False, 0)
    assert len(tpe.plan_chunks(srank, 60 - 18 + 1, PE_BUDGET)) >= 4
    single, two = tmp_path / "single", tmp_path / "two"
    from emsar_tpu_torch.cli import emsar_build
    assert emsar_build.main(PE_ARGS + [fasta, "18", str(single), "s"]) == 0
    launcher = (
        "import sys\n"
        "from emsar_tpu_torch.index import device_build_pe\n"
        f"device_build_pe.CHUNK_CANDIDATES = {PE_BUDGET}\n"
        "from emsar_tpu_torch.cli import emsar_build\n"
        "sys.exit(emsar_build.main(sys.argv[1:]))\n")
    _launch([[sys.executable, "-c", launcher, *PE_ARGS, fasta, "18",
              str(two), "s"]] * 2)
    assert sorted(os.listdir(two)) == ["s.part0of2.npz", "s.part1of2.npz",
                                       "s.rsh", "s.rsh.npz"]
    want = jax_build_pe_index(
        jax_transcriptome(names, seqs), 18,
        JaxBuildConfig(pe=True, strand=JaxStrandType.parse("ssfr", True),
                       min_fraglength=1, max_fraglength=60, verbose=0),
        backend="numpy")
    want.write_text(str(tmp_path / "jax.rsh"))
    assert ((two / "s.rsh").read_bytes() == (single / "s.rsh").read_bytes()
            == (tmp_path / "jax.rsh").read_bytes())
    parts = [RshIndex.read_npz(str(two / f"s.part{i}of2.npz"))
             for i in range(2)]
    assert all(p.n_multi > 0 or p.single_euma.any() for p in parts)
