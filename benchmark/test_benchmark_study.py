"""The study cell, ``smallref_se50.study16``, on the CPU at a tiny size:
whole runs through the harness come out correct for the program's ``emsar
-M --batch_samples`` and not correct with a fault planted underneath the
timed path (``benchmark/faulty_child.py``); the plain reference judges
every sample of a small batched study (the program passes, the reference's
own solve stopped after its first EM step fails); and the frozen byte
count of ``study.cluster_roofline_pct`` at a fixed shape."""

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import gen, refbuild, refquant, run

CPU = torch.device("cpu")
CELL = "smallref_se50.study16"


def tiny_cell(tmp_path, reads, genes=6):
    cell = run.load_cell(CELL)
    conf = json.loads(json.dumps(cell.config))
    conf["transcriptome"].update(genes=genes)
    conf["name"] += "_test"
    conf["reads_per_sample"] = reads
    path = str(tmp_path / "config.json")
    with open(path, "w") as fh:
        json.dump(conf, fh)
    return dataclasses.replace(cell, config=conf, config_path=path)


@pytest.mark.parametrize("fault", [None, "half", "altered"])
def test_study_fault_is_caught(fault, tmp_path):
    """One window of the cell: one study of 16 samples, every sample held
    to the reference under the cell's own limits."""
    child = None
    if fault:
        child = [sys.executable, "-m", "benchmark.faulty_child", fault]
    h = run.Harness(device="cpu", child=child, work=str(tmp_path / "work"))
    out = run.run_cell(tiny_cell(tmp_path, 2000), 2**31 + 7, 0.0, False, h)
    assert out["attempted"] == 1
    assert out["correct"] is (fault is None), out["checks"]


def test_batched_study_meets_reference(tmp_path):
    """``emsar -M --batch_samples`` over 4 samples of one gene-family
    transcriptome: each sample's outputs as the reference's maximum gives
    them, within the cell's limits; the reference's solve stopped after its
    first EM step keeps each module's reads and fails on the likelihood."""
    limits = run.load_cell(CELL).limits
    seqs, st = gen.gene_family(np.random.default_rng(9), 12, 2, 8, 8, 80,
                               400)
    idx = refbuild.build(seqs, st.names, 50, CPU)
    rsh = str(tmp_path / "idx.rsh")
    open(rsh, "wb").write(idx.rsh_text())
    alns, paths = [], []
    for k in range(4):
        aln = gen.sample_reads(st, 50, 4000,
                               gen.abundance(len(st.names), 2.0,
                                             gen.rng_for(13, 3, k)),
                               gen.rng_for(13, 1, k), 0.5)
        path = str(tmp_path / f"s{k}.bowtieout")
        gen.write_bowtie(path, aln, st.names, 50)
        alns.append(aln)
        paths.append(path)
    lst = str(tmp_path / "study.list")
    with open(lst, "w") as fh:
        fh.write("\n".join(paths) + "\n")
    out = str(tmp_path / "out")
    subprocess.run([sys.executable, "-m", "emsar_tpu_torch.cli.emsar", "-M",
                    "--batch_samples", "-I", rsh, out, "s", lst],
                   cwd=run.ROOT, env=run.child_env("cpu"), check=True,
                   capture_output=True)
    for k, aln in enumerate(alns):
        ref = refquant.Reference(idx, aln, CPU)
        nums = refquant.judge(ref, os.path.join(out, f"s.{k}.fpkm"),
                              os.path.join(out,
                                           f"s.{k}.fraglength_effect"))
        assert all(nums[n] <= lim for n, lim in limits.items()), (k, nums)
        assert abs(nums["loglik_gap"]) < 1e-3, (k, nums)
        refquant.fault_outputs(ref, str(tmp_path / f"fault{k}"))
        f = refquant.judge(ref, str(tmp_path / f"fault{k}.fpkm"),
                           str(tmp_path / f"fault{k}.fraglength_effect"))
        assert f["loglik_gap"] > limits["loglik_gap"], (k, f)


def test_cluster_roofline_bytes_at_a_fixed_shape(tmp_path):
    """The frozen bytes of one launch of each cluster kernel at the study's
    batched shape (94,985 edges, 32,860 segments, 12,090 transcripts, 16
    rows of per-row operands, float64), and the reader's share on a run
    whose trace gives the two kernels twice their least time; a run
    without the spans or without the kernels in its trace reads None."""
    reader = run.metric_reader("study.cluster_roofline_pct")
    per = reader.launch_bytes(94985, 32860, 12090, 16, 16, 8)
    assert per == {"cluster_em_pair": 16310256,
                   "cluster_extrap_gain": 23175152}
    log = tmp_path / "log"
    log.write_text(
        "[emsar] solve: sharded loop: 1.000s samples=16 blocks=10 "
        "stop=converged gain=repaired edges=94985 segments=32860 "
        "transcripts=12090 rows=16 operand_rows=16 cluster_launches=176\n")
    least = 88 * sum(per.values()) / 3.35e12

    def one_run(lines, by_name):
        log.write_text(lines)
        inv = run.Invocation(1.0, 4000000, {"log": str(log), "trace": {
            "by_name": by_name}}, True, "", "", 0)
        cell = types.SimpleNamespace(config={"solver_dtype": "float64"})
        return reader.read(run.Run(cell, 0.0, 1.0, [inv], {}))

    spans = log.read_text()
    times = {"void cluster_em_pair_kernel<double, 1>(...)": least,
             "void cluster_extrap_gain_kernel<double, 1>(...)": least,
             "void other_kernel(...)": 5.0}
    assert one_run(spans, times) == pytest.approx(50.0)
    assert one_run("", times) is None
    assert one_run(spans, {"void other_kernel(...)": 5.0}) is None
