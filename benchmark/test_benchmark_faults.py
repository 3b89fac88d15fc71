"""Whole runs of each cell, on the CPU at a tiny size, past the harness's
look for a card: the program as it is comes out correct, and with each
fault the cell can have planted underneath the timed path
(``benchmark/faulty_child.py``) it comes out not correct, under the cell's
own limits.  The control (the reference in float32 in the program's place)
is held the same way at a size whose modules hold thousands of reads."""

import dataclasses
import json
import os
import sys

import pytest

from benchmark import run

SIZES = {"human_se76": {"genes": 12}}


def tiny_cell(name, tmp_path, reads):
    cell = run.load_cell(name)
    conf = json.loads(json.dumps(cell.config))
    conf["transcriptome"].update(SIZES[conf["name"]])
    conf["name"] += "_test"
    conf["reads_per_sample"] = reads
    path = str(tmp_path / "config.json")
    with open(path, "w") as fh:
        json.dump(conf, fh)
    return dataclasses.replace(cell, config=conf, config_path=path)


def one_run(cell, tmp_path, fault=None):
    child = None
    if fault:
        child = [sys.executable, "-m", "benchmark.faulty_child", fault]
    h = run.Harness(device="cpu", child=child, work=str(tmp_path / "work"))
    return run.run_cell(cell, 2**31 + 5, 0.0, False, h)


CASES = [("human_se76.sample", None), ("human_se76.sample", "unchanged"),
         ("human_se76.sample", "half"), ("human_se76.sample", "altered"),
         ("human_se76.build", None), ("human_se76.build", "half"),
         ("human_se76.build", "altered")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_caught(name, fault, tmp_path):
    out = one_run(tiny_cell(name, tmp_path, 4000), tmp_path, fault)
    assert out["attempted"] == 1
    assert out["correct"] is (fault is None), out["checks"]


def test_control_is_caught(tmp_path):
    from benchmark import data, refbuild, refquant
    cell = tiny_cell("human_se76.sample", tmp_path, 200000)
    paths = data.ensure_config_data(cell.config, cell.config_path, "cpu")
    index = refbuild.Index.load(paths["index"])
    st = data.load_structure(paths["structure"])
    f = data.make_samples(paths["structure"], cell.config["read_length"],
                          200000, 2.0, 7, 3, 1, str(tmp_path), 1)[0]
    ref = refquant.Reference(index, data.load_alignments(f), "cpu")
    refquant.control_outputs(ref, f + ".control")
    nums = refquant.judge(ref, f + ".control.fpkm",
                          f + ".control.fraglength_effect")
    assert len(st.names) == len(index.names)
    assert any(nums[k] > lim for k, lim in cell.limits.items()), nums
    os.remove(f)
