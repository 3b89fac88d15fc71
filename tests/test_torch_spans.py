"""The port's span store (``emsar_tpu_torch/utils/timing.py``) and the
spans and counters of the quantifier and the builder, on the CPU.

* The store: each span's parent, thread, attributes and ``time.time_ns()``
  stamps; ``phase_times()`` and ``reset_phases()`` as before; the end line
  with its attributes; under ``torch.profiler`` each span a ``phase:``
  range on the profiler's clock.
* The benchmark harness: with ``benchmark/child.py``'s phase wrapper
  installed, nested spans stay out of its phases, so ``layers.self_times``
  of "EM solve" is its whole duration.
* The stop reason of every convergence loop (``model/loop.py::finish``)
  on ``tests/torch_loop_cases.py``'s three stops, and the host polish's
  cycles and stop.
* The CLIs: the "solve:" spans nest under "EM solve", "device start-up"
  and "writing outputs" are phases; a child process of the benchmark
  harness, its log parsed by ``benchmark/spans.py``: every new reader
  reads a number."""

import json
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from benchmark import child, layers, run
from benchmark import spans as bspans
from emsar_tpu_torch.cli import emsar as torch_cli
from emsar_tpu_torch.cli import emsar_build as torch_build_cli
from emsar_tpu_torch.config import QuantConfig
from emsar_tpu_torch.model import loop, quantify, solver
from emsar_tpu_torch.utils import timing
from tests.test_torch_cli import _make_fixture
from tests.util import write_fasta
from torch_loop_cases import CASES, LOOPS, Case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUANT_METRICS = ["quant.imports_s", "quant.device_start_s", "quant.write_s",
                 "quant.solve_host_s", "quant.solve_dense_s",
                 "quant.solve_polish_s", "quant.polish_cycles",
                 "quant.dense_blocks", "quant.nan_stops"]
BUILD_METRICS = ["build.imports_s", "build.device_start_s"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("EMSAR_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return _make_fixture(tmp_path_factory.mktemp("spans"))


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_store_keeps_parent_thread_attributes_and_stamps():
    timing.reset_phases()
    t0 = time.time_ns()
    with timing.phase("outer", verbose=0):
        with timing.span("inner", verbose=0):
            timing.note(blocks=3, stop="nan")
        timing.note(sample=0)

        def worker():
            with timing.span("elsewhere", verbose=0):
                timing.note(where="thread")
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    t1 = time.time_ns()
    got = {s.name: s for s in timing.spans()}
    outer, inner, other = got["outer"], got["inner"], got["elsewhere"]
    assert [s.name for s in timing.spans()] == ["inner", "elsewhere",
                                                "outer"]
    assert inner.parent is outer and outer.parent is None
    assert other.parent is None  # a thread's spans nest in its own only
    assert inner.thread == outer.thread == threading.get_ident()
    assert other.thread != outer.thread
    assert inner.attrs == {"blocks": 3, "stop": "nan"}
    assert outer.attrs == {"sample": 0}
    assert other.attrs == {"where": "thread"}
    assert t0 <= outer.start_ns <= inner.start_ns <= inner.end_ns \
        <= other.start_ns <= other.end_ns <= outer.end_ns <= t1
    assert outer.phase and not inner.phase and not other.phase
    # phase_times() sums the phases alone, as before the spans
    assert list(timing.phase_times()) == ["outer"]
    assert timing.phase_times()["outer"] == outer.seconds
    timing.note(ignored=True)  # no span open: nothing
    timing.reset_phases()
    assert timing.spans() == [] and timing.phase_times() == {}


def test_end_line_carries_attributes_and_parses(capsys):
    timing.reset_phases()
    with timing.phase("EM solve", verbose=1):
        with timing.span("solve: polish", verbose=1):
            timing.note(cycles=200, stop="cap")
        with timing.span("solve: dense batch", verbose=1):
            timing.note(shape="8x32x8", capture_s=0.0125, graph=False)
    err = capsys.readouterr().err.splitlines()
    assert err[0] == "[emsar] EM solve..."
    assert err[1] == "[emsar] solve: polish..."
    assert err[2].startswith("[emsar] solve: polish: ")
    assert err[2].endswith("s cycles=200 stop=cap")
    assert err[4].endswith("s shape=8x32x8 capture_s=0.0125 graph=False")
    parsed = [bspans.LINE.search(ln).groups()[:2] for ln in err
              if bspans.LINE.search(ln)]
    assert [n for n, _ in parsed] == ["solve: polish", "solve: dense batch",
                                      "EM solve"]
    ends = {s.name: s for s in timing.spans()}
    for name, sec in parsed:
        assert float(sec) == pytest.approx(ends[name].seconds, abs=5e-4)
    timing.reset_phases()


def test_spans_are_profiler_ranges_on_the_same_clock():
    from torch.profiler import ProfilerActivity, profile

    timing.reset_phases()
    with timing.phase("outside", verbose=0):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.phase("top", verbose=0):
            with timing.span("nested", verbose=0):
                time.sleep(0.005)
    ranges = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("phase:")}
    assert set(ranges) == {"phase:top", "phase:nested"}
    for s in timing.spans():
        if s.name == "outside":
            continue
        a, b = ranges["phase:" + s.name]
        assert abs(a - s.start_ns) < 2e6 and abs(b - s.end_ns) < 2e6
    timing.reset_phases()


def test_harness_phases_leave_nested_spans_out(monkeypatch):
    """``child._record_phases`` wraps ``timing.phase``; a span nested in a
    phase reaches the store but not the harness's list, so the self time
    of "EM solve" stays its whole duration."""
    monkeypatch.setattr(timing, "phase", timing.phase)  # restored after
    recorded = child._record_phases(False)
    timing.reset_phases()
    with timing.phase("EM solve", verbose=0):
        with timing.span("solve: problem", verbose=0):
            time.sleep(0.002)
        with timing.span("solve: polish", verbose=0):
            time.sleep(0.002)
    assert [r[0] for r in recorded] == ["EM solve"]
    inv = types.SimpleNamespace(record={"phases": recorded})
    (name, self_s, top), = layers.self_times(inv)
    assert name == "EM solve" and top
    assert self_s == recorded[0][2] - recorded[0][1]
    assert [s.name for s in timing.spans()] == ["solve: problem",
                                                "solve: polish", "EM solve"]
    timing.reset_phases()


STOPS = {"stop": "converged", "nan": "nan", "cap": "cap"}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", LOOPS)
def test_loop_stop_reason(name, case):
    """Each loop's stop reason, from its last active gain and block
    count, on the graph loop (CHECK_EVERY blocks a read) and the plain
    one; "nan" is ``_nan_module``'s zero-read segment whose intensity
    collapses, or the dense loops' own zero-read segments."""
    c = Case(name, case)
    for plain in (False, True):
        c.port(plain=plain)
        assert loop.LAST.stop == STOPS[case], (plain, loop.LAST)


@pytest.mark.parametrize("blocks", [1, 6])
def test_loop_stats_say_graph_only_after_a_capture(blocks):
    """A loop that stops in its first (warm-up) block captures nothing:
    ``graph`` false, ``capture_s`` 0, as the dense batch's span reports."""
    active = torch.ones((), dtype=torch.bool)
    left = [blocks]

    def block():
        left[0] -= 1
        if left[0] <= 0:
            active.fill_(False)

    graph = types.SimpleNamespace(warm_up=lambda b: b(),
                                  capture=lambda b: b(), replay=block)
    stats = loop._run_graph(block, active, 4, graph)
    assert stats.graph is (blocks > 1)
    assert (stats.capture_s > 0) is (blocks > 1)


def test_polish_span_counts_cycles_and_stop():
    problem = solver.SolverProblem(**Case("dense", "stop").fields)
    theta = solver.read_attribution_start(problem)
    cfg = QuantConfig(verbose=0)
    want, cycles = solver.polish_host_f64(problem, theta,
                                          epsilon=max(cfg.epsilon, 1e-9),
                                          max_cycles=200)
    assert 2 < cycles < 200
    timing.reset_phases()
    got = quantify._polish(problem, theta, cfg)
    np.testing.assert_array_equal(got, want)
    quantify._polish(problem, theta, cfg, max_cycles=2)
    first, second = timing.spans()
    assert first.name == second.name == "solve: polish"
    assert first.attrs == {"cycles": cycles, "stop": "eps",
                           "gain": "repaired"}
    assert second.attrs == {"cycles": 2, "stop": "cap", "gain": "repaired"}
    timing.reset_phases()


def _ancestors(s):
    out = []
    while s.parent is not None:
        s = s.parent
        out.append(s.name)
    return out


@pytest.mark.parametrize("flags", [[], ["--solver_pallas"],
                                   ["--solver_mode", "csr"]],
                         ids=["dense_bmm", "dense_kernel", "csr"])
def test_quantifier_spans_nest_under_em_solve(fixture, tmp_path, flags):
    rsh, aln = fixture
    timing.reset_phases()
    assert torch_cli.main(["-q", *flags, "-I", rsh, str(tmp_path), "s",
                           aln]) == 0
    got = _by_name(timing.spans())
    em, = got["EM solve"]
    solve = [s for s in timing.spans() if s.name.startswith("solve: ")]
    assert all(_ancestors(s) == ["EM solve"] for s in solve)
    assert sum(s.seconds for s in solve) <= em.seconds
    if flags[:1] == ["--solver_mode"]:
        assert {s.name for s in solve} == {"solve: problem", "solve: csr"}
        assert got["solve: csr"][0].attrs["stop"] in STOPS.values()
        assert got["solve: csr"][0].attrs["gain"] == "repaired"
    else:
        dense = got["solve: dense batch"]
        assert got["solve: partition"][0].attrs["batches"] == len(dense)
        for s in dense:
            assert set(s.attrs) == {"shape", "blocks", "stop", "graph",
                                    "capture_s", "gain", "route"}
            assert s.attrs["gain"] == "repaired"
            assert s.attrs["route"] == ("kernel" if flags else "bmm")
            assert s.attrs["blocks"] >= 1
            assert s.attrs["stop"] in STOPS.values()
        assert got["solve: polish"][0].attrs["stop"] in ("eps", "cap")
        assert got["solve: polish"][0].attrs["gain"] == "repaired"
        assert "solve: loglik" in got
    ws, = got["writing outputs"]
    assert ws.phase and ws.attrs == {"sample": 0} and ws.parent is None
    ds, = got["device start-up"]
    assert ds.phase and ds.attrs == {"device": "cpu"}
    timing.reset_phases()


def test_batched_spans_nest_under_the_batched_solve(fixture, tmp_path):
    rsh, aln = fixture
    lines = open(aln).readlines()
    half = str(tmp_path / "half.bowtieout")
    with open(half, "w") as fh:
        fh.writelines(lines[: len(lines) // 2])
    lst = str(tmp_path / "samples.list")
    with open(lst, "w") as fh:
        fh.write(aln + "\n" + half + "\n")
    timing.reset_phases()
    assert torch_cli.main(["-q", "-M", "--batch_samples", "-I", rsh,
                           str(tmp_path / "out"), "s", lst]) == 0
    got = _by_name(timing.spans())
    inputs, = got["solve: batched inputs"]
    sharded, = got["solve: sharded loop"]
    for s in (inputs, sharded):
        assert _ancestors(s) == ["batched solve over 2 samples"]
    assert inputs.attrs == {"samples": 2}
    assert sharded.attrs["samples"] == 2 and sharded.attrs["blocks"] >= 0
    assert sharded.attrs["stop"] in STOPS.values()
    assert sharded.attrs["gain"] == "repaired" and sharded.attrs["rows"] == 2
    assert {"edges", "segments", "transcripts", "operand_rows",
            "cluster_launches"} <= set(sharded.attrs)
    assert [s.attrs for s in got["writing outputs"]] == [{"sample": 0},
                                                         {"sample": 1}]
    timing.reset_phases()


def test_builder_starts_the_device_only_where_it_builds_on_it(tmp_path):
    rng = np.random.default_rng(3)
    seqs = [rng.choice(list(b"ACGT"), 120).astype(np.uint8).tobytes()
            for _ in range(5)]
    fa = str(tmp_path / "t.fa")
    write_fasta(fa, [f"t{i}" for i in range(5)], seqs)
    timing.reset_phases()
    assert torch_build_cli.main(["-q", fa, "20", str(tmp_path / "d"),
                                 "idx"]) == 0
    ds, = _by_name(timing.spans())["device start-up"]
    assert ds.phase and ds.attrs == {"device": "cpu"}
    timing.reset_phases()
    assert torch_build_cli.main(["-q", "-T", fa, "20", str(tmp_path / "h"),
                                 "idx"]) == 0
    assert "device start-up" not in timing.phase_times()
    timing.reset_phases()


def _child_run(tmp_path, entry, args):
    """One invocation as the benchmark harness runs it (a process of
    ``benchmark/child.py``, its output to a log), as a ``run.Run``."""
    rec, log = str(tmp_path / "record.json"), str(tmp_path / "log.txt")
    env = dict(os.environ, PYTHONPATH=REPO, EMSAR_TORCH_DEVICE="cpu")
    with open(log, "wb") as fh:
        subprocess.run([sys.executable, "-m", "benchmark.child", rec, "0",
                        entry, *args], cwd=REPO, env=env, stdout=fh,
                       stderr=subprocess.STDOUT, check=True, timeout=600)
    with open(rec) as fh:
        record = json.load(fh)
    record["log"] = log
    inv = run.Invocation(wall_s=record["main_end"] - record["enter"],
                         reads=0, record=record, ok=record["rc"] == 0,
                         why="", out_dir=str(tmp_path), inputs=0)
    return run.Run(cell=None, setup_s=0.0, window_s=0.0, invocations=[inv],
                   facts={})


def test_harness_reads_every_new_quant_metric(fixture, tmp_path):
    rsh, aln = fixture
    r = _child_run(tmp_path, "emsar", ["-I", rsh, str(tmp_path / "out"),
                                       "s", aln])
    rec = r.invocations[0].record
    names = [p[0] for p in rec["phases"]]
    assert "device start-up" in names and "writing outputs" in names
    assert not any(n.startswith("solve: ") or n == "imports"
                   for n in names)
    for m in QUANT_METRICS:
        v = run.metric_reader(m).read(r)
        assert isinstance(v, (int, float)) and v >= 0, (m, v)
    assert run.metric_reader("quant.polish_cycles").read(r) >= 1
    assert run.metric_reader("quant.dense_blocks").read(r) >= 1
    # the "solve:" end lines fall inside "EM solve"'s, and sum below it
    got = bspans.spans(r.invocations[0])
    em = [k for k, (n, _, _) in enumerate(got) if n == "EM solve"]
    assert len(em) == 1
    inner = [s for n, s, _ in got[:em[0]] if n.startswith("solve: ")]
    assert inner and not any(n.startswith("solve: ")
                             for n, _, _ in got[em[0]:])
    assert sum(inner) <= got[em[0]][1] + 1e-3 * len(inner)


def test_harness_reads_every_new_build_metric(tmp_path):
    rng = np.random.default_rng(4)
    seqs = [rng.choice(list(b"ACGT"), 150).astype(np.uint8).tobytes()
            for _ in range(6)]
    fa = str(tmp_path / "t.fa")
    write_fasta(fa, [f"t{i}" for i in range(6)], seqs)
    r = _child_run(tmp_path, "emsar_build", [fa, "20", str(tmp_path / "o"),
                                             "idx"])
    assert "device start-up" in [p[0] for p in
                                 r.invocations[0].record["phases"]]
    for m in BUILD_METRICS:
        v = run.metric_reader(m).read(r)
        assert isinstance(v, float) and v >= 0, (m, v)


def test_readers_read_nothing_from_a_program_without_spans(tmp_path):
    """A log without span end lines (a checkout older than the spans)."""
    log = tmp_path / "log.txt"
    log.write_text("[emsar] EM solve...\n[emsar] EM solve: 1.234s\n")
    inv = run.Invocation(wall_s=2.0, reads=0, record={"log": str(log)},
                         ok=True, why="", out_dir=str(tmp_path), inputs=0)
    r = run.Run(cell=None, setup_s=0.0, window_s=0.0, invocations=[inv],
                facts={})
    for m in QUANT_METRICS + BUILD_METRICS:
        assert run.metric_reader(m).read(r) is None, m
