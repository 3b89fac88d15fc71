"""The convergence loops on the card (``emsar_tpu_torch/model/loop.py``):
each solver's loop replayed from a CUDA graph gives the bits of the plain
host-synced loop and of the parent's loop on the card (theta, logL,
blocks), counts the same kernel launches, and a block that cannot be
captured raises.  The f64 polish on the card (``solver.polish_device``)
runs the host's C++ polish's cycles to its answer, and a sample's peak
of allocated memory stays as with the host's polish.  These need an
NVIDIA GPU with nvcc and skip elsewhere; the file imports neither JAX nor
``emsar_tpu``:

    python -m pytest --noconftest -m cuda tests/test_torch_loop_cuda.py
"""

import numpy as np
import pytest
import torch

from emsar_tpu_torch.config import QuantConfig
from emsar_tpu_torch.model import loop, quantify, solver
from emsar_tpu_torch.utils import timing
from torch_loop_cases import (CASES, LOOPS, POLISH_CAPS, POLISH_CASES, Case,
                              check_polish, gene_family_problem, polish_case,
                              same_bits)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the loop captures CUDA graphs")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", LOOPS)
def test_graph_loop_gives_the_plain_bits(cuda, monkeypatch, name, case):
    """For CHECK_EVERY 1, 5 and 16 the replayed loop equals the plain loop
    and the parent's loop bit for bit; the stop lands between two reads
    of the flag, so masked blocks ran after it."""
    c = Case(name, case, cuda)
    parent = c.port(parent=True)
    plain = c.port(plain=True)
    same_bits(plain, parent)
    n = parent[2]
    for k in (1, 5, 16):
        monkeypatch.setattr(loop, "CHECK_EVERY", k)
        same_bits(c.port(), parent)
        assert loop.LAST.graph and loop.LAST.capture_s > 0
        assert loop.LAST.blocks_run == 1 + k * -(-(n - 1) // k)


@pytest.mark.parametrize("name", ["csr", "kernel", "sharded"])
def test_graph_loop_counts_the_plain_launches(cuda, monkeypatch, name):
    """With a read every block, the replayed loop's launch counters equal
    the plain loop's; with reads every 5 or 16 blocks they grow by the
    same launches for each block run after the stop (the loops whose
    blocks launch the port's kernels: torch.bmm's launch none)."""
    c = Case(name, "stop", cuda)

    def launches(plain=False):
        for mod, attr in loop.COUNTERS:
            monkeypatch.setattr(mod, attr, 0)
        c.port(plain=plain)
        torch.cuda.synchronize()
        return [getattr(mod, attr) for mod, attr in loop.COUNTERS]

    want = launches(plain=True)
    n = loop.LAST.blocks_run
    monkeypatch.setattr(loop, "CHECK_EVERY", 1)
    assert launches() == want and sum(want) > 0
    extra = {}
    for k in (5, 16):
        monkeypatch.setattr(loop, "CHECK_EVERY", k)
        got = launches()
        extra[k] = [g - w for g, w in zip(got, want)], loop.LAST.blocks_run - n
    (d5, b5), (d16, b16) = extra[5], extra[16]
    assert b5 > 0 and b16 > 0 and sum(d16) > 0
    assert [x * b16 for x in d5] == [x * b5 for x in d16]


def test_a_block_that_cannot_be_captured_raises(cuda):
    """A host read inside the block is refused under capture: the loop
    raises instead of running the blocks eagerly, and the card stays
    usable."""
    active = torch.ones(2, dtype=torch.bool, device=cuda)
    x = torch.zeros(2, device=cuda)

    def block():
        x.add_(1.0)
        if float(x.sum()) > 100:  # a host sync: not capturable
            active.zero_()

    with pytest.raises(RuntimeError):
        loop.while_loop(block, active)
    assert float(torch.ones(3, device=cuda).sum()) == 3.0


@pytest.mark.parametrize("max_cycles", POLISH_CAPS)
@pytest.mark.parametrize("case", POLISH_CASES)
def test_device_polish_matches_host_on_the_card(cuda, case, max_cycles):
    """The polish on the card (clusters, a cycle a replayed block) against
    the C++ polish on the host from the same start."""
    problem, theta = polish_case(case, cuda)
    cycles = check_polish(problem, theta, max_cycles, cuda)
    assert loop.LAST.graph is (cycles > 1)


def test_device_polish_keeps_the_samples_peak(cuda):
    """The smoke's transcriptome (``chip_smoke.py``: 2000 genes, seed
    1234, l50) with Poisson read counts of 0.05 a unit of EUMA, sparse
    enough that the dense batches stop on a NaN gain after a few blocks
    and the polish runs to its cap (as in the sample cell; on the CPU 4
    blocks, 200 cycles), run as ``quantify_sample`` runs a sample: the
    default solve's dense batches, the polish, the restart rounds.  With
    the polish on the card the peak of allocated memory is no higher than
    with the host's polish, and the polish leaves nothing allocated (its
    tile plan is not cached); its span names the card and the graph."""
    problem, graph, modules, eumaps, rc = gene_family_problem(
        2000, 1234, 50, reads_per_euma=0.05)
    cfg = QuantConfig(verbose=0)

    def sample(device):
        solver.clear_plans()
        torch.cuda.synchronize(cuda)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cuda)
        fpkm, _, part = quantify._solve_auto(graph, modules, eumaps, rc,
                                             problem, cfg, np.float64, cuda)
        assert part.batches and not len(part.csr_sids)
        torch.cuda.synchronize(cuda)
        before = torch.cuda.memory_allocated(cuda)
        fpkm = quantify._polish(problem, fpkm, cfg, device=device)
        torch.cuda.synchronize(cuda)
        kept = torch.cuda.memory_allocated(cuda) - before
        quantify._make_rounds(problem, fpkm, cfg, np.float64, cuda,
                              part=part, graph=graph, modules=modules,
                              eumaps=eumaps, read_count=rc)
        torch.cuda.synchronize(cuda)
        return torch.cuda.max_memory_allocated(cuda), kept

    host_peak, _ = sample(None)
    timing.reset_phases()
    card_peak, kept = sample(cuda)
    (s,) = [s for s in timing.spans() if s.name == "solve: polish"]
    timing.reset_phases()
    assert kept == 0
    assert card_peak <= host_peak
    assert s.attrs["device"] == str(cuda) and s.attrs["graph"]
    assert s.attrs["cycles"] > 1 and s.attrs["capture_s"] > 0
