"""The convergence loops on the card (``emsar_tpu_torch/model/loop.py``):
each solver's loop replayed from a CUDA graph gives the bits of the plain
host-synced loop and of the parent's loop on the card (theta, logL,
blocks), counts the same kernel launches, and a block that cannot be
captured raises.  These need an NVIDIA GPU with nvcc and skip elsewhere;
the file imports neither JAX nor ``emsar_tpu``:

    python -m pytest --noconftest -m cuda tests/test_torch_loop_cuda.py
"""

import pytest
import torch

from emsar_tpu_torch.model import loop
from torch_loop_cases import CASES, LOOPS, Case, same_bits

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
