"""Convergence loops on the device: the port's ``lax.while_loop`` for the EM
solvers (``model/solver.py::em_solve``, ``model/dense.py::_solve_loop``,
``parallel/mesh.py::solve_sharded``).

A solve's state is a fixed set of tensors, allocated once: theta, the
previous intensities (and whatever else the solve carries), an ``active``
mask (``[R]`` where rows stop on their own, 0-d where the whole batch
stops together) and a block counter ``it`` (int64, 0-d).  A block is a
function of that state that updates it in place:

    new, s_new, gain <- block_iters SQUAREM cycles from theta
    theta <- where(active, new, theta); s_prev likewise     (``advance``)
    it += any(active)                                       (``advance``)
    last <- where(active, gain, last)                       (``keep_gain``)
    active &= (gain >= epsilon) & cap(it)                   (the solve's)

so a block after a row stopped leaves that row as it was, as the vmapped
``while_loop`` does, and ``it`` counts the blocks in which something was
still active: the JAX loop's block count, whatever ran after the stop.
A NaN gain fails ``gain >= epsilon`` as a converged one does; ``last``
(the loop's shape of ``active``: each row's gain of its last active
block, one element-wise op a block) tells them apart.  ``finish`` reads
whether it holds a NaN on the host together with ``it``, in the one
transfer that read the block count, and puts the stop reason in
``LAST.stop``.

``while_loop`` runs the first block eagerly (JAX calls ``block(state)``
before its ``while_loop``), then more blocks until nothing is active,
reading the stop flag (``active.any()``) on the host once per
``CHECK_EVERY`` blocks.  On a CUDA device the first block runs on a side
stream and is the warm-up that capture needs (every kernel module loaded,
the allocator sized); one block is then captured into a
``torch.cuda.CUDAGraph`` with a private memory pool on that stream, and
replayed.  Up to ``CHECK_EVERY - 1`` replays run after the stop, as no-ops
on the masked state (torch 2.11 has no conditional graph nodes to skip
them on the device).  A capture or replay that fails raises; nothing
retries eagerly.  On the CPU the same loop runs the block eagerly
``CHECK_EVERY`` times between reads, so the CPU runs the same masking and
the same stop as the card.  ``plain=True`` is the host-synced loop (the
flag read after every block, no capture): the plain version that tests
and ``chip_smoke.py`` hold the graph against, and the loop of a mesh of
several processes, whose collectives are not captured.

The kernels' launch counters (``COUNTERS``) are Python integers that tick
when a wrapper launches, so under capture they tick once for the recorded
block.  ``while_loop`` takes their increase over the capture back and adds
it once per replay: they go on counting the launches that reached the
card.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Iterable, Tuple

import torch

from ..kernels import csr_cluster, csr_cycle, segment_sum, squarem

# Blocks between two reads of the stop flag.  A read drains the stream and
# costs the host's round trip; a block run after the stop costs a block's
# device time.  On the smoke fixture's seven loops (H100,
# ``bench/loop_ab.py``) 2, 4 and 8 cost the same within 5%, 1 more, 16
# and 32 12% and 50% more.
CHECK_EVERY = 4
# (wrapper module, name of its launch counter) of every kernel a block runs
COUNTERS = ((segment_sum, "LAUNCHES"), (segment_sum, "EM_LAUNCHES"),
            (squarem, "LAUNCHES"), (csr_cycle, "LAUNCHES"),
            (csr_cycle, "PAIR_GAIN_LAUNCHES"),
            (csr_cycle, "BLOCK_END_LAUNCHES"),
            (csr_cycle, "EXTRAP_LAUNCHES"), (csr_cycle, "SELECT_LAUNCHES"),
            (csr_cluster, "EM_PAIR_LAUNCHES"),
            (csr_cluster, "EXTRAP_GAIN_LAUNCHES"))


@dataclasses.dataclass
class LoopStats:
    """What the last ``while_loop`` did: blocks it ran (the first
    included, no-op blocks after the stop too), host reads of the stop
    flag, whether it replayed a graph, the capture's seconds, and (set by
    ``finish``) why it stopped: ``converged`` (the gain fell below
    epsilon), ``nan`` (a row's last active block's gain was NaN) or
    ``cap`` (the block cap)."""

    blocks_run: int = 0
    reads: int = 0
    graph: bool = False
    capture_s: float = 0.0
    stop: str = ""


LAST = LoopStats()


def advance(active: torch.Tensor, it: torch.Tensor,
            updates: Iterable[Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """For each (state, new) of ``updates``: state <- where(active, new,
    state), ``active`` broadcast over state's trailing axes; then it +=
    any(active).  In place, on the device."""
    for state, new in updates:
        mask = active.reshape(active.shape
                              + (1,) * (state.dim() - active.dim()))
        state.copy_(torch.where(mask, new, state))
    it.add_(active.any())


def keep_gain(last: torch.Tensor, gain: torch.Tensor,
              active: torch.Tensor) -> None:
    """last <- where(active, gain, last), in place (one launch): each
    row's gain of its last active block.  Call before the block updates
    ``active``."""
    torch.where(active, gain, last, out=last)


def finish(it: torch.Tensor, last: torch.Tensor,
           capped: Callable[[int], bool]) -> int:
    """The loop's block count, read in one transfer with whether a row's
    last active gain (``keep_gain``) was NaN; the stop reason goes to
    ``LAST.stop`` (``capped(blocks)``: whether the count reached the
    solve's cap)."""
    blocks, any_nan = torch.stack(
        (it, last.isnan().any().to(it.dtype))).tolist()
    LAST.stop = ("nan" if any_nan else "cap" if capped(blocks)
                 else "converged")
    return blocks


def while_loop(block: Callable[[], None], active: torch.Tensor, *,
               plain: bool = False) -> None:
    """Run ``block`` once, then until no element of ``active`` is set (see
    the module note); what it did goes to ``LAST``.  ``block`` updates the
    loop's state tensors and ``active`` in place and does no host work
    that depends on them."""
    global LAST
    if plain:
        LAST = _run_eager(block, active, 1)
    elif active.device.type == "cuda":
        LAST = _run_graph(block, active, CHECK_EVERY,
                          _CudaGraph(active.device))
    else:
        LAST = _run_eager(block, active, CHECK_EVERY)


def _run_eager(block: Callable[[], None], active: torch.Tensor,
               check_every: int) -> LoopStats:
    stats = LoopStats()
    block()
    stats.blocks_run = 1
    while True:
        stats.reads += 1
        if not bool(active.any()):
            return stats
        for _ in range(check_every):
            block()
        stats.blocks_run += check_every


def _counts() -> list:
    return [getattr(mod, name) for mod, name in COUNTERS]


def _add_counts(deltas: list, times: int = 1) -> None:
    for (mod, name), d in zip(COUNTERS, deltas):
        setattr(mod, name, getattr(mod, name) + d * times)


def _run_graph(block: Callable[[], None], active: torch.Tensor,
               check_every: int, graph) -> LoopStats:
    """The replayed loop over ``graph`` (``_CudaGraph``; tests give a
    stand-in with the same three methods)."""
    stats = LoopStats()
    graph.warm_up(block)
    stats.blocks_run = stats.reads = 1
    if not bool(active.any()):
        return stats
    before = _counts()
    t0 = time.perf_counter()
    graph.capture(block)
    stats.graph, stats.capture_s = True, time.perf_counter() - t0
    per_block = [now - was for now, was in zip(_counts(), before)]
    _add_counts(per_block, -1)  # the capture launched nothing
    while True:
        for _ in range(check_every):
            graph.replay()
        _add_counts(per_block, check_every)
        stats.blocks_run += check_every
        stats.reads += 1
        if not bool(active.any()):
            return stats


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of every loop on ``device``: one, so that the
    caching allocator, which keeps freed blocks per stream, reuses the
    warm-up block's memory from one solve to the next."""
    return torch.cuda.Stream(device)


class _CudaGraph:
    """One block as a CUDA graph: warmed up and captured on a side stream
    (the ``torch.cuda.graphs`` recipe), replayed on the current stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = _side_stream(device)
        self.graph = torch.cuda.CUDAGraph()

    def warm_up(self, block: Callable[[], None]) -> None:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            block()
        current.wait_stream(self.stream)

    def capture(self, block: Callable[[], None]) -> None:
        with torch.cuda.stream(self.stream):
            self.graph.capture_begin()
            try:
                block()
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass  # the capture was already invalidated
                raise
            self.graph.capture_end()

    def replay(self) -> None:
        self.graph.replay()
