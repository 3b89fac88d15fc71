"""Timing and roofline bounds of kernels on the card, for ``chip_smoke.py``
and the kernel benchmarks.  Nothing on the solve or build path uses it.

* ``device_ms``: device time per call.  A sleep kernel holds the stream
  while the host enqueues ``n`` calls, so they run back to back on the
  card and CUDA events around them measure the card alone, not the host's
  enqueue rate.  A call that synchronises inside (a plain version that
  sizes an output from data) is timed serially instead.
* ``device_ms_cold``: device time per call with a cold L2 cache: before
  each call a write of twice the card's L2 evicts what the last left
  there, and CUDA events around each call alone time it (the same sleep
  holds the stream while the host enqueues them); the mean of the middle
  80% of the calls' times, so that a rare stall of the host (the sleep
  run out) does not count.  For kernels whose
  inputs fit in the L2 (the H100's is 50 MB), whose warm time would
  count each input's bytes as moved from HBM when they were not.  The
  write leaves the L2 full of dirty lines, which a call that reads many
  bytes writes back to HBM as it evicts them (the solve's own writes
  leave it so too); with ``clean=True`` the flush is a read of the same
  bytes instead, so that a call pays for its own bytes alone.
* ``host_ms``: host time per call, ``perf_counter`` over ``n`` calls with
  no synchronisation (the wrapper's Python, allocation and launch).
* ``bound_ms``: the least time the card could take for the work, the
  larger of bytes over the memory rate and operations over the peak rate
  of their type (NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3; 34 TFLOP/s
  float64 and 67 TFLOP/s float32 outside the tensor cores).
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float64: 34e12, torch.float32: 67e12}
# cycles the sleep kernel spins per millisecond (above the H100's ~2 GHz
# boost clock, so the sleep is at least as long as asked)
_SLEEP_CYCLES_PER_MS = 2.0e6


def host_ms(fn: Callable[[], object], n: int = 200) -> float:
    """Host milliseconds per call of ``fn`` over ``n`` calls, no sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / n


def device_ms(fn: Callable[[], object], n: int = 200,
              host_per_call_ms: float = 0.0) -> float:
    """Device milliseconds per call of ``fn``: CUDA events around ``n``
    calls enqueued back to back behind a sleep long enough for the host to
    enqueue them all (``host_per_call_ms``, measured here when 0)."""
    if host_per_call_ms <= 0.0:
        host_per_call_ms = host_ms(fn, min(n, 20))
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2.0 * n * host_per_call_ms + 1.0)
                          * _SLEEP_CYCLES_PER_MS))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def device_ms_cold(fn: Callable[[], object], n: int = 50,
                   host_per_call_ms: float = 0.0,
                   clean: bool = False) -> float:
    """Device milliseconds per call of ``fn`` from a cold L2: ``n`` times a
    write (``clean``: a read) of twice the L2's bytes, then ``fn`` between
    CUDA events, all enqueued behind one sleep; the mean of the calls'
    times without the tenth slowest and the tenth fastest."""
    dev = torch.cuda.current_device()
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 0) or 50 << 20
    flush = torch.empty(2 * l2 // 4, dtype=torch.int32, device="cuda")
    if host_per_call_ms <= 0.0:
        host_per_call_ms = host_ms(fn, 20)

    flush.zero_()
    evict = flush.sum if clean else flush.zero_

    def step():
        evict()
        fn()
    flush_ms = host_ms(evict, 20)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(int((2.0 * n * (host_per_call_ms + flush_ms + 0.01)
                           + 1.0) * _SLEEP_CYCLES_PER_MS))
    for a, b in events:
        evict()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    del flush
    times = sorted(a.elapsed_time(b) for a, b in events)
    cut = n // 10
    kept = times[cut:n - cut]
    return sum(kept) / len(kept)


def bound_ms(n_bytes: float, n_ops: float, dtype=torch.float64
             ) -> Tuple[float, str]:
    """(least milliseconds, "bytes" or "operations") for work that moves
    ``n_bytes`` and does ``n_ops`` operations of ``dtype``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3 if n_ops else 0.0
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors: torch.Tensor) -> int:
    """Bytes of the tensors, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors)
