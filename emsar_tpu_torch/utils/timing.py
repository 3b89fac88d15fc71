"""Structured phase timers.

The reference logs wall-clock progress by shelling out to ``date`` after
each phase (e.g. src/emsar_main.c:303,378,403); here phases are proper
timers that also feed the benchmark harness.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, Tuple

_PHASES: List[Tuple[str, float]] = []


@contextlib.contextmanager
def phase(name: str, verbose: int = 1):
    t0 = time.perf_counter()
    if verbose > 0:
        print(f"[emsar] {name}...", file=sys.stderr, flush=True)
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _PHASES.append((name, dt))
        if verbose > 0:
            print(f"[emsar] {name}: {dt:.3f}s", file=sys.stderr, flush=True)


def phase_times() -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, dt in _PHASES:
        out[name] = out.get(name, 0.0) + dt
    return out


def reset_phases() -> None:
    _PHASES.clear()
