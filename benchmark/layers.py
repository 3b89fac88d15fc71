"""What the per-layer metric readers share: the CLI's phases of one
invocation (``emsar_tpu_torch.utils.timing`` spans, with the start and end
``benchmark/child.py`` keeps), their self times, and the mean over a run's
invocations."""

from __future__ import annotations

from typing import Callable, List, Optional

# Published peak of one NVIDIA H100 SXM (NVIDIA's data sheet): HBM3
# bandwidth, bytes a second, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12


def self_times(inv) -> List[tuple]:
    """[(name, seconds less the phases nested in it, top level?)]."""
    spans = inv.record.get("phases", [])

    def inside(a, b):  # a within b
        return a is not b and b[1] <= a[1] and a[2] <= b[2]
    depth = [sum(inside(s, o) for o in spans) for s in spans]
    out = []
    for s, d in zip(spans, depth):
        nested = sum(o[2] - o[1] for o, od in zip(spans, depth)
                     if od == d + 1 and inside(o, s))
        out.append((s[0], s[2] - s[1] - nested, d == 0))
    return out


def phase_s(inv, match: Callable[[str], bool]) -> float:
    return sum(t for n, t, _ in self_times(inv) if match(n))


def unphased_s(inv) -> float:
    """The invocation's wall time outside every phase: process start,
    imports, device start-up, whatever the CLI does between phases, exit."""
    return inv.wall_s - sum(t for _, t, _ in self_times(inv))


def idle_pct(inv) -> Optional[float]:
    tr = inv.record.get("trace")
    if not tr or tr.get("busy_s", 0.0) <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / inv.wall_s)


def mean(run, fn) -> Optional[float]:
    """The mean of ``fn`` over the run's completed invocations (None where
    it reads nothing)."""
    vals = [fn(i) for i in run.invocations if i.ok]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
