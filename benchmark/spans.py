"""What the readers of the program's spans share: the span end lines that
``emsar_tpu_torch.utils.timing`` prints at verbose > 0,

    [emsar] solve: polish: 4.812s cycles=200 stop=cap

parsed from an invocation's log (the CLI's standard output and error), and
sums of their seconds and attributes per invocation.  A program that prints
no such line (a checkout older than the spans) reads None."""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple

from benchmark import layers

LINE = re.compile(r"\[emsar\] (.+?): (\d+\.\d+)s((?: [A-Za-z_]\w*=\S*)*)$")


def spans(inv) -> List[Tuple[str, float, dict]]:
    """[(name, seconds, attributes)] of the invocation's span end lines, in
    the order they closed; attribute values are strings."""
    out = []
    with open(inv.record["log"], encoding="utf-8", errors="replace") as fh:
        for line in fh:
            m = LINE.search(line.rstrip("\n"))
            if m:
                attrs = dict(kv.split("=", 1) for kv in m.group(3).split())
                out.append((m.group(1), float(m.group(2)), attrs))
    return out


def seconds(inv, match: Callable[[str], bool]) -> Optional[float]:
    """The seconds of the spans whose name ``match``es, summed (None: no
    such span)."""
    vals = [s for n, s, _ in spans(inv) if match(n)]
    return sum(vals) if vals else None


def attr_sum(inv, name: str, key: str) -> Optional[float]:
    """Attribute ``key`` of the spans called ``name``, summed (None: no
    such span)."""
    vals = [float(a[key]) for n, _, a in spans(inv) if n == name and key in a]
    return sum(vals) if vals else None


def mean(run, fn) -> Optional[float]:
    """The mean of ``fn`` over the run's completed invocations (None where
    it reads nothing)."""
    return layers.mean(run, fn)
