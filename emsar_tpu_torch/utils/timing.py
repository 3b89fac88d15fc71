"""The program's span store: structured phase timers.

The reference logs wall-clock progress by shelling out to ``date`` after
each phase (e.g. src/emsar_main.c:303,378,403); here every timed step is a
span, kept in memory with its start and end (``time.time_ns()``, the clock
of the ``torch.profiler`` timeline), its parent (the innermost span open on
the same thread when it opened), its thread and its attributes.

* ``phase(name, verbose)`` is a top-level step of a CLI: ``phase_times()``
  sums the phases by name (the benchmark harness and ``chip_smoke.py`` read
  them).
* ``span(name, verbose)`` is a step nested inside one; ``note(**attrs)``
  sets attributes on the calling thread's innermost open span.
* ``record_imports(end_ns, verbose)`` records, once per process, the span
  from the package's first line (``emsar_tpu_torch.IMPORT_NS``) to
  ``end_ns``.

At ``verbose > 0`` a span prints ``[emsar] name...`` on stderr when it opens
and ``[emsar] name: 1.234s key=value ...`` when it closes.  While a
``torch.profiler`` is recording, each span is also a
``record_function("phase:" + name)`` range on the profiler's timeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import time
from typing import Dict, List, Optional

from .. import IMPORT_NS


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: Optional[int] = None  # None while open
    parent: Optional["Span"] = None
    thread: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)
    phase: bool = False  # opened by phase() (counted by phase_times())

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


_SPANS: List[Span] = []  # closed spans, in the order they closed
_OPEN = threading.local()  # .stack: the calling thread's open spans
_IMPORTS_DONE = False


def _stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def _profiler_mark(name: str):
    """A ``phase:`` range on the profiler's timeline while one records."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function("phase:" + name)


def _end_line(s: Span) -> str:
    attrs = "".join(
        f" {k}={v:.6g}" if isinstance(v, float) else f" {k}={v}"
        for k, v in s.attrs.items())
    return f"[emsar] {s.name}: {s.seconds:.3f}s{attrs}"


@contextlib.contextmanager
def _timed(name: str, verbose: int, is_phase: bool):
    stack = _stack()
    if verbose > 0:
        print(f"[emsar] {name}...", file=sys.stderr, flush=True)
    s = Span(name=name, start_ns=time.time_ns(),
             parent=stack[-1] if stack else None,
             thread=threading.get_ident(), phase=is_phase)
    stack.append(s)
    try:
        with _profiler_mark(name):
            yield s
    finally:
        s.end_ns = time.time_ns()
        stack.pop()
        _SPANS.append(s)
        if verbose > 0:
            print(_end_line(s), file=sys.stderr, flush=True)


def phase(name: str, verbose: int = 1):
    return _timed(name, verbose, True)


def span(name: str, verbose: int = 1):
    return _timed(name, verbose, False)


def note(**attrs) -> None:
    """Set attributes on the calling thread's innermost open span (none
    open: nothing)."""
    stack = _stack()
    if stack:
        stack[-1].attrs.update(attrs)


def record_imports(end_ns: int, verbose: int = 1) -> None:
    """The span "imports", from the package's first line to ``end_ns``
    (where the CLI's module finished loading), recorded by the first call
    in a process only."""
    global _IMPORTS_DONE
    if _IMPORTS_DONE:
        return
    _IMPORTS_DONE = True
    s = Span(name="imports", start_ns=IMPORT_NS, end_ns=end_ns,
             thread=threading.get_ident())
    _SPANS.append(s)
    if verbose > 0:
        print(_end_line(s), file=sys.stderr, flush=True)


def spans() -> List[Span]:
    """The closed spans, in the order they closed."""
    return list(_SPANS)


def phase_times() -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s in spans():
        if s.phase:
            out[s.name] = out.get(s.name, 0.0) + s.seconds
    return out


def reset_phases() -> None:
    _SPANS.clear()
