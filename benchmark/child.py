"""One invocation of the program, in a process of its own, as a user runs it.

    python -m benchmark.child RECORD TRACE ENTRY [ARG ...]

ENTRY is ``emsar`` (``emsar_tpu_torch.cli.emsar``, what ``emsar-torch``
runs) or ``emsar_build`` (``emsar-build-torch``), called with the ARGs; or
``build_kernels``, which builds every CUDA source of the program and its
host ingest library into the program's own build cache and runs nothing.
RECORD receives a JSON object: the exit code, the CLI's phases with their
start and end, the device's name, ``torch.cuda.max_memory_allocated()``,
the modules of JAX or of the JAX package that the process loaded, and with
TRACE 1 a summary of the ``torch.profiler`` device timeline (the phases
marked in it as ``phase:<name>`` ranges).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

T_ENTER = time.time()  # the process's first line, by the wall clock

BANNED = ("jax", "jaxlib", "flax", "emsar_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name is banned, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _build_kernels() -> int:
    import concurrent.futures
    import glob

    from emsar_tpu_torch.ingest import native
    from emsar_tpu_torch.kernels import _build

    if not native.available():
        raise RuntimeError("the native ingest library did not build")
    if os.environ.get("EMSAR_TORCH_DEVICE", "cuda").startswith("cuda"):
        sources = sorted(os.path.basename(p) for p in
                         glob.glob(os.path.join(_build.CSRC_DIR, "*.cu")))
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
            for f in [ex.submit(_build.load, s) for s in sources]:
                f.result()
    return 0


def _record_phases(trace: bool) -> list:
    """Wrap the program's phase timer (before its modules bind it) so that
    each phase's start and end are kept, and, traced, marked in the
    profiler's timeline."""
    import emsar_tpu_torch.utils.timing as timing

    spans: list = []
    inner = timing.phase

    @contextlib.contextmanager
    def phase(name, verbose=1):
        t0 = time.perf_counter()
        mark = contextlib.nullcontext()
        if trace:
            import torch
            mark = torch.profiler.record_function("phase:" + name)
        try:
            with mark, inner(name, verbose):
                yield
        finally:
            spans.append([name, t0, time.perf_counter()])

    timing.phase = phase
    return spans


def _timeline(prof) -> dict:
    """Device busy time (the union of the intervals in which a kernel, copy
    or fill ran), device time by operation name, and idle time by the
    innermost phase it fell in."""
    from torch.autograd import DeviceType

    ops, phases, lo, hi = [], [], None, None
    for e in prof.profiler.kineto_results.events():
        a, b, name = e.start_ns() / 1e9, e.end_ns() / 1e9, e.name()
        lo = a if lo is None else min(lo, a)
        hi = b if hi is None else max(hi, b)
        if name.startswith("phase:"):
            if e.device_type() == DeviceType.CPU:
                phases.append((a, b, name[len("phase:"):]))
        elif e.device_type() == DeviceType.CUDA and \
                not e.is_user_annotation():
            ops.append((a, b, name))
    by_name: dict = {}
    for a, b, n in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ops.sort()
    busy, gaps, end = 0.0, [], lo
    for a, b, _ in ops:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if ops and hi > end:
        gaps.append((end, hi))
    idle: dict = {}
    edges = sorted({t for p in phases for t in p[:2]})
    for a, b in gaps:
        # cut the gap at every phase boundary inside it; each piece goes to
        # the innermost phase that holds it
        cuts = [a] + [t for t in edges if a < t < b] + [b]
        for x, y in zip(cuts, cuts[1:]):
            mid = (x + y) / 2
            inside = [p for p in phases if p[0] <= mid <= p[1]]
            label = max(inside)[2] if inside else "unphased"
            idle[label] = idle.get(label, 0.0) + (y - x)
    return {"busy_s": busy, "ops": len(ops), "by_name": by_name,
            "idle_by_phase": idle, "traced_s": hi - lo if ops else 0.0}


def main(argv) -> int:
    record, trace, entry, args = argv[0], argv[1] == "1", argv[2], argv[3:]
    out = {"entry": entry, "rc": None}
    if entry == "build_kernels":
        out["rc"] = _build_kernels()
    else:
        spans = _record_phases(trace)
        import importlib

        import torch
        cli = importlib.import_module(f"emsar_tpu_torch.cli.{entry}")
        out["imported"] = time.time()
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        out["enter"], out["main_start"] = T_ENTER, time.time()
        try:
            out["rc"] = cli.main(args)
        except SystemExit as e:  # the CLI's die()
            out["rc"] = e.code if isinstance(e.code, int) else 1
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            out["main_end"] = time.time()
            if prof is not None:
                prof.__exit__(None, None, None)
        out["phases"] = [[n, a - t0, b - t0] for n, a, b in spans]
        if torch.cuda.is_initialized():
            out["device"] = torch.cuda.get_device_name()
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
        if prof is not None:
            out["trace"] = _timeline(prof)
        # what the process spent after the CLI returned: the trace
        out["after_s"] = time.perf_counter() - t1
    out["banned"] = banned_modules()
    with open(record, "w") as fh:
        json.dump(out, fh)
    return out["rc"] if isinstance(out["rc"], int) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
