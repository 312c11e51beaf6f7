"""Device time from a ``torch.profiler`` trace: the union of the intervals
in which an operation ran on the device, the operations that took most
time, and the idle gaps by what the host was doing (the innermost of the
benchmark's own spans, ``pb:<name>``, open at the gap's start).

A ``Spans`` object is the stage timer the program accepts
(``SLAMSystem.timer``, ``MappingBackend.timer``): it sums each stage's
wall time and, while a trace runs, marks the stage in it."""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

__all__ = ["Spans", "Profile", "union_seconds", "idle_gaps", "reduce"]


class Spans:
    """Per-stage wall seconds and call counts; each stage is also a
    ``record_function`` range named ``pb:<stage>``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        from torch.profiler import record_function
        t0 = time.perf_counter()
        try:
            with record_function("pb:" + stage):
                yield
        finally:
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def idle_gaps(intervals, lo, hi):
    """The gaps in [lo, hi] that no interval covers, as (start, end)."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


def _label(spans, t):
    """The innermost span (start, end, name) open at ``t``."""
    best = None
    i = bisect.bisect_right([s[0] for s in spans], t)
    for s, e, name in spans[:i]:
        if s <= t < e and (best is None or s >= best[0]):
            best = (s, e, name)
    return best[2] if best else "outside the benchmark's spans"


def reduce(events, window: Tuple[float, float], top: int = 10) -> dict:
    """events: (kind, name, start s, end s) with kind "device" or "span";
    window: the traced (start, end). Returns busy_s, window_s, the top
    device operations by summed seconds and the idle seconds summed by
    the host span open at each gap's start."""
    lo, hi = window
    dev = [(max(s, lo), min(e, hi)) for k, _, s, e in events
           if k == "device" and e > lo and s < hi]
    by_name = defaultdict(float)
    for k, name, s, e in events:
        if k == "device":
            by_name[name] += e - s
    spans = sorted((s, e, n) for k, n, s, e in events if k == "span")
    idle = defaultdict(float)
    for s, e in idle_gaps(dev, lo, hi):
        idle[_label(spans, s)] += e - s
    return {
        "busy_s": union_seconds(dev), "window_s": hi - lo,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:top]}


def _annotation(e) -> bool:
    """Whether a profiler event is an annotated range, not an operation
    (by the event's own flag where this torch has it, else by name)."""
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    return e.name().startswith(("pb:", "ProfilerStep", "Optimizer."))


class Profile:
    """``torch.profiler`` (CPU and CUDA activity) over the block. The
    events are read afterwards (``finish``), outside the measured work:
    ``events`` then holds (kind, name, start s, end s) of every device
    operation and every ``pb:`` span, ``window`` the block's (start, end)
    on the same clock. ``overhead_s`` is the wall time the profiler's own
    start and stop took, which a caller leaves out of its window."""

    def __init__(self):
        self.events: List[tuple] = []
        self.window: Optional[Tuple[float, float]] = None
        self.kinds: Dict[str, int] = defaultdict(int)   # device activities
        self.overhead_s = 0.0
        self._prof = None

    @contextlib.contextmanager
    def __call__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        t0 = time.perf_counter()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        self.overhead_s += time.perf_counter() - t0
        try:
            with record_function("pb:traced_window"):
                yield
            torch.cuda.synchronize()
        finally:
            t0 = time.perf_counter()
            prof.__exit__(None, None, None)
            self.overhead_s += time.perf_counter() - t0
            self._prof = prof

    def finish(self):
        """Read the trace's events (once the measured work is over)."""
        import torch
        if self._prof is None:
            return self
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        # names of the host's annotated ranges (``record_function``): the
        # device side repeats them as spans that are no operation
        annotated = {e.name() for e in events
                     if e.device_type() != torch.autograd.DeviceType.CUDA
                     and _annotation(e)}
        for e in events:
            name = e.name()
            s = e.start_ns() * 1e-9
            end = s + e.duration_ns() * 1e-9
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if _annotation(e) or name in annotated:
                    self.kinds["annotation"] += 1
                else:
                    self.kinds["operation"] += 1
                    self.events.append(("device", name, s, end))
            elif name.startswith("pb:"):
                if name == "pb:traced_window":
                    self.window = (s, end)
                else:
                    self.events.append(("span", name[3:], s, end))
        return self
