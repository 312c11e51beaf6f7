"""Tracing / profiling helpers (port of ``cut3r_slam_tpu/utils/
profiling.py``): the program's one tracer.

A timer is any callable ``timer(stage)`` that returns a context manager
(``StageTimer`` here; the benchmark's ``port_bench.trace.Spans`` too).
One timer at a time is attached to the process (``attach``); the
program's spans (``span``) and counters (``count``) go to it. With
nothing attached both return at once: no allocation, no clock, no torch.
``StageTimer`` also opens a ``torch.profiler.record_function`` range per
span, so under a profiler the spans lie on the trace's own clock.

The program's spans are named ``<layer>.<what>`` (``map.iter``,
``raster.blend``, ``cut3r.decode``, ``train.backward``) and never
synchronize. ``timed`` is the one span that does, for the SLAM system's
and the mapper's ten stages (``SLAMSystem._tm``, ``MappingBackend._tm``:
``filter``, ``frontend``, ``mapping``, ``map_window``...)."""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

__all__ = ["StageTimer", "timed", "attach", "span", "count", "held_counts"]

_NOOP = contextlib.nullcontext()
_timer = None


def attach(timer):
    """Make ``timer`` (or None) the process's timer; returns the one it
    replaces."""
    global _timer
    prev, _timer = _timer, timer
    return prev


def span(name: str):
    """``timer(name)`` of the attached timer; the shared no-op without
    one."""
    t = _timer
    if t is None:
        return _NOOP
    return t(name)


def count(name: str, n: int = 1):
    """Add ``n`` to the attached timer's counter ``name`` (a timer without
    ``count`` keeps none)."""
    t = _timer
    if t is None:
        return
    add = getattr(t, "count", None)
    if add is not None:
        add(name, n)


class _Held:
    """Stands in for the attached timer inside ``held_counts``: spans go
    through to it, counts are kept."""

    def __init__(self, inner):
        self.inner = inner
        self.counts: Dict[str, int] = defaultdict(int)

    def __call__(self, name: str):
        return _NOOP if self.inner is None else self.inner(name)

    def count(self, name: str, n: int = 1):
        self.counts[name] += n


@contextlib.contextmanager
def held_counts():
    """Inside the block ``count`` adds to the dict it yields instead of
    the attached timer's counters; spans still reach the timer. A CUDA
    graph's capture runs no work, so it holds the counts back and each
    replay gives them."""
    global _timer
    held = _Held(_timer)
    _timer = held
    try:
        yield held.counts
    finally:
        _timer = held.inner


class StageTimer:
    """Accumulating per-stage timer: ``with timer('frontend'): ...`` sums
    host seconds and calls by stage, and marks the stage as a
    ``record_function`` range; ``count`` keeps counters. Spans may close
    on other threads (the autograd engine's, the viewer's). The caller
    synchronizes the device where a stage must own its kernels
    (``timed``)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, stage: str):
        from torch.profiler import record_function
        rf = record_function(stage)
        # the clock is read where the profiler's range opens and closes,
        # before record_function's enter and its exit: under a profiler
        # the range holds most of the enter's tens of microseconds
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.totals[stage] += dt
                    self.counts[stage] += 1

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] += n

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 4),
                    "calls": self.counts[k],
                    "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3)}
                for k, v in sorted(self.totals.items(),
                                   key=lambda kv: -kv[1])}

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


@contextlib.contextmanager
def timed(timer: Optional[StageTimer], stage: str, device=None):
    """``timer(stage)`` that synchronizes ``device`` (when it is a CUDA
    device) before the stage closes, so the kernels a stage queued count
    to it; nothing at all without a timer."""
    if timer is None:
        yield
        return
    with timer(stage):
        yield
        if device is not None and device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)
