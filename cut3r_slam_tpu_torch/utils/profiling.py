"""Tracing / profiling helpers (port of ``cut3r_slam_tpu/utils/
profiling.py``): per-stage wall-clock timers with the same JSON export,
and a ``torch.profiler`` trace context for a device timeline."""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional

__all__ = ["StageTimer", "timed", "trace"]


class StageTimer:
    """Accumulating per-stage timer: ``with timer('frontend'): ...``. The
    caller synchronizes the device where a stage must own its kernels
    (``timed``)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

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


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace of the block (CPU and, when present, CUDA
    activity), written to ``logdir`` as a TensorBoard / Chrome trace."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
