"""The program's spans and counters in a cell's run, read from the device
trace: a probe beside the benchmark (no metric of ``BENCHMARK.json``
reads it).

    python3 -m port_bench.span_probe --workload <cell> --seed <n> \
        --seconds <s> --mode trace|cost [--runs <k>] [--out <file>]

``trace``: one traced run of the cell through its own driver with the
program's spans attached for the whole window (``slam_map``: the
driver's ``Spans``, which the SLAM system attaches, given counters;
``train_v4``: a ``Spans`` the probe attaches). Besides what the driver's
``Profile`` keeps, ``LaunchProfile`` keeps the CUDA runtime and driver
calls that launch kernels or wait on the device and the device
operations' correlation ids; ``attribute`` gives each operation's device
time, each launch and each wait to the innermost span open (on any
thread) at the host time of its launch. Prints one JSON line: five
readings of the program's spans and counters (``readings``: device ms
of the mapping backward and kernel launches and host waits per
mapping iteration, the share of gradient renders with a planned pack
gather, launches per training step), the idle seconds and busy seconds
by innermost span, the waits by (span, host operation) and the
counters.

``cost``: the tracer's cost. ``k`` untraced runs of the cell with the
program's ``StageTimer`` attached for the whole window (no profiler, the
stages left unsynchronized) and ``k`` with nothing attached, alternated,
without the check; then the no-op ``span`` / ``count`` on this host in
nanoseconds a call.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import heapq
import json
import sys
import time
from collections import defaultdict
from typing import Dict, List, Tuple

from port_bench.trace import Profile, Spans, idle_gaps

__all__ = ["CountingSpans", "LaunchProfile", "attribute", "readings",
           "LAUNCH", "WAITS"]

# the runtime / driver calls that wait for the device: the synchronizes
# and the synchronous copies
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
         "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")
LAUNCH = "Launch"        # a kernel launch: cudaLaunchKernel, cuLaunchKernel..
OUTSIDE = "outside the benchmark's spans"
# spans that the benchmark's drivers open themselves
DRIVER_SPANS = ("traced_window", "step", "data", OUTSIDE)


class CountingSpans(Spans):
    """The benchmark's ``Spans`` with the program's counters."""

    def __init__(self):
        super().__init__()
        self.counters: Dict[str, int] = defaultdict(int)

    def count(self, name: str, n: int = 1):
        self.counters[name] += n


class LaunchProfile(Profile):
    """``Profile`` that also keeps, from the same trace, ``ops`` (name,
    start, end, correlation id) of every device operation, ``calls``
    (host time, correlation id, name) of every CUDA runtime and driver
    call (kernel launches, copies, sets), ``waits`` (host start, host
    end, name, thread) of every wait on the device, and ``cpu_ops``
    (start, end, thread, name) of the host's operators (to name a wait's
    call site)."""

    def __init__(self):
        super().__init__()
        self.ops: List[tuple] = []
        self.calls: List[tuple] = []
        self.waits: List[tuple] = []
        self.cpu_ops: List[tuple] = []

    def finish(self):
        import torch
        if self._prof is None:
            return self
        events = self._prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            name = e.name()
            s = e.start_ns() * 1e-9
            end = s + e.duration_ns() * 1e-9
            if e.device_type() == cuda:
                self.ops.append((name, s, end, e.correlation_id()))
            elif name.startswith("cu"):        # a runtime or driver call
                self.calls.append((s, e.correlation_id(), name))
                if name in WAITS:
                    self.waits.append((s, end, name, e.start_thread_id()))
            elif not name.startswith("pb:"):
                self.cpu_ops.append((s, end, e.start_thread_id(), name))
        super().finish()
        # the device operations ``Profile`` kept (annotations left out)
        kept = {(n, s) for k, n, s, _ in self.events if k == "device"}
        self.ops = [o for o in self.ops if (o[0], o[1]) in kept]
        return self


def _innermost(spans, times):
    """The innermost span (start, end, name) open at each time (any
    thread: the one that opened last): a sweep over the times in order,
    the open spans in a heap by start. Returns names in ``times``' order."""
    spans = sorted(spans)
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [OUTSIDE] * len(times)
    heap, j = [], 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            s, e, name = spans[j]
            heapq.heappush(heap, (-s, e, name))
            j += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        if heap:
            out[i] = heap[0][2]
    return out


def _within(spans, name, times):
    """Per time, whether a span called ``name`` is open then."""
    iv = sorted((s, e) for s, e, n in spans if n == name)
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [s for s, _ in merged]
    out = []
    for t in times:
        i = bisect.bisect_right(starts, t) - 1
        out.append(i >= 0 and t < merged[i][1])
    return out


def attribute(spans: List[Tuple[float, float, str]], ops, calls, waits,
              window, inside=(), cpu_ops=()) -> dict:
    """Device time, kernel launches and waits by span.

    spans: (start, end, name) on the host clock, any thread; ops: (name,
    start, end, correlation id) of device operations; calls: (host time,
    correlation id, name) of runtime and driver calls, the launches those
    whose name holds ``LAUNCH``; waits: (host start, host end, name,
    thread); window: the traced (start, end). An operation counts at the
    host time of the call that issued it (one whose call is not in the
    trace counts at its own start). Returns ``by_span`` {innermost span: {device_s, launches,
    waits}}; ``inside`` {name: the same, counting everything while a span
    of that name is open}; ``calls`` {name: spans of that name that start
    in the window}; ``wait_sites`` [(span, host operator, waits)];
    ``unlinked`` (operations whose launch was not found)."""
    lo, hi = window
    at = {cid: t for t, cid, _ in calls}
    ops = [o for o in ops if o[2] > lo and o[1] < hi]
    op_t = [at.get(cid, s) for _, s, _, cid in ops]
    lt = [t for t, _, name in calls if LAUNCH in name and lo <= t < hi]
    wt = [w[0] for w in waits if lo <= w[0] < hi]
    rows = (("device_s", op_t, [min(e, hi) - max(s, lo)
                                for _, s, e, _ in ops]),
            ("launches", lt, [1] * len(lt)), ("waits", wt, [1] * len(wt)))
    by_span = defaultdict(lambda: {"device_s": 0.0, "launches": 0,
                                   "waits": 0})
    wait_labels = []
    for key, times, amounts in rows:
        labels = _innermost(spans, times)
        for lab, a in zip(labels, amounts):
            by_span[lab][key] += a
        if key == "waits":
            wait_labels = labels
    into = {}
    for name in inside:
        into[name] = {}
        for key, times, amounts in rows:
            into[name][key] = sum(a for a, w in zip(
                amounts, _within(spans, name, times)) if w)
    sites = defaultdict(int)
    cpu = defaultdict(list)
    for s, e, tid, name in cpu_ops:
        cpu[tid].append((s, e, name))
    by_tid = defaultdict(list)     # (wait's span, wait) by host thread
    for lab, w in zip(wait_labels, [w for w in waits if lo <= w[0] < hi]):
        by_tid[w[3]].append((lab, w))
    for tid, ws in by_tid.items():
        ops_at = _innermost(cpu.get(tid, []), [w[0] for _, w in ws])
        for (lab, w), site in zip(ws, ops_at):
            sites[(lab, w[2] if site == OUTSIDE else site)] += 1
    calls = defaultdict(int)
    for s, _, name in spans:
        if lo <= s < hi:
            calls[name] += 1
    return {"by_span": dict(by_span), "inside": into, "calls": dict(calls),
            "wait_sites": sorted(([a, b, n] for (a, b), n in sites.items()),
                                 key=lambda x: -x[2]),
            "unlinked": sum(1 for _, _, _, cid in ops if cid not in at)}


def readings(att: dict, counters: Dict[str, int], steps: int = 0) -> dict:
    """The five readings from ``attribute``'s output (the mapping ones
    where the window ran ``map.iter``, the training one where ``steps``
    > 0) and the window's counters."""
    out = {}
    iters = att["calls"].get("map.iter", 0)
    if iters:
        inside = att["inside"]
        out["render_bwd_ms.map"] = 1e3 * inside["map.backward"][
            "device_s"] / iters
        out["map_launches_per_iter.map"] = inside["map.iter"][
            "launches"] / iters
        out["map_syncs_per_iter.map"] = inside["map.iter"]["waits"] / iters
    planned = counters.get("render.views.planned", 0)
    grad = planned + counters.get("render.views.sorted", 0)
    if grad:
        out["planned_gather_share.map"] = 100.0 * planned / grad
    if steps:
        out["train_launches_per_step.train"] = sum(
            v["launches"] for v in att["by_span"].values()) / steps
    return out


def _summary(prof, counters, steps):
    """The probe's line of a traced run."""
    spans = [(s, e, n) for k, n, s, e in prof.events if k == "span"]
    att = attribute(spans, prof.ops, prof.calls, prof.waits, prof.window,
                    inside=("map.iter", "map.backward"),
                    cpu_ops=prof.cpu_ops)
    dev = [(s, e) for k, _, s, e in prof.events if k == "device"]
    gaps = idle_gaps([(max(s, prof.window[0]), min(e, prof.window[1]))
                      for s, e in dev], *prof.window)
    idle = defaultdict(float)
    for lab, (s, e) in zip(_innermost(spans, [g[0] for g in gaps]), gaps):
        idle[lab] += e - s
    busy = sum(v["device_s"] for v in att["by_span"].values())
    program = sum(v["device_s"] for k, v in att["by_span"].items()
                  if k not in DRIVER_SPANS)
    return {"readings": readings(att, counters, steps),
            "window_s": prof.window[1] - prof.window[0],
            "idle_s": sum(idle.values()),
            "idle_by_span": sorted(idle.items(), key=lambda kv: -kv[1]),
            "device_by_span": sorted(
                ((k, v["device_s"], v["launches"], v["waits"])
                 for k, v in att["by_span"].items()),
                key=lambda x: -x[1]),
            "program_busy_share": program / busy if busy else None,
            "inside": att["inside"], "calls": att["calls"],
            "wait_sites": att["wait_sites"][:20],
            "unlinked_ops": att["unlinked"], "ops": len(prof.ops),
            "runtime_calls": len(prof.calls), "counters": dict(counters)}


def trace_run(cell, seed, seconds):
    """The probe's line of a traced run through the cell's driver."""
    from cut3r_slam_tpu_torch.utils.profiling import attach
    from port_bench import harness
    drv = harness.driver(cell.traffic["driver"])
    made = {}
    window = {}

    def at_window_end(orig):
        """The SLAM driver's render roofline runs after the window: the
        window's counts are read before it."""
        def wrapped(slam, *a, **k):
            window["timer"] = _snapshot(slam.timer)
            return orig(slam, *a, **k)
        return wrapped
    own = CountingSpans()
    with harness.patched(drv, "Profile",
                         lambda _: lambda: made.setdefault(
                             "prof", LaunchProfile())), \
            harness.patched(drv, "Spans", lambda _: CountingSpans), \
            contextlib.ExitStack() as stack:
        if hasattr(drv, "render_roofline"):
            stack.enter_context(harness.patched(drv, "render_roofline",
                                                at_window_end))
        # the SLAM driver attaches its own spans at the window's start
        prev = attach(own)
        try:
            out = drv.run(cell, seed, seconds, True, "cuda")
        finally:
            last = attach(prev)
    timer = window.get("timer") or _snapshot(last)
    traced = cell.traffic.get("trace_steps")
    steps = traced[1] - traced[0] if traced else 0
    line = _summary(made["prof"], timer["counters"], steps)
    units = out["attempted"]
    line["span_calls_per_unit"] = timer["calls"] / units if units else None
    line["correct"] = out["check"].correct
    line["checks"] = out["check"].report()
    line["breakdown_idle_gaps"] = out["readings"]["trace"]["idle_gaps"]
    return line


def _snapshot(timer):
    """A timer's counters and its spans' calls, as they stand."""
    return {"counters": dict(getattr(timer, "counters", {})),
            "calls": sum(timer.counts.values())}


def _metric(out):
    r = out["readings"]
    if "records" in r:
        return len(r["records"]) / r["window_s"]
    return r["views"] / r["window_s"]


def noop_ns(n=1_000_000):
    """ns a call of the no-op ``span`` (entered and left) and ``count``."""
    from cut3r_slam_tpu_torch.utils.profiling import attach, count, span
    prev = attach(None)
    try:
        t0 = time.perf_counter()
        for _ in range(n):
            with span("map.iter"):
                pass
        t1 = time.perf_counter()
        for _ in range(n):
            count("render.views.sorted", 4)
        t2 = time.perf_counter()
        for _ in range(n):
            pass
        t3 = time.perf_counter()
    finally:
        attach(prev)
    loop = t3 - t2
    return {"span_ns": 1e9 * (t1 - t0 - loop) / n,
            "count_ns": 1e9 * (t2 - t1 - loop) / n}


def cost_runs(cell, seed, seconds, runs, device="cuda"):
    """``runs`` pairs of untraced runs, the program's ``StageTimer``
    attached for the whole window and nothing attached, alternated."""
    from cut3r_slam_tpu_torch.slam import mapping, system
    from cut3r_slam_tpu_torch.utils import profiling
    from port_bench import harness
    drv = harness.driver(cell.traffic["driver"])
    res = {"on": [], "off": [], "span_calls": [], "seeds": []}
    for i in range(runs):
        for mode in ("on", "off"):
            timer = profiling.StageTimer() if mode == "on" else None
            keep = (lambda orig: lambda t: orig(timer)) if timer \
                else (lambda orig: orig)
            prev = profiling.attach(timer)
            try:
                # the SLAM driver assigns None to the system's timer:
                # the attached one stays
                with harness.patched(system, "attach", keep), \
                        harness.patched(mapping, "attach", keep):
                    out = drv.run(cell, seed + i, seconds, False, device,
                                  check=False)
            finally:
                profiling.attach(prev)
            res[mode].append(_metric(out))
            if timer is not None:
                res["span_calls"].append(sum(timer.counts.values()))
                res["units"] = out["attempted"]
        res["seeds"].append(seed + i)
    res["noop"] = noop_ns()
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--mode", choices=("trace", "cost"), default="trace")
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from port_bench import harness
    import os
    harness.cache_dirs(os.getcwd())
    cell = harness.load_cell(args.workload)
    if args.mode == "trace":
        line = trace_run(cell, args.seed, args.seconds)
    else:
        line = cost_runs(cell, args.seed, args.seconds, args.runs)
    line.update(workload=args.workload, mode=args.mode, seed=args.seed)
    text = json.dumps(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
