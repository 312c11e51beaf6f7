"""One run of one cell of the port's benchmark on the card it starts on.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix,
driver and metrics are found by the names ``BENCHMARK.json`` gives
(``harness.py``). The last line of standard output is the result: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (the window traced in part, the stage timer attached);
the last lines of standard error are the numbers the check compared,
each beside its limit. Without a CUDA card, or with fewer cards than the
cell asks for, it prints no result and exits 2; with JAX or the JAX
package loaded in the process once the window has closed, 3.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _since_process_start() -> float:
    """Seconds between the process's start and ``T_PROCESS``."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK")
                   - (time.perf_counter() - T_PROCESS))
    except (OSError, ValueError, IndexError):
        return 0.0


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, out, args, setup_s, power_w):
    """The contract's last line."""
    from port_bench import harness
    chk = out["check"]
    if args.trace:
        metrics = harness.read_metrics(cell.per_layer, out["readings"])
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                mod = harness.load_module(
                    os.path.join(harness.ROOT, "metrics", m["name"] + ".py"),
                    "port_bench_e2e_" + m["name"])
                v = mod.read(out["readings"])
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
    device = harness.device_line(cell.chips, out["peak"], power_w)
    line = {"correct": chk.correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    tr = out["readings"].get("trace")
    if args.trace and tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": [list(x) for x in
                                            tr["device_ops"]],
                             "idle_gaps": [list(x) for x in
                                           tr["idle_gaps"]]}
    line["checks"] = chk.report()
    return line


def diagnostics(out):
    """What a reader of the run needs beside its result, on standard
    error: the set-up's phases, each frame or step, the trace's device
    activities."""
    r = out["readings"]
    print("setup phases (s): " + json.dumps(r.get("setup_phases")),
          file=sys.stderr)
    if "records" in r:
        print("frames (t, s, slices, Gaussians): " + json.dumps(
            [(x["t"], round(x["s"], 4), x["slices"], x["gauss"])
             for x in r["records"]]), file=sys.stderr)
    if r.get("spans"):
        print("host spans (s): " + json.dumps(
            {k: round(v, 3) for k, v in r["spans"].items()}), file=sys.stderr)
    for k in ("steps", "encodes", "decodes", "views_fwd", "views_grad",
              "track_pose_gap", "read_loss1", "read_loss", "read_fwd_pose"):
        if k in r:
            print(f"{k}: {r[k]}", file=sys.stderr)
    if r.get("trace"):
        print("trace device activities: " + json.dumps(r["trace"].get(
            "kinds")), file=sys.stderr)


def main(argv=None):
    args = parse(argv)
    checkout = os.getcwd()
    from port_bench import harness
    harness.cache_dirs(checkout)
    import torch
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"port_bench: cell {cell.name} needs {cell.chips} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    power_w = harness.power_limit_w()
    drv = harness.driver(cell.traffic["driver"])
    out = drv.run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    setup_s = _since_process_start() + (out["setup_end"] - T_PROCESS)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"port_bench: the process loaded {', '.join(foreign)}",
              file=sys.stderr)
        return 3
    line = result_line(cell, out, args, setup_s, power_w)
    diagnostics(out)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
