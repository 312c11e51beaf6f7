"""Readings the check's limits are set from, on the card, in one process:

    python3 -m port_bench.calibrate --workload <cell> --seeds S1 S2 ... \
        [--seconds S] [--control-seeds N] [--fault-seeds N] [--out FILE]

For each seed, one JSON line: the program's compared numbers (as a run
prints them) and the control's, each with whether the cell's check
passes it: the control is the reference put in the program's place in
the precision below the configuration's (CUT3R's products through
float8, the render, the mapper's losses and its Adam in bfloat16). A
SLAM cell runs its window (``--seconds``, the benchmark's run length by
default; the warm-up only before the first seed) to have the decodes,
renders and loss calls to compare, and runs the control on the first
``--control-seeds`` seeds; a training cell needs no window and adds, on
the first ``--fault-seeds`` seeds, the readings of its planted faults
(half of the batch left out, an answer altered). The benchmark's own
runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from port_bench import harness


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--control-seeds", type=int, default=None)
    p.add_argument("--fault-seeds", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.cache_dirs(os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("port_bench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = json.load(open(os.path.join(os.path.dirname(harness.ROOT),
                                        "BENCHMARK.json")))
    seconds = args.seconds or bench["run_seconds"]
    cell = harness.load_cell(args.workload)
    drv = harness.driver(cell.traffic["driver"])
    out = open(args.out, "a") if args.out else None
    n_control = len(args.seeds) if args.control_seeds is None \
        else args.control_seeds
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        if hasattr(drv, "calibrate"):
            nf = args.fault_seeds
            rec = drv.calibrate(cell, seed, "cuda", **(
                {} if nf is None or i < nf else {"faults": ()}))
        else:
            res = drv.run(cell, seed, seconds, False, "cuda", warmup=i == 0)
            chk = res["check"]
            rec = {"program": {**{k: v["value"] for k, v in
                                  chk.report().items()}, **chk.extra,
                               "correct": chk.correct},
                   "window_s": res["window_s"], "frames": res["attempted"]}
            if i < n_control:
                ctl = drv.controls(cell, res, "cuda")
                rec["control"] = {**{k: v["value"] for k, v in
                                     ctl.report().items()}, **ctl.extra,
                                  "correct": ctl.correct}
            del res
        torch.cuda.empty_cache()
        rec.update(seed=seed, cell=cell.name,
                   seconds=time.perf_counter() - t0)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
