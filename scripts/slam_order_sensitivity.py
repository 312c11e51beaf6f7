"""How far the live loop's keyframe poses move when only the float
summation order changes: the same ``SLAMSystem`` run on the CPU (tiny
CUT3R from a seeded draw, the 32x48 sequence of
tests/test_torch_parallel_slam.py) with one and with two intra-op
threads, at that test's mapping counts and at ``chip_smoke.py`` phase 6's
(window 10 / polish 10 / refine 10 iterations, 2 global-BA renders a view
an event, a 50-step finalize). Prints the largest keyframe-pose entry
difference of each pair. Adam turns gradients at the rounding floor into
full steps of either sign, so the more mapping iterations, the further
two orders drift apart: the view-parallel split is one more order.

    python scripts/slam_order_sensitivity.py      # ~2 min on 8 cores
"""
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
import test_torch_parallel_slam as T  # noqa: E402

PHASE6 = ({"iterations": 20, "window_opt_iters": 10,
           "new_view_opt_iters": 10, "gba_per_view": 2},
          {"pose_refine_iters": 10, "opt_segment": 10, "gba_segment": 50},
          50)


def run(threads, mapping, extra, finalize):
    torch.set_num_threads(threads)
    T.CFG["Mapping"].update(mapping)
    T.MAP_EXTRA.update(extra)
    T.CFG["opt_params"]["position_lr_max_steps"] = finalize
    slam = T._system(tempfile.mkdtemp(), 0)
    return T._result(slam, T._drive(slam, T._frames()))["pose"]


if __name__ == "__main__":
    test = (dict(T.CFG["Mapping"]), dict(T.MAP_EXTRA),
            T.CFG["opt_params"]["position_lr_max_steps"])
    for name, counts in (("the CPU test's counts", test),
                         ("phase 6's counts", PHASE6)):
        a, b = (run(n, *counts) for n in (1, 2))
        print(f"{name}: largest keyframe-pose difference, 1 vs 2 threads: "
              f"{float(np.abs(a - b).max()):.3e}", flush=True)
