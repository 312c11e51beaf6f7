"""What the benchmark loads: nothing whose top-level module name is
``jax``, ``jaxlib``, ``flax`` or the JAX package's (compared whole: the
port's ``cut3r_slam_tpu_torch`` is allowed), and the reference loads
nothing of the port."""
import ast
import json
import os
import subprocess
import sys

from conftest import ROOT

PB = os.path.join(ROOT, "port_bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "cut3r_slam_tpu"}


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_drivers_and_metrics_load_no_jax():
    loaded = _loaded_after(
        "from port_bench import harness, run, flops, roofline, trace\n"
        "import json, glob, os\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "for w in bench['workloads']:\n"
        "    c = harness.load_cell(w['name'])\n"
        "    harness.driver(c.traffic['driver'])\n"
        "    harness.read_metrics(c.per_layer, {})\n"
        "import cut3r_slam_tpu_torch.slam.system, "
        "cut3r_slam_tpu_torch.train.train_step")
    assert not loaded & FORBIDDEN
    assert "cut3r_slam_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "from port_bench.reference import (cut3r, raster, train, adam,\n"
        "                                  map_loss)\n"
        "from port_bench import (weights, flops, roofline, frames, compare,\n"
        "                        scenes)")
    assert not loaded & (FORBIDDEN | {"cut3r_slam_tpu_torch"})


def test_reference_sources_import_only_torch_and_numpy():
    for name in os.listdir(os.path.join(PB, "reference")):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(PB, "reference", name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]} if node.level == 0 \
                    else set()
            else:
                continue
            assert tops <= {"torch", "numpy", "contextlib", "dataclasses",
                            "typing", "__future__", "math"}, (name, tops)
