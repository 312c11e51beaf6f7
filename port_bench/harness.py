"""What every cell shares: finding a cell's configuration, traffic mix,
driver and per-layer metrics by name, the device line, the guard against
JAX in the process, and the result line.

Everything is found by the name ``BENCHMARK.json`` gives it, so a later
change adds a cell, a configuration, a mix or a metric as new files:

- ``configs/<config>.json``    a configuration (the ``file`` of its entry)
- ``traffic/<cell>.json``      a cell's traffic mix, naming its ``driver``
                               and holding the limits of its check
- ``drivers/<driver>.py``      one per kind of entry (``run(cell)``)
- ``metrics/<metric>.py``      one per per-layer metric: ``LAYER``,
                               ``UNIT``, ``SOURCE``, ``MOVES`` and
                               ``read(readings)``, which returns a number
                               or None where the run has nothing to read
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

__all__ = ["ROOT", "Cell", "load_cell", "load_module", "read_metrics",
           "device_line", "foreign_modules", "patched", "FORBIDDEN"]

ROOT = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "cut3r_slam_tpu")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path):
    with open(path) as f:
        return json.load(f)


def _applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name: str, bench_path: Optional[str] = None,
              root: Optional[str] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (the repository root's by
    default) with its configuration, traffic and the metrics it reports;
    files are looked up under ``root`` (this folder by default)."""
    root = root or ROOT
    bench_path = bench_path or os.path.join(os.path.dirname(ROOT),
                                            "BENCHMARK.json")
    bench = _json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfile = os.path.join(os.path.dirname(root),
                         configs[w["config"]]["file"])
    return Cell(
        name=name, chips=int(w["chips"]), config=_json(cfile),
        traffic=_json(os.path.join(root, "traffic", w["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_module(path: str, name: str):
    """A Python file as a module (metric files carry dots in their
    names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Optional[str] = None):
    return load_module(os.path.join(root or ROOT, "drivers", name + ".py"),
                       f"port_bench_driver_{name}")


def read_metrics(metrics: List[dict], readings: dict,
                 root: Optional[str] = None) -> Dict[str, dict]:
    """{name: {value, unit}} of every metric whose reader finds something
    to read; a reader that finds nothing returns None and the metric is
    left out."""
    out = {}
    for m in metrics:
        mod = load_module(os.path.join(root or ROOT, "metrics",
                                       m["name"] + ".py"),
                          "port_bench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit_w() -> Optional[float]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_line(count: int, peak_bytes: int,
                power_w: Optional[float]) -> dict:
    """The result's ``device``: the card's name, the cards used, the peak
    of allocated memory the run read before its check, the power limit."""
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes),
            "power_limit_w": power_w}


def foreign_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (compared whole: ``cut3r_slam_tpu_torch`` is not
    ``cut3r_slam_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


@contextlib.contextmanager
def patched(obj, name, make):
    """``obj.name`` replaced by ``make(original)`` inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


def cache_dirs(checkout: str):
    """Kernel and build caches at fixed paths inside the checkout."""
    build = os.path.join(checkout, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["USE_FLAX"] = "0"
