"""Which functions of the JAX package have no counterpart in the port?

An ``ast`` walk, no import of either package: for every module of
``cut3r_slam_tpu/`` it collects the top-level functions and classes and
each class's methods, and lists those with no name of the same kind in
the port's module at the same path (``ops/gs_raster_pallas.py`` is held
against ``ops/gs_raster_cuda.py``, which ports it). Private names
(leading underscore) are listed too: some are XLA artefacts with no
counterpart to port, and ``ROADMAP.md`` §1 says which.

    python scripts/audit_port_surface.py [--public]

prints one line a module with its missing names and a total.
"""
from __future__ import annotations

import argparse
import ast
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENAMED = {"ops/gs_raster_pallas.py": "ops/gs_raster_cuda.py"}


def surface(path):
    """Top-level function / class names and ``Class.method`` names."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            names.update(f"{node.name}.{n.name}" for n in node.body
                         if isinstance(n, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)))
    return names


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--public", action="store_true",
                   help="leave out names with a leading underscore")
    args = p.parse_args()
    jax_root = os.path.join(ROOT, "cut3r_slam_tpu")
    port_root = os.path.join(ROOT, "cut3r_slam_tpu_torch")
    total = 0
    for d, _, files in sorted(os.walk(jax_root)):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, fn), jax_root)
            port = os.path.join(port_root, RENAMED.get(rel, rel))
            have = surface(port) if os.path.exists(port) else set()
            missing = sorted(n for n in surface(os.path.join(d, fn)) - have
                             if not (args.public and any(
                                 part.startswith("_") and
                                 not part.startswith("__")
                                 for part in n.split("."))))
            if not os.path.exists(port):
                print(f"{rel}: no module in the port")
            elif missing:
                print(f"{rel}: {', '.join(missing)}")
            total += len(missing)
    print(f"{total} names without a counterpart")


if __name__ == "__main__":
    main()
