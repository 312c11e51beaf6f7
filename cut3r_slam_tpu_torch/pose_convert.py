"""Trajectory format converter (the port's counterpart of the repository's
``pose_convert.py``, with the same flags): convert between the
framework's ``traj_kf.txt`` ([t tx ty tz qx qy qz qw] per line), TUM
format (the same layout, float timestamps) and one 4x4 matrix per line
(Replica's traj.txt), optionally inverting the poses (c2w <-> w2c).

    python -m cut3r_slam_tpu_torch.pose_convert --input traj.txt \
        --output traj_tq.txt --from_fmt matrix --to_fmt tq [--invert]

The conversions are float32, as the JAX tool computes them. This is a
host tool over small text files, with no kernel on it: it runs on the
CPU, as the JAX tool pins JAX to the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .geometry.lie import se3_from_matrix
from .geometry.pointmap import pose_vec_to_matrix


def _tq_to_matrix(tq) -> np.ndarray:
    return pose_vec_to_matrix(torch.tensor(tq, dtype=torch.float32)).numpy()


def load(path: str, fmt: str) -> np.ndarray:
    """Rows [t, tx, ty, tz, qx, qy, qz, qw]; a matrix file's rows are
    numbered from 0. A one-pose file reads as one row (the JAX tool reads
    it as a flat vector and fails on it)."""
    data = np.loadtxt(path, ndmin=2)
    if fmt == "matrix":
        mats = torch.tensor(data.reshape(-1, 4, 4), dtype=torch.float32)
        tq = se3_from_matrix(mats).numpy()
        return np.concatenate([np.arange(len(tq))[:, None], tq], 1)
    return data  # tq formats are already [t, tx..qw]


def save(path: str, rows: np.ndarray, fmt: str, invert: bool = False):
    if invert:
        inv = np.linalg.inv(_tq_to_matrix(rows[:, 1:8]))
        tq = se3_from_matrix(torch.from_numpy(inv)).numpy()
        rows = np.concatenate([rows[:, :1], tq], 1)
    if fmt == "matrix":
        np.savetxt(path, _tq_to_matrix(rows[:, 1:8]).reshape(len(rows), 16))
    else:
        np.savetxt(path, rows)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--from_fmt", default="tq", choices=["tq", "matrix"])
    p.add_argument("--to_fmt", default="tq", choices=["tq", "matrix"])
    p.add_argument("--invert", action="store_true",
                   help="invert poses (c2w <-> w2c)")
    args = p.parse_args(argv)
    rows = load(args.input, args.from_fmt)
    save(args.output, rows, args.to_fmt, args.invert)
    print(f"converted {len(rows)} poses -> {args.output}")


if __name__ == "__main__":
    main()
