"""RGB-D sequence loaders for ground-truth-injection runs and evaluation
(port of ``cut3r_slam_tpu/datasets/rgbd.py``, numpy).

Replica, ScanNet and TUM layouts; items are dicts with the colour image
(uint8 RGB), ``K4`` = [fx, fy, cx, cy], the metric depth when the sequence
has one (16-bit PNG over the dataset's scale: 6553.5 / 1000 / 5000) and
the ground-truth camera-to-world pose as [t, q xyzw] when it has one.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, Optional

import numpy as np

from ..utils.image import _imread

__all__ = ["get_dataset", "ReplicaDataset", "ScanNetDataset", "TUMDataset"]


def _read_depth(path: str, scale: float) -> np.ndarray:
    import cv2
    d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return np.asarray(d, np.float32) / scale


def _mat_to_tq(m: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation
    q = Rotation.from_matrix(m[:3, :3]).as_quat()
    return np.concatenate([m[:3, 3], q]).astype(np.float32)


def _numeric_sorted(pattern: str) -> list:
    """ScanNet's frame files by the number in their name."""
    return sorted(glob.glob(pattern), key=lambda p: int(
        os.path.splitext(os.path.basename(p))[0]))


class BaseRGBD:
    color_paths: list
    depth_paths: list
    poses: Optional[np.ndarray]
    K4: np.ndarray
    depth_scale: float = 6553.5

    def __len__(self):
        return len(self.color_paths)

    def __getitem__(self, i: int) -> Dict:
        out = {"t": i, "image": _imread(self.color_paths[i]), "K4": self.K4}
        if self.depth_paths:
            out["depth"] = _read_depth(self.depth_paths[i], self.depth_scale)
        if self.poses is not None:
            out["pose"] = self.poses[i]  # c2w [t, q xyzw]
        return out

    def __iter__(self) -> Iterator[Dict]:
        for i in range(len(self)):
            yield self[i]


class ReplicaDataset(BaseRGBD):
    """results/frame*.jpg + depth*.png, traj.txt of flattened 4x4 c2w."""

    def __init__(self, folder: str, calib=None):
        res = os.path.join(folder, "results")
        self.color_paths = sorted(glob.glob(os.path.join(res, "frame*.jpg")))
        self.depth_paths = sorted(glob.glob(os.path.join(res, "depth*.png")))
        self.depth_scale = 6553.5
        self.K4 = np.asarray(calib if calib is not None
                             else [600.0, 600.0, 599.5, 339.5], np.float32)
        traj = os.path.join(folder, "traj.txt")
        self.poses = None
        if os.path.exists(traj):
            mats = np.loadtxt(traj).reshape(-1, 4, 4)
            self.poses = np.stack([_mat_to_tq(m) for m in mats])


class ScanNetDataset(BaseRGBD):
    """ScanNet export: color/*.jpg, depth/*.png, pose/*.txt, and
    intrinsic/intrinsic_color.txt when no calibration is given."""

    def __init__(self, folder: str, calib=None):
        self.color_paths = _numeric_sorted(os.path.join(folder, "color",
                                                        "*.jpg"))
        self.depth_paths = _numeric_sorted(os.path.join(folder, "depth",
                                                        "*.png"))
        self.depth_scale = 1000.0
        intr = os.path.join(folder, "intrinsic", "intrinsic_color.txt")
        if calib is not None:
            self.K4 = np.asarray(calib, np.float32)
        elif os.path.exists(intr):
            K = np.loadtxt(intr)
            self.K4 = np.asarray([K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                                 np.float32)
        else:
            self.K4 = np.asarray([577.6, 578.7, 318.9, 242.7], np.float32)
        pose_files = _numeric_sorted(os.path.join(folder, "pose", "*.txt"))
        self.poses = (np.stack([_mat_to_tq(np.loadtxt(p).reshape(4, 4))
                                for p in pose_files])
                      if pose_files else None)


class TUMDataset(BaseRGBD):
    """TUM RGB-D: rgb.txt / depth.txt / groundtruth.txt, each colour frame
    paired with the nearest depth (within ``max_dt`` s, else None) and the
    nearest ground-truth row; without any paired depth the sequence has no
    depth at all."""

    def __init__(self, folder: str, calib=None, max_dt: float = 0.08):
        def read_list(name):
            path = os.path.join(folder, name)
            if not os.path.exists(path):
                return []
            with open(path) as f:
                return [ln.split() for ln in f
                        if ln.strip() and not ln.startswith("#")]

        rgb, depth, gt = (read_list(n) for n in ("rgb.txt", "depth.txt",
                                                 "groundtruth.txt"))
        self.depth_scale = 5000.0
        self.K4 = np.asarray(calib if calib is not None
                             else [517.3, 516.5, 318.6, 255.3], np.float32)
        d_ts = np.asarray([float(r[0]) for r in depth]) if depth else None
        g_ts = np.asarray([float(r[0]) for r in gt]) if gt else None
        self.color_paths, self.depth_paths, poses = [], [], []
        for row in rgb:
            ts = float(row[0])
            self.color_paths.append(os.path.join(folder, row[1]))
            if d_ts is not None:
                j = int(np.argmin(np.abs(d_ts - ts)))
                self.depth_paths.append(
                    os.path.join(folder, depth[j][1])
                    if abs(d_ts[j] - ts) < max_dt else None)
            if g_ts is not None:
                j = int(np.argmin(np.abs(g_ts - ts)))
                poses.append(np.asarray([float(x) for x in gt[j][1:8]],
                                        np.float32))  # [t, q xyzw]
        self.poses = np.stack(poses) if poses else None
        if not any(self.depth_paths):
            self.depth_paths = []


def get_dataset(kind: str, folder: str, calib=None) -> BaseRGBD:
    kinds = {"replica": ReplicaDataset, "scannet": ScanNetDataset,
             "tum": TUMDataset}
    if kind not in kinds:
        raise ValueError(f"unknown dataset {kind}; options {list(kinds)}")
    return kinds[kind](folder, calib)
