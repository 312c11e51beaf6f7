"""TSDF mesh of a finished SLAM run (the port's counterpart of the
repository's ``tsdf_integrate.py``, with the same flags and inputs): fuse
the run's rendered keyframes ``renders_kf/depth_*.png`` (uint16 / 6553.5)
and ``color_*.png`` at the poses of ``traj_kf.txt`` (rows paired in
sorted order) with ``intrinsics.npy[0]`` for every frame, and write
``mesh.ply``.

    python -m cut3r_slam_tpu_torch.tsdf_integrate --rundir outputs/room0

Runs on the GPU; ``--cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rundir", required=True)
    p.add_argument("--voxel", type=float, default=0.02)
    p.add_argument("--depth_trunc", type=float, default=8.0)
    p.add_argument("--out", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="fuse on the CPU instead of the GPU")
    return p.parse_args(argv)


def run_frames(rundir: str):
    """(depth f32, colour f32 in [0, 1] or None, c2w f32) of every fused
    keyframe, and the intrinsics, as the reference driver reads them."""
    import cv2
    import torch
    from .geometry.pointmap import pose_vec_to_matrix
    from .utils.image import _imread
    traj = np.loadtxt(os.path.join(rundir, "traj_kf.txt"), ndmin=2)
    K4 = np.load(os.path.join(rundir, "intrinsics.npy"))[0]
    depth_files = sorted(glob.glob(os.path.join(rundir, "renders_kf",
                                                "depth_*.png")))
    color_files = sorted(glob.glob(os.path.join(rundir, "renders_kf",
                                                "color_*.png")))
    frames = []
    for i in range(min(len(depth_files), len(traj))):
        d = cv2.imread(depth_files[i], cv2.IMREAD_UNCHANGED)
        depth = np.asarray(d, np.float32) / 6553.5
        color = (_imread(color_files[i]).astype(np.float32) / 255.0
                 if i < len(color_files) else None)
        c2w = pose_vec_to_matrix(torch.as_tensor(
            traj[i, 1:8].astype(np.float32))).numpy()
        frames.append((depth, color, c2w))
    return frames, K4


def main(argv=None):
    args = parse_args(argv)
    from .utils.tsdf import TSDFVolume
    vol = TSDFVolume(voxel_size=args.voxel, trunc=4 * args.voxel,
                     device="cpu" if args.cpu else "cuda")
    frames, K4 = run_frames(args.rundir)
    for i, (depth, color, c2w) in enumerate(frames):
        vol.integrate(depth, color, K4, c2w, args.depth_trunc)
        print(f"integrated {i + 1}/{len(frames)}", end="\r")
    out = args.out or os.path.join(args.rundir, "mesh.ply")
    nverts = vol.save_ply(out)
    print(f"\nwrote {out} ({nverts} vertices)")
    return vol


if __name__ == "__main__":
    main()
