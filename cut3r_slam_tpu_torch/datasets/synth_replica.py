"""A Replica-layout sequence rendered from the procedural scene (port of
``cut3r_slam_tpu/datasets/synth_replica.py``, numpy; the same files at the
same seed).

No dataset ships with the repository, so the eval drivers, the
ground-truth-injection driver, the ATE and the TSDF mesh run on this
layout, rendered by ``datasets/synthscene.SynthScene`` along a smooth
low-parallax arc:

  <root>/<seq>/results/frame{i:06d}.jpg    RGB
  <root>/<seq>/results/depth{i:06d}.png    uint16 depth * 6553.5
  <root>/<seq>/traj.txt                    N rows x 16 (flattened c2w)
"""
from __future__ import annotations

import os

import numpy as np

from .synthscene import SynthScene, _lookat

__all__ = ["write_replica_sequence", "camera_arc", "REPLICA_K4",
           "REPLICA_HW"]

# calib/replica.txt: the Replica pinhole at 1200 x 680
REPLICA_K4 = np.asarray([600.0, 600.0, 599.5, 339.5], np.float32)
REPLICA_HW = (680, 1200)


def _save_rgb(path: str, img: np.ndarray):
    import cv2
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def _save_depth16(path: str, depth: np.ndarray):
    import cv2
    cv2.imwrite(path, np.clip(depth * 6553.5, 0, 65535).astype(np.uint16))


def camera_arc(n: int, seed: int = 0, radius: float = 5.0,
               sweep: float = 0.9) -> np.ndarray:
    """(n, 4, 4) c2w along an arc at camera height looking at the scene
    centre, ``sweep`` radians end to end: consecutive frames overlap
    heavily (the tracker's small-baseline regime)."""
    rng = np.random.default_rng(seed)
    th0 = rng.uniform(0.0, 2 * np.pi)
    target = np.asarray([0.0, 0.5, 0.0], np.float32)
    poses = []
    for i in range(n):
        th = th0 + sweep * i / max(n - 1, 1)
        eye = np.asarray([radius * np.cos(th), -1.6, radius * np.sin(th)],
                         np.float32)
        poses.append(_lookat(eye, target))
    return np.stack(poses)


def write_replica_sequence(root: str, seq: str = "synth0",
                           n_frames: int = 24, hw=None, K4=None,
                           seed: int = 0, write_depth: bool = True) -> str:
    """Render and write one Replica-layout sequence; returns its folder.
    Defaults to the native Replica size and intrinsics, so
    ``calib/replica.txt`` and ``config/replica_config.yaml`` drive it.
    Frames render in as many threads as torch's intra-op setting allows
    (numpy releases the GIL in its array loops); the files do not depend
    on it."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    H, W = hw if hw is not None else REPLICA_HW
    K4 = np.asarray(K4 if K4 is not None else REPLICA_K4, np.float32)
    scene = SynthScene(seed=seed)
    d = os.path.join(root, seq)
    res = os.path.join(d, "results")
    os.makedirs(res, exist_ok=True)
    poses = camera_arc(n_frames, seed=seed)
    with ThreadPoolExecutor(max(1, min(n_frames,
                                       torch.get_num_threads()))) as pool:
        frames = list(pool.map(lambda c2w: scene.render(c2w, K4, H, W),
                               poses))
    rows = []
    for i, (c2w, (rgb, depth)) in enumerate(zip(poses, frames)):
        _save_rgb(os.path.join(res, f"frame{i:06d}.jpg"), rgb)
        if write_depth:
            _save_depth16(os.path.join(res, f"depth{i:06d}.png"), depth)
        rows.append(np.asarray(c2w, np.float64).reshape(-1))
    np.savetxt(os.path.join(d, "traj.txt"), np.stack(rows))
    return d
