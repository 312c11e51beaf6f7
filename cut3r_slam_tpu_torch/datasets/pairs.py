"""Cross-view pair generation for CroCo pretraining (the port's own copy
of ``cut3r_slam_tpu/datasets/pairs.py``; numpy, no torch).

A geometric pair synthesizer that warps any RGB(-D) frame into a second
view (homography jitter for RGB-only sources; depth reprojection with a
z-buffer when depth and intrinsics exist) and a pair dataset over video
sources (consecutive-frame pairs), both emitting the (img1, img2)
batches ``models/croco_pretrain`` consumes. The perspective warp takes
cv2 when it imports and an inverse-map bilinear numpy warp otherwise.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["homography_pair", "reprojection_pair", "PairDataset",
           "make_pair_iter"]


def _warp_perspective(img: np.ndarray, Hm: np.ndarray,
                      out_hw: Tuple[int, int]) -> np.ndarray:
    """Inverse-map perspective warp (bilinear); pure numpy fallback."""
    try:
        import cv2
        return cv2.warpPerspective(img, Hm, (out_hw[1], out_hw[0]))
    except ImportError:
        H, W = out_hw
        yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        pts = np.stack([xx, yy, np.ones_like(xx)], -1).reshape(-1, 3).T
        src = np.linalg.inv(Hm) @ pts
        sx = src[0] / src[2]
        sy = src[1] / src[2]
        sx = np.clip(sx, 0, img.shape[1] - 1)
        sy = np.clip(sy, 0, img.shape[0] - 1)
        x0, y0 = sx.astype(int), sy.astype(int)
        x1 = np.minimum(x0 + 1, img.shape[1] - 1)
        y1 = np.minimum(y0 + 1, img.shape[0] - 1)
        wx, wy = sx - x0, sy - y0
        out = (img[y0, x0].T * (1 - wx) * (1 - wy)
               + img[y0, x1].T * wx * (1 - wy)
               + img[y1, x0].T * (1 - wx) * wy
               + img[y1, x1].T * wx * wy).T
        return out.reshape(H, W, -1).astype(img.dtype)


def homography_pair(img: np.ndarray, rng: np.random.Generator,
                    max_rot: float = 0.2, max_persp: float = 3e-4,
                    max_trans: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """Two perspective-jittered views of one frame (RGB-only sources)."""
    H, W = img.shape[:2]

    def sample():
        a = rng.uniform(-max_rot, max_rot)
        c, s = np.cos(a), np.sin(a)
        tx = rng.uniform(-max_trans, max_trans) * W
        ty = rng.uniform(-max_trans, max_trans) * H
        p = rng.uniform(-max_persp, max_persp, 2)
        Hm = np.array([[c, -s, tx], [s, c, ty], [p[0], p[1], 1.0]])
        # rotate about the image center
        T = np.array([[1, 0, -W / 2], [0, 1, -H / 2], [0, 0, 1.0]])
        return np.linalg.inv(T) @ Hm @ T

    return (_warp_perspective(img, sample(), (H, W)),
            _warp_perspective(img, sample(), (H, W)))


def reprojection_pair(img: np.ndarray, depth: np.ndarray, K4: np.ndarray,
                      rng: np.random.Generator,
                      max_rot: float = 0.1, max_trans: float = 0.1
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """True novel-view warp via depth reprojection (forward splat with a
    z-buffer) — the habitat-style geometric pair when depth exists."""
    H, W = img.shape[:2]
    fx, fy, cx, cy = K4
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    z = np.maximum(depth, 1e-3)
    pts = np.stack([(xx - cx) / fx * z, (yy - cy) / fy * z, z], -1)

    aa = rng.uniform(-max_rot, max_rot, 3)
    Rx = np.array([[1, 0, 0], [0, np.cos(aa[0]), -np.sin(aa[0])],
                   [0, np.sin(aa[0]), np.cos(aa[0])]])
    Ry = np.array([[np.cos(aa[1]), 0, np.sin(aa[1])], [0, 1, 0],
                   [-np.sin(aa[1]), 0, np.cos(aa[1])]])
    Rz = np.array([[np.cos(aa[2]), -np.sin(aa[2]), 0],
                   [np.sin(aa[2]), np.cos(aa[2]), 0], [0, 0, 1]])
    R = Rx @ Ry @ Rz
    t = rng.uniform(-max_trans, max_trans, 3) * float(np.median(z))

    p2 = pts.reshape(-1, 3) @ R.T + t
    z2 = np.maximum(p2[:, 2], 1e-3)
    u = (p2[:, 0] / z2 * fx + cx).round().astype(int)
    v = (p2[:, 1] / z2 * fy + cy).round().astype(int)
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    out = np.zeros_like(img)
    zbuf = np.full((H, W), np.inf, np.float32)
    order = np.argsort(-z2)  # far-to-near so near pixels overwrite
    src = img.reshape(-1, img.shape[-1])
    for i in order[ok[order]]:
        if z2[i] < zbuf[v[i], u[i]]:
            zbuf[v[i], u[i]] = z2[i]
            out[v[i], u[i]] = src[i]
    return img, out


class PairDataset:
    """Co-visible pairs from a video source (consecutive-frame pairs,
    the pairs_dataset capability) or single frames via synthesis."""

    def __init__(self, source, gap: int = 1, synth: bool = False,
                 seed: int = 0):
        self.source = source
        self.gap = int(gap)
        self.synth = synth
        self.seed = seed

    def __len__(self):
        return max(len(self.source) - self.gap, 1)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed + i)
        a = self.source[i]
        if self.synth:
            if "depth" in a and "K4" in a and np.any(
                    np.asarray(a["depth"]) > 0):
                img1, img2 = reprojection_pair(
                    a["image"], np.asarray(a["depth"], np.float32),
                    np.asarray(a["K4"], np.float32), rng)
            else:
                img1, img2 = homography_pair(a["image"], rng)
        else:
            img1 = a["image"]
            img2 = self.source[min(i + self.gap,
                                   len(self.source) - 1)]["image"]
        return {"img1": img1, "img2": img2}


def make_pair_iter(ds: PairDataset, batch_size: int = 4, seed: int = 0,
                   resolution: Optional[Tuple[int, int]] = None
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Batches normalized to [-1, 1] for CroCoPretrain."""
    from ..utils.image import _resize
    rng = np.random.default_rng(seed)

    def prep(img):
        if resolution is not None:
            img = _resize(img, resolution[1], resolution[0])
        return (np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5

    while True:
        idx = rng.integers(len(ds), size=batch_size)
        pairs = [ds[int(i)] for i in idx]
        yield {"img1": np.stack([prep(p["img1"]) for p in pairs]),
               "img2": np.stack([prep(p["img2"]) for p in pairs])}
