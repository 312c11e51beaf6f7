"""The training cells' multi-view RGB-D scenes, drawn from the seed by the
benchmark itself, and written in the scene-folder layout that the
program's training input pipeline reads: per scene ``rgb/<frame>.png``,
``depth/<frame>.npy`` (float32, camera z) and ``cam/<frame>.npz``
(``camera_intrinsics`` 3x3, ``camera_pose`` 4x4 camera-to-world).

A scene is a textured box room with spheres in it, ray-cast exactly;
the camera sweeps a short arc near the room's middle, turning a few
degrees a view, so that every pixel sees a surface at a valid depth and
neighbouring views overlap. The arrays stay in memory too: the reference
builds its batches from them, not from what the program read.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["Scene", "draw_scenes", "write_scenes", "view_batch"]

HFOV_DEG = 60.0


class Scene:
    """One scene's views: ``rgb`` (N, H, W, 3) uint8, ``depth`` (N, H, W)
    float32, ``c2w`` (N, 4, 4) float32, ``K`` (3, 3) float32."""

    def __init__(self, rgb, depth, c2w, K):
        self.rgb, self.depth, self.c2w, self.K = rgb, depth, c2w, K


def _texture(p, surf, rng_tex):
    """Colour of world points ``p`` (..., 3) on surface ids ``surf``."""
    base, freq, phase = rng_tex
    f = freq[surf]                        # (..., 2, 3)
    ph = phase[surf]                      # (..., 2)
    w1 = np.sin((p * f[..., 0, :]).sum(-1) + ph[..., 0])
    w2 = np.sin((p * f[..., 1, :]).sum(-1) + ph[..., 1])
    check = (np.floor(p * 2.0).sum(-1) % 2) * 2 - 1
    c = base[surf] * (0.75 + 0.2 * w1[..., None] * w2[..., None]
                      + 0.05 * check[..., None])
    return np.clip(c, 0.0, 1.0)


def _camera(yaw, pitch, eye):
    """Camera-to-world of a camera at ``eye`` looking along (yaw, pitch);
    x right, y down, z forward."""
    fwd = np.array([np.sin(yaw) * np.cos(pitch), np.sin(pitch),
                    np.cos(yaw) * np.cos(pitch)])
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, down, fwd, eye
    return m


def _render(c2w, K, H, W, room, spheres, tex):
    """Ray-cast one view: (rgb uint8 (H, W, 3), depth float32 (H, W))."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float64) + 0.5
    d_cam = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                      np.ones_like(u)], -1)
    R, o = c2w[:3, :3], c2w[:3, 3]
    d = d_cam @ R.T                       # unnormalized: t is camera z
    with np.errstate(divide="ignore"):
        t_walls = np.maximum((room - o) / d, (-room - o) / d)
    axis = np.argmin(t_walls, -1)
    t = np.take_along_axis(t_walls, axis[..., None], -1)[..., 0]
    side = np.sign(np.take_along_axis(d, axis[..., None], -1)[..., 0])
    surf = axis * 2 + (side > 0)
    for i, (c, r) in enumerate(spheres):
        oc = o - c
        a = (d * d).sum(-1)
        b = (d * oc).sum(-1)
        disc = b * b - a * ((oc * oc).sum() - r * r)
        ts = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
        hit = (disc > 0) & (ts > 0) & (ts < t)
        t = np.where(hit, ts, t)
        surf = np.where(hit, 6 + i, surf)
    p = o + t[..., None] * d
    rgb = (_texture(p, surf, tex) * 255.0 + 0.5).astype(np.uint8)
    return rgb, t.astype(np.float32)


def draw_scenes(n_scenes, views, hw, seed):
    """``n_scenes`` scenes of ``views`` views at ``hw`` from ``seed``."""
    H, W = hw
    f = W / 2 / np.tan(np.deg2rad(HFOV_DEG) / 2)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    out = []
    for s in range(n_scenes):
        rng = np.random.default_rng([seed, s])
        room = rng.uniform([2.5, 1.5, 2.5], [4.0, 2.5, 4.0])
        spheres = []
        for _ in range(4):
            ang = rng.uniform(0, 2 * np.pi)
            dist = rng.uniform(1.6, 2.2)
            c = np.array([np.sin(ang) * dist, rng.uniform(-0.8, 0.8),
                          np.cos(ang) * dist])
            spheres.append((c, rng.uniform(0.3, 0.7)))
        n_surf = 6 + len(spheres)
        tex = (rng.uniform(0.2, 1.0, (n_surf, 3)),
               rng.uniform(1.0, 6.0, (n_surf, 2, 3))
               * rng.choice([-1.0, 1.0], (n_surf, 2, 3)),
               rng.uniform(0, 2 * np.pi, (n_surf, 2)))
        yaw0 = rng.uniform(0, 2 * np.pi)
        dyaw = rng.uniform(0.08, 0.2) * rng.choice([-1.0, 1.0])
        arc = rng.uniform(0.2, 0.5)
        rgbs, depths, poses = [], [], []
        for i in range(views):
            yaw = yaw0 + i * dyaw
            eye = np.array([arc * np.sin(yaw0 + 0.5 * i * dyaw),
                            rng.uniform(-0.1, 0.1),
                            arc * np.cos(yaw0 + 0.5 * i * dyaw)])
            c2w = _camera(yaw, rng.uniform(-0.15, 0.15), eye)
            rgb, depth = _render(c2w, K, H, W, room, spheres, tex)
            rgbs.append(rgb)
            depths.append(depth)
            poses.append(c2w.astype(np.float32))
        out.append(Scene(np.stack(rgbs), np.stack(depths), np.stack(poses),
                         K.astype(np.float32)))
    return out


def write_scenes(root, scenes):
    """Write ``scenes`` under ``root`` (one folder each); returns the
    folders' names."""
    import cv2
    names = []
    for s, sc in enumerate(scenes):
        name = f"scene_{s:04d}"
        for sub in ("rgb", "depth", "cam"):
            os.makedirs(os.path.join(root, name, sub), exist_ok=True)
        for i in range(len(sc.rgb)):
            fr = f"{i:05d}"
            cv2.imwrite(os.path.join(root, name, "rgb", fr + ".png"),
                        np.ascontiguousarray(sc.rgb[i][..., ::-1]))
            np.save(os.path.join(root, name, "depth", fr + ".npy"),
                    sc.depth[i])
            np.savez(os.path.join(root, name, "cam", fr + ".npz"),
                     camera_intrinsics=sc.K, camera_pose=sc.c2w[i])
        names.append(name)
    return names


def view_batch(scenes, picks):
    """A training batch of the views ``picks`` ((scene, view) per view, one
    sequence) built from the scenes' arrays: images normalized to
    [-1, 1], world pointmaps from depth, K and pose, depth > 0 as valid,
    the poses; each (V, 1, ...)."""
    imgs, pts, poses, valid = [], [], [], []
    for s, i in picks:
        sc = scenes[s]
        H, W = sc.depth.shape[1:]
        d = sc.depth[i].astype(np.float64)
        v, u = np.mgrid[0:H, 0:W].astype(np.float64)
        cam = np.stack([(u - sc.K[0, 2]) / sc.K[0, 0] * d,
                        (v - sc.K[1, 2]) / sc.K[1, 1] * d, d], -1)
        c2w = sc.c2w[i].astype(np.float64)
        pts.append((cam @ c2w[:3, :3].T + c2w[:3, 3]).astype(np.float32))
        imgs.append((sc.rgb[i].astype(np.float32) / 255.0 - 0.5) / 0.5)
        poses.append(sc.c2w[i])
        valid.append(sc.depth[i] > 0)
    imgs = np.stack(imgs)[:, None]
    return {"imgs": imgs, "pts3d": np.stack(pts)[:, None],
            "camera_pose": np.stack(poses)[:, None],
            "valid_mask": np.stack(valid)[:, None], "img": imgs}
