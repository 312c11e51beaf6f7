"""Procedural multiview training data (port of
``cut3r_slam_tpu/datasets/synthscene.py``, numpy, the same draws).

The role of the upstream habitat-sim generation pipeline
(multiview_habitat_sim_generator.py, generate_multiview_images.py):
sample viewpoints around a scene, render RGB + metric depth, compute
pairwise co-visibility, and keep view tuples whose overlap falls in a
target band. Scenes are procedural — an analytic ray-cast world of a
textured ground plane, axis-aligned boxes and spheres — rendered in
vectorized numpy. The output layout is the standard ``SceneLayout``
(rgb/{frame}.png, depth/{frame}.npy, cam/{frame}.npz with
camera_intrinsics + camera_pose keys), so generated scenes feed
``datasets/loaders.SceneFolderSource`` -> ``datasets/multiview.
MultiViewDataset`` with no special casing. Co-visibility is measured by
reprojection with a depth-consistency check.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import List, Tuple

import numpy as np

__all__ = ["SynthScene", "sample_viewpoints", "covisibility",
           "generate_multiview_scenes"]


# --------------------------------------------------------------------- #
# scene + renderer
# --------------------------------------------------------------------- #
class SynthScene:
    """Analytic scene: ground plane y=+1 (camera looks along +z, y down),
    ``n_boxes`` axis-aligned boxes and ``n_spheres`` spheres scattered on
    it, each with a procedural color texture."""

    def __init__(self, seed: int = 0, n_boxes: int = 6, n_spheres: int = 3,
                 extent: float = 4.0):
        rng = np.random.default_rng(seed)
        self.extent = extent
        n = n_boxes
        centers = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
        sizes = rng.uniform(0.3, 1.2, (n, 3)).astype(np.float32)
        centers[:, 1] = 1.0 - sizes[:, 1] / 2  # resting on the plane y=1
        self.box_lo = centers - sizes / 2
        self.box_hi = centers + sizes / 2
        self.box_col = rng.uniform(0.15, 0.95, (n, 3)).astype(np.float32)
        m = n_spheres
        sc = rng.uniform(-extent, extent, (m, 3)).astype(np.float32)
        sr = rng.uniform(0.25, 0.7, m).astype(np.float32)
        sc[:, 1] = 1.0 - sr
        self.sph_c, self.sph_r = sc, sr
        self.sph_col = rng.uniform(0.15, 0.95, (m, 3)).astype(np.float32)
        self.tex_freq = rng.uniform(1.5, 4.0, 3).astype(np.float32)

    # ------------------------------------------------------------- rays
    def _hit_plane(self, o, d):
        """Ground plane y = 1 (normal -y)."""
        t = (1.0 - o[1]) / np.where(np.abs(d[..., 1]) < 1e-9, 1e-9,
                                    d[..., 1])
        return np.where(t > 1e-4, t, np.inf)

    def _hit_boxes(self, o, d):
        """Vectorized slab test -> (HW, n_boxes) entry distances."""
        inv = 1.0 / np.where(np.abs(d) < 1e-9, 1e-9, d)      # (HW, 3)
        t0 = (self.box_lo[None] - o[None, None]) * inv[:, None]
        t1 = (self.box_hi[None] - o[None, None]) * inv[:, None]
        tmin = np.minimum(t0, t1).max(-1)
        tmax = np.maximum(t0, t1).min(-1)
        hit = (tmax >= tmin) & (tmax > 1e-4)
        return np.where(hit, np.where(tmin > 1e-4, tmin, np.inf), np.inf)

    def _hit_spheres(self, o, d):
        oc = o[None, None] - self.sph_c[None]                # (1, m, 3)
        b = np.einsum("hd,hmd->hm", d, np.broadcast_to(
            oc, (d.shape[0],) + oc.shape[1:]))
        c = (oc * oc).sum(-1) - self.sph_r[None] ** 2        # (1, m)
        disc = b * b - c
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        return np.where((disc > 0) & (t > 1e-4), t, np.inf)

    def _texture(self, p, base):
        """Procedural stripes modulating a base color at world point p."""
        f = self.tex_freq
        s = (0.75 + 0.25 * np.sin(f[0] * p[..., 0])
             * np.cos(f[1] * p[..., 2] + f[2] * p[..., 1]))
        return base * s[..., None]

    # ----------------------------------------------------------- render
    def render(self, c2w: np.ndarray, K4: np.ndarray, H: int, W: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Render (rgb uint8 (H, W, 3), metric depth f32 (H, W)); depth 0
        marks sky (invalid), matching the reference's ``z == 0`` invalid
        convention (multiview_habitat_sim_generator.py:52)."""
        fx, fy, cx, cy = K4
        u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
        dirs = np.stack([(u - cx) / fx, (v - cy) / fy,
                         np.ones_like(u)], -1).reshape(-1, 3)
        R, t = c2w[:3, :3].astype(np.float32), c2w[:3, 3].astype(np.float32)
        d = dirs @ R.T
        nrm = np.linalg.norm(d, axis=-1, keepdims=True)
        dn = d / nrm

        t_pl = self._hit_plane(t, dn)                          # (HW,)
        t_bx = self._hit_boxes(t, dn)                          # (HW, n)
        t_sp = self._hit_spheres(t, dn)                        # (HW, m)
        t_all = np.concatenate([t_pl[:, None], t_bx, t_sp], 1)
        k = np.argmin(t_all, 1)
        t_hit = t_all[np.arange(k.size), k]
        hit = np.isfinite(t_hit)

        p = t + dn * np.where(hit, t_hit, 0.0)[:, None]
        n_b = self.box_lo.shape[0]
        base = np.empty((k.size, 3), np.float32)
        base[k == 0] = np.float32([0.45, 0.42, 0.38])          # floor
        bx = (k >= 1) & (k <= n_b)
        base[bx] = self.box_col[k[bx] - 1]
        sp = k > n_b
        base[sp] = self.sph_col[k[sp] - 1 - n_b]
        rgb = self._texture(p, base)
        # simple depth-cued shading + horizon sky
        rgb = rgb * (1.0 / (1.0 + 0.02 * np.where(hit, t_hit, 0.0)))[:, None]
        sky = np.float32([0.65, 0.75, 0.9])
        rgb = np.where(hit[:, None], rgb, sky[None])
        # z-depth (not ray length): p in camera frame
        pc = (p - t) @ R
        depth = np.where(hit, pc[:, 2], 0.0).astype(np.float32)
        rgb8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        return rgb8.reshape(H, W, 3), depth.reshape(H, W)


# --------------------------------------------------------------------- #
# viewpoint sampling + co-visibility
# --------------------------------------------------------------------- #
def _lookat(eye, target, up=(0.0, -1.0, 0.0)):
    f = np.asarray(target, np.float32) - np.asarray(eye, np.float32)
    f /= max(np.linalg.norm(f), 1e-9)
    r = np.cross(f, np.asarray(up, np.float32))
    r /= max(np.linalg.norm(r), 1e-9)
    u = np.cross(f, r)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = r, u, f, eye
    return c2w


def sample_viewpoints(n: int, rng: np.random.Generator,
                      radius: float = 6.0, extent: float = 4.0
                      ) -> List[np.ndarray]:
    """Jittered ring of cameras looking at a jittered scene point — the
    role of habitat's navmesh position + lookat-point sampling
    (multiview_habitat_sim_generator.py:230-260)."""
    poses = []
    th0 = rng.uniform(0, 2 * np.pi)
    for i in range(n):
        th = th0 + 2 * np.pi * i / max(n, 1) \
            + rng.uniform(-0.25, 0.25)
        r = radius * rng.uniform(0.8, 1.2)
        eye = [r * np.cos(th), rng.uniform(-2.5, -1.0), r * np.sin(th)]
        target = rng.uniform(-0.25 * extent, 0.25 * extent, 3)
        target[1] = rng.uniform(0.0, 0.8)
        poses.append(_lookat(eye, target))
    return poses


def _world_points(depth_i, c2w_i, K4):
    """View i's valid pixels as world points (N, 3)."""
    H, W = depth_i.shape
    fx, fy, cx, cy = K4
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    valid = depth_i > 0
    z = depth_i[valid]
    pc = np.stack([(u[valid] - cx) / fx * z, (v[valid] - cy) / fy * z, z], 1)
    return pc @ c2w_i[:3, :3].T + c2w_i[:3, 3]


def _covisible_fraction(pw, depth_j, c2w_j, K4, rel_tol):
    H, W = depth_j.shape
    fx, fy, cx, cy = K4
    w2c_j = np.linalg.inv(c2w_j)
    q = pw @ w2c_j[:3, :3].T + w2c_j[:3, 3]
    zq = q[:, 2]
    front = zq > 1e-4
    uj = np.where(front, q[:, 0] / np.where(front, zq, 1) * fx + cx, -1)
    vj = np.where(front, q[:, 1] / np.where(front, zq, 1) * fy + cy, -1)
    inside = front & (uj >= 0) & (uj < W) & (vj >= 0) & (vj < H)
    ui = np.clip(uj.astype(int), 0, W - 1)
    vi = np.clip(vj.astype(int), 0, H - 1)
    dj = depth_j[vi, ui]
    consistent = inside & (dj > 0) & (np.abs(dj - zq)
                                      <= rel_tol * np.maximum(dj, 1e-3) + 0.05)
    return float(consistent.sum()) / float(pw.shape[0])


def covisibility(depth_i, c2w_i, depth_j, c2w_j, K4,
                 rel_tol: float = 0.03) -> float:
    """Fraction of view i's valid pixels whose 3D points reproject into
    view j in-frame with consistent depth (occlusion-aware overlap)."""
    if not (depth_i > 0).any():
        return 0.0
    return _covisible_fraction(_world_points(depth_i, c2w_i, K4), depth_j,
                               c2w_j, K4, rel_tol)


# --------------------------------------------------------------------- #
# generation driver
# --------------------------------------------------------------------- #
def generate_multiview_scenes(root: str, n_scenes: int = 4,
                              views_per_scene: int = 8,
                              hw: Tuple[int, int] = (192, 256),
                              hfov_deg: float = 60.0, seed: int = 0,
                              min_overlap: float = 0.1,
                              max_overlap: float = 0.9) -> List[str]:
    """Render scenes into ``root`` in the standard SceneLayout and write a
    per-scene ``overlaps.npz`` (pairwise matrix + pairs within the target
    overlap band — generate_multiview_images.py's selection rule).

    Returns the list of scene directories written.
    """
    H, W = hw
    f = W / 2 / np.tan(np.deg2rad(hfov_deg) / 2)
    K4 = np.asarray([f, f, W / 2, H / 2], np.float32)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    out_dirs = []
    for s in range(n_scenes):
        rng = np.random.default_rng(seed * 1000 + s)
        scene = SynthScene(seed=seed * 1000 + s)
        poses = sample_viewpoints(views_per_scene, rng,
                                  extent=scene.extent)
        sdir = osp.join(root, f"scene_{seed:03d}_{s:04d}")
        for sub in ("rgb", "depth", "cam"):
            os.makedirs(osp.join(sdir, sub), exist_ok=True)
        depths = []
        for i, c2w in enumerate(poses):
            rgb, depth = scene.render(c2w, K4, H, W)
            depths.append(depth)
            from ..utils.viz import save_image
            save_image(osp.join(sdir, "rgb", f"{i:05d}.png"), rgb)
            np.save(osp.join(sdir, "depth", f"{i:05d}.npy"), depth)
            np.savez(osp.join(sdir, "cam", f"{i:05d}.npz"),
                     camera_intrinsics=K, camera_pose=c2w)
        n = len(poses)
        ov = np.eye(n, dtype=np.float32)
        for i in range(n):
            if not (depths[i] > 0).any():
                ov[i] = 0.0
                ov[i, i] = 1.0
                continue
            # view i's world points once for all j (the same values as
            # covisibility(i, j) computes for each pair)
            pw = _world_points(depths[i], poses[i], K4)
            for j in range(n):
                if i != j:
                    ov[i, j] = _covisible_fraction(pw, depths[j], poses[j],
                                                   K4, 0.03)
        sym = 0.5 * (ov + ov.T)
        ii, jj = np.nonzero(np.triu(
            (sym >= min_overlap) & (sym <= max_overlap), 1))
        np.savez(osp.join(sdir, "overlaps.npz"), overlap=ov,
                 pairs=np.stack([ii, jj], 1) if ii.size else
                 np.zeros((0, 2), np.int64))
        out_dirs.append(sdir)
    return out_dirs
