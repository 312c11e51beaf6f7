"""Non-keyframe pose filling by render-based pose optimization (port of
``cut3r_slam_tpu/slam/trajectory_filler.py``): every non-keyframe frame's
pose starts from the nearest earlier keyframe's and takes ``iters`` Adam
steps on the alpha-masked RGB L1 of its render against the frame."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import full_f32
from ..geometry.lie import se3_from_matrix
from ..geometry.pointmap import pose_vec_to_matrix
from .camera import se3_delta_to_matrix
from .mapping import Adam, MappingBackend, _leaf
from .renderer import render_view

__all__ = ["TrajectoryFiller"]


class TrajectoryFiller:
    def __init__(self, mapper: MappingBackend, iters: int = 100):
        self.mapper = mapper
        self.iters = iters

    @full_f32()
    def _refine(self, params, alive, image, w2c0):
        m = self.mapper
        dev = m.device
        deltas = {"t": torch.zeros(3, device=dev),
                  "r": torch.zeros(3, device=dev)}
        adam = Adam(deltas)
        lrs = {"t": m.cfg.pose_lr * 10, "r": m.cfg.pose_lr * 2}
        for _ in range(self.iters):
            dt, dr = _leaf(deltas["t"]), _leaf(deltas["r"])
            out = render_view(params, alive, w2c0, m.K4, m.raster_cfg,
                              trans_delta=dt, rot_delta=dr)
            a = (out["alpha"] > 0.5).detach()
            loss = torch.abs((image - out["color"]) * a[..., None]).sum() \
                / torch.clamp(a.sum() * 3.0, min=1.0)
            g = torch.autograd.grad(loss, (dt, dr))
            adam.step(deltas, {"t": g[0], "r": g[1]}, lrs)
        with torch.no_grad():
            return se3_delta_to_matrix(deltas["t"], deltas["r"]) @ w2c0

    def fill(self, images: List[np.ndarray], tstamps: List[int],
             kf_tstamps: np.ndarray, kf_poses: np.ndarray) -> np.ndarray:
        """images: the non-keyframe frames (uint8, mapping size); returns
        their (N, 7) c2w [t, q xyzw] poses."""
        dev = self.mapper.device
        arena_b, _ = self.mapper._sliced()
        params, alive = arena_b.params(), arena_b.alive
        out = []
        for img, t in zip(images, tstamps):
            k = max(int(np.searchsorted(kf_tstamps, t, side="right") - 1), 0)
            c2w0 = pose_vec_to_matrix(torch.as_tensor(
                np.asarray(kf_poses[k], np.float32), device=dev))
            w2c = self._refine(params, alive, torch.as_tensor(
                np.asarray(img), device=dev).float() / 255.0,
                torch.linalg.inv(c2w0))
            out.append(se3_from_matrix(torch.linalg.inv(w2c)).cpu().numpy())
        return np.stack(out) if out else np.zeros((0, 7), np.float32)
