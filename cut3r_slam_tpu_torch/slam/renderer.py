"""Render wrapper: world -> camera transform, then the rasterizer (port of
``cut3r_slam_tpu/slam/renderer.py``).

The Gaussian -> camera-frame transform happens outside the rasterizer so
pose-delta gradients flow through ``SE3_exp(deltas) @ w2c`` without the
kernels needing pose derivatives. ``render_view`` / ``render_window``
render through ``ops/gs_raster_cuda`` on every device: the blend runs the
CUDA kernels for CUDA tensors and their plain versions for CPU tensors.
A gradient ``render_window`` on the card replays CUDA graphs of its
forward and backward (``render_graph``).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops.gs_raster import RasterizeConfig, compute_bins
from ..ops.gs_raster_cuda import rasterize_cuda, rasterize_cuda_multi
from ..geometry.quaternion import matrix_to_quat, xyzw_to_wxyz
from . import render_graph
from .camera import se3_delta_to_matrix
from .gaussian_map import SH2RGB

__all__ = ["render_view", "render_window", "transform_to_frame", "bin_view",
           "bin_window", "quat_mult_wxyz"]


def quat_mult_wxyz(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def transform_to_frame(params: Dict[str, torch.Tensor], w2c: torch.Tensor):
    """Gaussian world params -> camera frame. w2c (..., 4, 4); returns
    (means_cam (..., P, 3), quats_cam_wxyz (..., P, 4))."""
    R = w2c[..., :3, :3]
    t = w2c[..., :3, 3]
    means_cam = params["xyz"] @ R.transpose(-1, -2) + t[..., None, :]
    q_cam = xyzw_to_wxyz(matrix_to_quat(R))
    q = params["quat"]
    quat_n = q / torch.sqrt((q * q).sum(-1, keepdim=True) + 1e-24)
    return means_cam, quat_mult_wxyz(q_cam[..., None, :], quat_n)


def _attrs(params, alive):
    opac = torch.sigmoid(params["opacity_logit"]) * alive.float()
    colors = torch.clamp(SH2RGB(params["f_dc"]), min=0.0)
    return torch.exp(params["log_scales"]), opac, colors


def _posed(w2c_base, trans_delta, rot_delta):
    if trans_delta is None and rot_delta is None:
        return w2c_base
    if trans_delta is None:
        trans_delta = torch.zeros_like(rot_delta)
    if rot_delta is None:
        rot_delta = torch.zeros_like(trans_delta)
    return se3_delta_to_matrix(trans_delta, rot_delta) @ w2c_base


def render_view(params, alive, w2c_base, K4, cfg: RasterizeConfig,
                trans_delta=None, rot_delta=None, bg=None,
                means2d_probe=None, bins=None):
    """Render one view from arena params + camera (+ optional pose deltas).
    Dead arena slots render with zero opacity. ``bins``: cached tile
    binning from ``bin_view``."""
    means_cam, quats_cam = transform_to_frame(
        params, _posed(w2c_base, trans_delta, rot_delta))
    scales, opac, colors = _attrs(params, alive)
    return rasterize_cuda(means_cam, quats_cam, scales, opac, colors, K4,
                          cfg, bg=bg, means2d_probe=means2d_probe, bins=bins)


def render_window(params, alive, w2c_base, K4, cfg: RasterizeConfig,
                  trans_deltas=None, rot_deltas=None, bins=None,
                  means2d_probe=None):
    """Render V views through ONE fused blend (and one backward).
    w2c_base (V, 4, 4); trans/rot_deltas (V, 3) optional. Returns stacked
    (V, H, W, ...) maps. A gradient render on a CUDA device (grad mode on,
    an input requiring a gradient) replays its forward and its backward
    as CUDA graphs (``render_graph``); any other runs eagerly."""
    x = {f"p.{k}": v for k, v in params.items()}
    x.update(alive=alive, w2c=w2c_base, K4=K4, t=trans_deltas, r=rot_deltas,
             probe=means2d_probe)
    x.update((f"bins.{i}", b) for i, b in enumerate(bins or ()))
    x = {k: v for k, v in x.items() if v is not None}
    if w2c_base.is_cuda and torch.is_grad_enabled() \
            and any(v.requires_grad for v in x.values()):
        return render_graph.run(_window, cfg, x)
    return _window(cfg, x)


def _window(cfg: RasterizeConfig, x):
    """``render_window``'s body over its named inputs ``x``."""
    params = {k[2:]: v for k, v in x.items() if k.startswith("p.")}
    bins = tuple(v for k, v in x.items() if k.startswith("bins.")) or None
    means_cam, quats_cam = transform_to_frame(
        params, _posed(x["w2c"], x.get("t"), x.get("r")))
    scales, opac, colors = _attrs(params, x["alive"])
    return rasterize_cuda_multi(means_cam, quats_cam, scales, opac, colors,
                                x["K4"], cfg, bins=bins,
                                means2d_probe=x.get("probe"))


@torch.no_grad()
def bin_view(params, alive, w2c_base, K4, cfg: RasterizeConfig,
             trans_delta=None, rot_delta=None):
    """Tile binning for one view at the current params/pose (integer tile
    lists, no gradient)."""
    means_cam, quats_cam = transform_to_frame(
        params, _posed(w2c_base, trans_delta, rot_delta))
    scales, opac, _ = _attrs(params, alive)
    return compute_bins(means_cam, quats_cam, scales, opac, K4, cfg)


def bin_window(params, alive, w2cs, K4, cfg: RasterizeConfig,
               trans_deltas=None, rot_deltas=None):
    """``bin_view`` of each of V views (w2cs (V, 4, 4), optional (V, 3)
    deltas), stacked into the ``bins`` that ``render_window`` takes."""
    bins = [bin_view(params, alive, w2cs[v], K4, cfg,
                     trans_delta=None if trans_deltas is None
                     else trans_deltas[v],
                     rot_delta=None if rot_deltas is None else rot_deltas[v])
            for v in range(w2cs.shape[0])]
    return (torch.stack([b[0] for b in bins]),
            torch.stack([b[1] for b in bins]))
