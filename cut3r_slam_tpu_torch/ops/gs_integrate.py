"""Gaussian-to-point integration and frustum visibility (port of
``cut3r_slam_tpu/ops/gs_integrate.py``, plain PyTorch: the JAX module is
XLA, not a Pallas kernel).

* ``mark_visible``: the near-plane test of the reference rasterizer's
  ``markVisible``.
* ``integrate_points``: accumulated Gaussian opacity, blended colour,
  projected coordinate and median-surface SDF at arbitrary camera-frame
  query points (``integrateCUDA`` semantics), on the rasterizer's own
  preprocess and tile binning (``ops/gs_raster._preprocess`` /
  ``_bin_gaussians``). The per-point contribution test is the sequential
  5-tap recurrence of the JAX module: a tap whose T (1 - alpha) would fall
  below 1e-4 is skipped without updating T, so the depth-sorted entries of
  a tile are walked one after another, vectorized over the points of a
  chunk. Scales enter the ray covariance ridge-clamped, 1 / max(s^2, 1e-8).
"""
from __future__ import annotations

import torch

from .gs_raster import RasterizeConfig, _bin_gaussians, _preprocess

__all__ = ["mark_visible", "integrate_points"]

# 5-tap subpixel offsets of integrateCUDA's contribution test: the pixel
# centre and its four half-pixel corners
_OFF_X = (0.0, -0.5, 0.5, -0.5, 0.5)
_OFF_Y = (0.0, -0.5, -0.5, 0.5, 0.5)


def mark_visible(means_cam: torch.Tensor, near: float = 0.2) -> torch.Tensor:
    """Visibility of camera-frame points: the reference's in_frustum acts
    only on its near-plane test."""
    return means_cam[:, 2] > near


def _inv_ray_cov(quats, scales, txtz, tytz, t_norm, tz, fx, fy):
    """Per-Gaussian inverse ray-space covariance (P, 3, 3):
    S (M Vrk^-1 M^T) S with S = diag(1/fx, 1/fy, 1), Vrk^-1 = R diag(1 /
    max(s^2, 1e-8)) R^T and M the ray-space Jacobian rows."""
    qr, qx, qy, qz = quats.unbind(-1)
    R = torch.stack([
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qr * qz),
        2 * (qx * qz + qr * qy),
        2 * (qx * qy + qr * qz), 1 - 2 * (qx * qx + qz * qz),
        2 * (qy * qz - qr * qx),
        2 * (qx * qz - qr * qy), 2 * (qy * qz + qr * qx),
        1 - 2 * (qx * qx + qy * qy),
    ], -1).reshape(-1, 3, 3)
    inv_s2 = 1.0 / torch.clamp(scales * scales, min=1e-8)
    vrk_inv = torch.einsum("pij,pj,pkj->pik", R, inv_s2, R)

    u, v = txtz, tytz
    ltz = u * u + v * v + 1.0
    zl = tz / ltz
    row0 = torch.stack([v * v + 1.0, -u * v, -u], -1) * zl[:, None]
    row1 = torch.stack([-u * v, u * u + 1.0, -v], -1) * zl[:, None]
    row2 = (torch.stack([u, v, torch.ones_like(u)], -1)
            * (ltz / t_norm)[:, None] * zl[:, None])
    M = torch.stack([row0, row1, row2], -2)
    icr = torch.einsum("pab,pbc,pdc->pad", M, vrk_inv, M)
    s = torch.stack([1.0 / fx, 1.0 / fy, torch.ones_like(fx)]).to(icr.dtype)
    return icr * s[None, :, None] * s[None, None, :]


def _integrate_chunk(pre, icov_ray, condition, colors, entry_gauss,
                     entry_mask, tile, pixf_x, pixf_y, qx, qy, qd, vis, bg):
    """integrateCUDA's per-point loop for one chunk of points (P,):
    returns (alpha (P,), colour (P, 3), sdf (P,))."""
    idx = entry_gauss[tile]                                  # (P, K)
    ok = entry_mask[tile] & pre["valid"][idx] & vis[:, None]
    xy = pre["mean2d"][idx]                                  # (P, K, 2)
    con = pre["conic"][idx]
    op = pre["opacity"][idx]
    dist_c = pre["t_center"][idx]
    plane = pre["ray_plane"][idx]
    col = colors[idx]
    cond = condition[idx]
    dt, dev = xy.dtype, xy.device
    P, K = idx.shape

    off_x = torch.tensor(_OFF_X, dtype=dt, device=dev)
    off_y = torch.tensor(_OFF_Y, dtype=dt, device=dev)
    dx5 = xy[..., 0:1] - (pixf_x[:, None] + off_x)[:, None, :]   # (P, K, 5)
    dy5 = xy[..., 1:2] - (pixf_y[:, None] + off_y)[:, None, :]
    power5 = (-0.5 * (con[..., 0:1] * dx5 * dx5 + con[..., 2:3] * dy5 * dy5)
              - con[..., 1:2] * dx5 * dy5)
    alpha5 = torch.clamp(op[..., None] * torch.exp(power5), max=0.99)
    hit5 = (power5 <= 0.0) & (alpha5 >= 1.0 / 255.0) & ok[..., None]

    # the contribution test, entry by entry in depth order
    T5 = torch.ones(P, 5, dtype=dt, device=dev)
    C3 = torch.zeros(P, 3, dtype=dt, device=dev)
    mid = torch.zeros(P, 5, dtype=dt, device=dev)   # dist, pl0, pl1, x, y
    has_mid = torch.zeros(P, dtype=torch.bool, device=dev)
    mid_src = torch.cat([dist_c[..., None], plane, xy], -1)      # (P, K, 5)
    contributes = torch.zeros(P, K, dtype=torch.bool, device=dev)
    for k in range(K):
        a5 = alpha5[:, k]
        test5 = T5 * (1.0 - a5)
        pass5 = hit5[:, k] & (test5 >= 1e-4)
        hit_c = pass5[:, 0]
        C3 = C3 + torch.where(hit_c, a5[:, 0] * T5[:, 0],
                              torch.zeros_like(T5[:, 0]))[:, None] * col[:, k]
        take_mid = hit_c & (T5[:, 0] > 0.5 + 1e-6)
        mid = torch.where(take_mid[:, None], mid_src[:, k], mid)
        has_mid |= take_mid
        T5 = torch.where(pass5, test5, T5)
        contributes[:, k] = pass5.any(-1)
    T_final = T5[:, 0]

    # the per-point 3D alpha over the contributors
    dxp = xy[..., 0] - qx[:, None]
    dyp = xy[..., 1] - qy[:, None]
    g_depth = dist_c + plane[..., 0] * dxp + plane[..., 1] * dyp
    dz = dist_c - torch.minimum(qd[:, None], g_depth)
    dzk = torch.where(cond, dz, dist_c)
    d3 = torch.stack([dxp, dyp, dzk], -1)                       # (P, K, 3)
    powp = -0.5 * torch.einsum("pka,pkab,pkb->pk", d3, icov_ray[idx], d3)
    alphap = torch.clamp(op * torch.exp(powp), max=0.99)
    alphap = torch.where(cond | (qd[:, None] >= g_depth), alphap,
                         torch.zeros_like(alphap))
    usep = contributes & (alphap >= 1.0 / 255.0)
    a_p = torch.where(usep, alphap, torch.zeros_like(alphap))
    logT = torch.cumsum(torch.log1p(-torch.clamp(a_p, max=0.999)), -1)
    Tp_before = torch.exp(torch.cat([torch.zeros_like(logT[:, :1]),
                                     logT[:, :-1]], -1))
    alpha_int = (a_p * Tp_before).sum(-1)

    # SDF: the median-surface plane at the point's projection
    mid_depth = (mid[:, 0] + mid[:, 1] * (mid[:, 3] - qx)
                 + mid[:, 2] * (mid[:, 4] - qy))
    zero = torch.zeros_like(qd)
    sdf = torch.where(has_mid & vis & (qd > 0), mid_depth - qd, zero)
    color_int = torch.where(vis[:, None], C3 + T_final[:, None] * bg,
                            torch.zeros_like(C3))
    return torch.where(vis, alpha_int, zero), color_int, sdf


@torch.no_grad()
def integrate_points(points_cam, means_cam, quats_wxyz, scales, opacities,
                     colors, K4, cfg: RasterizeConfig, bg=None,
                     point_chunk: int = 4096):
    """Integrate Gaussians onto query points (integrateCUDA semantics).

    points_cam (N, 3) camera frame; the Gaussians as ``gs_raster``'s
    ``rasterize`` takes them (camera frame, wxyz quaternions, exp'd
    scales); K4 = [fx, fy, cx, cy]; bg (3,) (zeros by default);
    ``point_chunk`` points per vectorized pass (a memory knob only).
    Returns a dict: alpha_integrated (N,), color_integrated (N, 3),
    point_coordinate (N, 2), point_sdf (N,), visible (N,)."""
    dev, dt = points_cam.device, points_cam.dtype
    if bg is None:
        bg = torch.zeros(3, dtype=dt, device=dev)
    K4 = torch.as_tensor(K4, dtype=dt, device=dev)
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    H, W = cfg.height, cfg.width

    pre = _preprocess(means_cam, quats_wxyz, scales, opacities, K4, cfg)
    entry_gauss, entry_mask = _bin_gaussians(pre, cfg)
    tz = torch.clamp(means_cam[:, 2], min=1e-7)
    icov_ray = _inv_ray_cov(quats_wxyz, scales, means_cam[:, 0] / tz,
                            means_cam[:, 1] / tz, pre["t_center"], tz, fx, fy)
    condition = (scales * scales).min(-1).values > 1e-8

    pz = points_cam[:, 2]
    pz_safe = torch.where(pz > 0.2, pz, torch.ones_like(pz))
    px = fx * points_cam[:, 0] / (pz_safe + 1e-7) + cx
    py = fy * points_cam[:, 1] / (pz_safe + 1e-7) + cy
    p_depth = torch.sqrt((points_cam * points_cam).sum(-1))
    visible = (pz > 0.2) & (px >= 0) & (px < W) & (py >= 0) & (py < H)
    pix_ix = torch.clamp(px.to(torch.int32), 0, W - 1)
    pix_iy = torch.clamp(py.to(torch.int32), 0, H - 1)
    tile_of_pt = ((pix_iy // 16) * cfg.tiles_x + pix_ix // 16).long()
    pixf_x = pix_ix.to(dt) + 0.5
    pixf_y = pix_iy.to(dt) + 0.5

    outs = []
    for s in range(0, points_cam.shape[0], point_chunk):
        sl = slice(s, s + point_chunk)
        outs.append(_integrate_chunk(
            pre, icov_ray, condition, colors, entry_gauss, entry_mask,
            tile_of_pt[sl], pixf_x[sl], pixf_y[sl], px[sl], py[sl],
            p_depth[sl], visible[sl], bg))
    if outs:
        alpha_i, color_i, sdf = (torch.cat(x) for x in zip(*outs))
    else:
        alpha_i = sdf = points_cam.new_zeros(0)
        color_i = points_cam.new_zeros(0, 3)
    return {"alpha_integrated": alpha_i, "color_integrated": color_i,
            "point_coordinate": torch.stack([px, py], -1),
            "point_sdf": sdf, "visible": visible}
