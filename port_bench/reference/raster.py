"""The plain rasterizer of the benchmark's reference: a frozen float32 copy
of the port's plain 3D-Gaussian-splatting rasterizer (RaDe-GS variant:
EWA preprocess, capped depth-sorted tile binning, chunked front-to-back
blend), with the world-to-camera posing the mapper renders through
(``render_views``) and the blend-work counter the render rooflines read
(``blend_census``). Plain PyTorch; it imports nothing of the program.

``dtype`` of ``render_views`` is the control's knob: float32 is the
reference, bfloat16 the precision below it (every input and every
intermediate of the render rounded to bfloat16).

Quaternion convention: **wxyz** (the rasterizer's).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

__all__ = ["RasterizeConfig", "rasterize", "render_views", "blend_census",
           "FLOPS_PER_PAIR"]

TILE = 16
ALPHA_MIN = 1.0 / 255.0
# median-depth selection threshold on the pre-blend transmittance, biased
# and quantized exactly like the JAX package (gs_raster.py:45-71) so the
# selection agrees across backends on exact-0.5 ties
MEDIAN_T_THRESH = 0.5 + 1e-4
MEDIAN_T_QUANT = 2.0 ** 12
_MEDIAN_FLOOR = float(torch.floor(torch.tensor(MEDIAN_T_THRESH * MEDIAN_T_QUANT,
                                               dtype=torch.float32)))
T_MIN = 1e-4
NORMALIZE_EPS = 1e-6


def median_gate(Tb: torch.Tensor) -> torch.Tensor:
    """Backend-shared median-selection test on pre-blend transmittance."""
    return torch.floor(Tb * MEDIAN_T_QUANT) > _MEDIAN_FLOOR


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    height: int
    width: int
    max_dup: int = 16          # max tiles one Gaussian may cover
    max_per_tile: int = 512    # nearest entries blended per tile
    chunk: int = 128           # Gaussians per step of the plain blend
    kernel_size: float = 0.1   # low-pass added to cov2D

    @property
    def tiles_x(self):
        return (self.width + TILE - 1) // TILE

    @property
    def tiles_y(self):
        return (self.height + TILE - 1) // TILE

    @property
    def n_tiles(self):
        return self.tiles_x * self.tiles_y


# ---------------------------------------------------------------------------
# preprocess
# ---------------------------------------------------------------------------

def _preprocess(means, quats, scales, opacities, K4, cfg: RasterizeConfig):
    """Per-Gaussian screen-space quantities.

    means (..., P, 3) CAMERA-frame centers; quats (..., P, 4) wxyz;
    scales (P, 3) (already exp'd); opacities (P,); K4 [fx, fy, cx, cy].
    Leading view dims broadcast against the shared attributes.
    """
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    H, W = cfg.height, cfg.width
    tan_fovx = W / (2.0 * fx)
    tan_fovy = H / (2.0 * fy)

    tz = means[..., 2]
    valid = tz > 0.2
    tz_safe = torch.where(valid, tz, torch.ones_like(tz))
    txtz = torch.maximum(torch.minimum(means[..., 0] / tz_safe, 1.3 * tan_fovx),
                         -1.3 * tan_fovx)
    tytz = torch.maximum(torch.minimum(means[..., 1] / tz_safe, 1.3 * tan_fovy),
                         -1.3 * tan_fovy)
    tx = txtz * tz_safe
    ty = tytz * tz_safe

    qr, qx, qy, qz = quats.unbind(-1)
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qr * qz)
    r02 = 2 * (qx * qz + qr * qy)
    r10 = 2 * (qx * qy + qr * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qr * qx)
    r20 = 2 * (qx * qz - qr * qy)
    r21 = 2 * (qy * qz + qr * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    s20 = scales[..., 0] * scales[..., 0]
    s21 = scales[..., 1] * scales[..., 1]
    s22 = scales[..., 2] * scales[..., 2]
    V00 = r00 * r00 * s20 + r01 * r01 * s21 + r02 * r02 * s22
    V01 = r00 * r10 * s20 + r01 * r11 * s21 + r02 * r12 * s22
    V02 = r00 * r20 * s20 + r01 * r21 * s21 + r02 * r22 * s22
    V11 = r10 * r10 * s20 + r11 * r11 * s21 + r12 * r12 * s22
    V12 = r10 * r20 * s20 + r11 * r21 * s21 + r12 * r22 * s22
    V22 = r20 * r20 * s20 + r21 * r21 * s21 + r22 * r22 * s22

    z2 = tz_safe * tz_safe
    j00 = fx / tz_safe
    j02 = -fx * tx / z2
    j11 = fy / tz_safe
    j12 = -fy * ty / z2
    a = j00 * j00 * V00 + 2 * j00 * j02 * V02 + j02 * j02 * V22
    b = (j00 * j11 * V01 + j00 * j12 * V02 + j02 * j11 * V12
         + j02 * j12 * V22)
    c = j11 * j11 * V11 + 2 * j11 * j12 * V12 + j12 * j12 * V22
    det0 = torch.clamp(a * c - b * b, min=1e-6)
    a = a + cfg.kernel_size
    c = c + cfg.kernel_size
    det1 = torch.clamp(a * c - b * b, min=1e-6)
    coef = torch.sqrt(det0 / (det1 + 1e-6) + 1e-6)

    det_inv = 1.0 / det1
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], -1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det1, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    mean2d = torch.stack([fx * txtz + cx, fy * tytz + cy], -1)

    # RaDe-GS planes + normals (ridge-regularized adjugate inverse, see the
    # JAX module for why eigh is avoided)
    tr_inv = 1.0 / torch.clamp(V00 + V11 + V22, min=1e-20)
    w00 = V00 * tr_inv + 1e-6
    w01 = V01 * tr_inv
    w02 = V02 * tr_inv
    w11 = V11 * tr_inv + 1e-6
    w12 = V12 * tr_inv
    w22 = V22 * tr_inv + 1e-6
    A00 = w11 * w22 - w12 * w12
    A01 = w02 * w12 - w01 * w22
    A02 = w01 * w12 - w02 * w11
    A11 = w00 * w22 - w02 * w02
    A12 = w01 * w02 - w00 * w12
    A22 = w00 * w11 - w01 * w01
    det3 = torch.clamp(w00 * A00 + w01 * A01 + w02 * A02, min=1e-12)
    m0 = (A00 * txtz + A01 * tytz + A02) / det3
    m1 = (A01 * txtz + A11 * tytz + A12) / det3
    m2 = (A02 * txtz + A12 * tytz + A22) / det3
    mlen = torch.sqrt(m0 * m0 + m1 * m1 + m2 * m2 + 1e-24)
    mn0, mn1, mn2 = m0 / mlen, m1 / mlen, m2 / mlen

    u2 = txtz * txtz
    v2 = tytz * tytz
    uv = txtz * tytz
    t_norm = torch.sqrt(tx * tx + ty * ty + tz_safe * tz_safe)
    nl = u2 + v2 + 1.0
    vbn = mn0 * txtz + mn1 * tytz + mn2
    plane0 = ((v2 + 1) * mn0 - uv * mn1 - txtz * mn2) \
        / torch.clamp(vbn, min=1e-7)
    plane1 = (-uv * mn0 + (u2 + 1) * mn1 - tytz * mn2) \
        / torch.clamp(vbn, min=1e-7)

    ray_plane = torch.stack([plane0 * t_norm / nl / fx,
                             plane1 * t_norm / nl / fy], -1)

    factor = t_norm / nl
    rn0 = -plane0 * factor
    rn1 = -plane1 * factor
    n_cam = torch.stack([
        rn0 / tz_safe + (-1.0) * tx / t_norm,
        rn1 / tz_safe + (-1.0) * ty / t_norm,
        -(tx * rn0 + ty * rn1) / z2 + (-1.0) * tz_safe / t_norm,
    ], -1)
    normal = n_cam / torch.sqrt((n_cam * n_cam).sum(-1, keepdim=True) + 1e-24)

    # opacity cull: an effective opacity < 1/255 never passes the alpha test
    valid = valid & (det1 > 1e-6) & (opacities * coef >= ALPHA_MIN)
    radius = torch.where(valid, radius, torch.zeros_like(radius))

    return {
        "mean2d": mean2d, "conic": conic, "radius": radius,
        "opacity": opacities * coef, "depth_z": tz,
        "t_center": t_norm, "ray_plane": ray_plane,
        "normal": normal,
        "valid": valid,
    }


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------

@torch.no_grad()
def _bin_gaussians(pre, cfg: RasterizeConfig):
    """Duplicate-sort-range binning with static caps and the fused
    (tile | quantized depth) key. Returns per-tile entry indices
    (n_tiles, max_per_tile) int64 and a validity mask."""
    mean2d = pre["mean2d"].detach()
    radius = pre["radius"].detach()
    valid = pre["valid"]
    dev = mean2d.device
    P = mean2d.shape[0]

    def trunc(v):
        return v.to(torch.int32)

    rect_min_x = trunc((mean2d[:, 0] - radius) / TILE).clamp(0, cfg.tiles_x - 1)
    rect_max_x = trunc(torch.ceil((mean2d[:, 0] + radius + 1) / TILE)
                       ).clamp(1, cfg.tiles_x)
    rect_min_y = trunc((mean2d[:, 1] - radius) / TILE).clamp(0, cfg.tiles_y - 1)
    rect_max_y = trunc(torch.ceil((mean2d[:, 1] + radius + 1) / TILE)
                       ).clamp(1, cfg.tiles_y)
    nx = rect_max_x - rect_min_x
    ny = rect_max_y - rect_min_y
    n_tiles_g = nx * ny
    alive = valid & (radius > 0)

    slot = torch.arange(cfg.max_dup, dtype=torch.int32, device=dev)[None, :]
    nx1 = torch.clamp(nx[:, None], min=1)
    sy = torch.div(slot, nx1, rounding_mode="floor")
    sx = slot - sy * nx1
    tile_id = ((rect_min_y[:, None] + sy) * cfg.tiles_x
               + rect_min_x[:, None] + sx).to(torch.int64)
    entry_ok = (slot < n_tiles_g[:, None]) & alive[:, None]
    tile_id = torch.where(entry_ok, tile_id,
                          torch.full_like(tile_id, cfg.n_tiles))

    depth = pre["depth_z"].detach()[:, None].expand(P, cfg.max_dup)
    tile_flat = tile_id.reshape(-1)
    depth_flat = torch.where(entry_ok.reshape(-1), depth.reshape(-1),
                             torch.full_like(depth.reshape(-1), float("inf")))
    gidx_flat = torch.arange(P, device=dev)[:, None].expand(
        P, cfg.max_dup).reshape(-1)

    # ONE 32-bit key (held in int64): tile id in the high bits, the top
    # bits of the (non-negative) f32 depth pattern in the low bits
    tile_bits = max(cfg.n_tiles.bit_length(), 1)
    depth_bits = 32 - tile_bits
    dbits = torch.clamp(depth_flat.float(), min=0.0).view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF
    key = (tile_flat << depth_bits) | (dbits >> tile_bits)
    key_s, perm = torch.sort(key, stable=True)
    gidx_s = gidx_flat[perm]
    bounds = torch.searchsorted(
        key_s, torch.arange(cfg.n_tiles + 1, device=dev,
                            dtype=torch.int64) << depth_bits)
    starts = bounds[:-1]
    counts = bounds[1:] - starts

    k = torch.arange(cfg.max_per_tile, device=dev)[None, :]
    take = torch.clamp(starts[:, None] + k, 0, gidx_s.shape[0] - 1)
    in_range = k < counts[:, None]
    entry_gauss = torch.where(in_range, gidx_s[take], torch.zeros_like(take))
    return entry_gauss, in_range


# ---------------------------------------------------------------------------
# plain chunked blend (the oracle's)
# ---------------------------------------------------------------------------

def _pixel_grid(cfg: RasterizeConfig, device):
    ty = torch.arange(cfg.tiles_y, device=device)
    tx = torch.arange(cfg.tiles_x, device=device)
    tgy, tgx = torch.meshgrid(ty, tx, indexing="ij")
    base = torch.stack([tgx.reshape(-1) * TILE, tgy.reshape(-1) * TILE], -1)
    oy, ox = torch.meshgrid(torch.arange(TILE, device=device),
                            torch.arange(TILE, device=device), indexing="ij")
    offs = torch.stack([ox.reshape(-1), oy.reshape(-1)], -1)
    return (base[:, None, :] + offs[None, :, :]).float()   # (tiles, 256, 2)


def _blend_tiles(pre, colors, entry_gauss, entry_mask, cfg: RasterizeConfig):
    """Per-tile chunked front-to-back blending (renderCUDA semantics)."""
    n_tiles, K = entry_gauss.shape
    C = min(cfg.chunk, K)
    n_chunks = (K + C - 1) // C
    if n_chunks * C != K:
        pad = n_chunks * C - K
        entry_gauss = torch.nn.functional.pad(entry_gauss, (0, pad))
        entry_mask = torch.nn.functional.pad(entry_mask, (0, pad))
    dev = colors.device
    f = dict(device=dev, dtype=colors.dtype)
    pix = _pixel_grid(cfg, dev).to(colors.dtype)
    PXT = TILE * TILE

    T = torch.ones(n_tiles, PXT, **f)
    wsum = torch.zeros(n_tiles, PXT, **f)
    Csum = torch.zeros(n_tiles, PXT, colors.shape[-1], **f)
    Dsum = torch.zeros(n_tiles, PXT, **f)
    Nsum = torch.zeros(n_tiles, PXT, 3, **f)
    mDepth = torch.zeros(n_tiles, PXT, **f)
    anyc = torch.zeros(n_tiles, PXT, dtype=torch.bool, device=dev)
    done = torch.zeros(n_tiles, PXT, dtype=torch.bool, device=dev)

    for ci in range(n_chunks):
        eg = entry_gauss[:, ci * C:(ci + 1) * C]
        mask = entry_mask[:, ci * C:(ci + 1) * C]
        mean2d = pre["mean2d"][eg]
        conic = pre["conic"][eg]
        opac = pre["opacity"][eg]
        color = colors[eg]
        tc = pre["t_center"][eg]
        rayp = pre["ray_plane"][eg]
        norm = pre["normal"][eg]

        d = mean2d[:, None, :, :] - pix[:, :, None, :]   # (t, px, C, 2)
        dx = d[..., 0]
        dy = d[..., 1]
        power = (-0.5 * (conic[:, None, :, 0] * dx * dx
                         + conic[:, None, :, 2] * dy * dy)
                 - conic[:, None, :, 1] * dx * dy)
        alpha = torch.clamp(opac[:, None, :] * torch.exp(power), max=0.99)
        ok = (power <= 0) & (alpha >= ALPHA_MIN) & mask[:, None, :] \
            & ~done[..., None]
        alpha = torch.where(ok, alpha, torch.zeros_like(alpha))

        one_m = 1.0 - alpha
        cum = torch.cumprod(one_m, -1)
        Tb = T[..., None] * torch.cat([torch.ones_like(cum[..., :1]),
                                       cum[..., :-1]], -1)
        keep = torch.cumprod((Tb * one_m >= T_MIN).to(alpha.dtype), -1)
        done = done | (keep[..., -1] < 0.5)
        alpha = alpha * keep
        one_m = 1.0 - alpha
        cum = torch.cumprod(one_m, -1)
        Tb = T[..., None] * torch.cat([torch.ones_like(cum[..., :1]),
                                       cum[..., :-1]], -1)
        aT = alpha * Tb

        contrib = aT > 0
        Csum = Csum + torch.einsum("tpc,tcf->tpf", aT, color)
        wsum = wsum + aT.sum(-1)
        t_all = (tc[:, None, :] + rayp[:, None, :, 0] * dx
                 + rayp[:, None, :, 1] * dy)
        Dsum = Dsum + (aT * t_all).sum(-1)
        Nsum = Nsum + torch.einsum("tpc,tcf->tpf", aT, norm)

        # median: LAST contribution passing the gate (masked max of iota)
        bm = median_gate(Tb) & contrib
        iota = torch.arange(bm.shape[-1], device=dev).expand_as(bm)
        idx = torch.where(bm, iota, torch.full_like(iota, -1)).max(-1).values
        has = idx >= 0
        idx_c = torch.clamp(idx, min=0)
        md = torch.gather(t_all, -1, idx_c[..., None])[..., 0]
        mDepth = torch.where(has, md, mDepth)
        anyc = anyc | contrib.any(-1)
        T = T * cum[..., -1]

    return (T, wsum, Csum, Dsum, Nsum, mDepth, anyc), pix


def _untile(x: torch.Tensor, cfg: RasterizeConfig) -> torch.Tensor:
    """(n_tiles, 256, ...) -> (H, W, ...) cropping the padded border."""
    trail = tuple(x.shape[2:])
    x = x.reshape((cfg.tiles_y, cfg.tiles_x, TILE, TILE) + trail)
    x = x.transpose(1, 2).reshape(
        (cfg.tiles_y * TILE, cfg.tiles_x * TILE) + trail)
    return x[: cfg.height, : cfg.width]


def _ray_norm(K4, cfg: RasterizeConfig, device):
    """Per-pixel ray norm (renderCUDA: W/2, H/2 centers)."""
    yy, xx = torch.meshgrid(
        torch.arange(cfg.height, dtype=torch.float32, device=device),
        torch.arange(cfg.width, dtype=torch.float32, device=device),
        indexing="ij")
    pnx = (xx - cfg.width / 2.0) / K4[0]
    pny = (yy - cfg.height / 2.0) / K4[1]
    return torch.sqrt(pnx * pnx + pny * pny + 1.0)


def rasterize(means_cam, quats_wxyz, scales, opacities, colors, K4,
              cfg: RasterizeConfig, bg: Optional[torch.Tensor] = None,
              bin_from=None) -> Dict[str, torch.Tensor]:
    """Render one view, plain PyTorch. All Gaussian quantities in CAMERA
    frame: means_cam (P,3); quats_wxyz (P,4); scales (P,3); opacities (P,);
    colors (P,3); K4 = [fx, fy, cx, cy]. Returns H x W maps: color, alpha,
    depth, mdepth, normal, and the (P,) visibility (valid, radius > 0).
    ``bin_from``: (means, quats, scales,
    opacities) in the camera frame to bin at, in place of these (a
    binning made earlier and reused, as the mapper reuses one for a
    segment of steps)."""
    dev = means_cam.device
    if bg is None:
        bg = torch.zeros(3, dtype=means_cam.dtype, device=dev)
    pre = _preprocess(means_cam, quats_wxyz, scales, opacities, K4, cfg)
    if bin_from is None:
        entry_gauss, entry_mask = _bin_gaussians(pre, cfg)
    else:
        entry_gauss, entry_mask = _bin_gaussians(
            _preprocess(*bin_from, K4, cfg), cfg)
        entry_mask = entry_mask & pre["valid"][entry_gauss]
    carry, _ = _blend_tiles(pre, colors, entry_gauss, entry_mask, cfg)
    (T, wsum, Csum, Dsum, Nsum, mDepth, anyc) = carry

    color = _untile(Csum, cfg) + _untile(T, cfg)[..., None] * bg
    alpha = _untile(wsum, cfg)
    anyc2 = _untile(anyc, cfg)
    w_safe = torch.where(anyc2, torch.clamp(alpha, min=1e-12),
                         torch.ones_like(alpha))
    ln = _ray_norm(K4, cfg, dev).to(alpha.dtype)
    depth = torch.where(anyc2, _untile(Dsum, cfg) / ln / w_safe,
                        torch.zeros_like(alpha))
    mdepth = _untile(mDepth, cfg) / ln
    nsum = _untile(Nsum, cfg)
    nlen = torch.sqrt((nsum * nsum).sum(-1, keepdim=True)
                      + NORMALIZE_EPS ** 2)
    normal = torch.where(anyc2[..., None], nsum / nlen,
                         torch.zeros(3, device=dev, dtype=nsum.dtype))
    return {"color": color, "alpha": alpha, "depth": depth,
            "mdepth": mdepth, "normal": normal,
            "visibility": pre["valid"] & (pre["radius"] > 0)}


# ---------------------------------------------------------------------------
# posing: arena params + world-to-camera (+ pose deltas) -> camera frame
# ---------------------------------------------------------------------------

SH_C0 = 0.28209479177387814
_SMALL = 1e-8


def _safe_div(num, den, eps=1e-12):
    small = torch.abs(den) < eps
    return num / torch.where(small, torch.where(den < 0, -eps, eps)
                             .to(den.dtype), den)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _quat_xyzw_to_matrix(q):
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True) + 1e-24)
    x, y, z, w = q.unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def se3_delta_to_matrix(trans, rot):
    """SE(3) exp of [tau, phi] as (..., 4, 4) (the mapper's pose delta)."""
    theta_sq = (rot * rot).sum(-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-24))
    small = theta_sq < _SMALL
    k = torch.where(small, 0.5 - theta_sq / 48.0,
                    _safe_div(torch.sin(0.5 * theta), theta))
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(0.5 * theta))
    q = torch.cat([rot * k, w], -1)
    a = torch.where(small, 0.5 - theta_sq / 24.0,
                    _safe_div(1.0 - torch.cos(theta), theta_sq))
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    _safe_div(theta - torch.sin(theta), theta_sq * theta))
    c1 = _cross(rot, trans)
    c2 = _cross(rot, c1)
    t = trans + a * c1 + b * c2
    top = torch.cat([_quat_xyzw_to_matrix(q), t[..., None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=t.dtype,
                          device=t.device).expand(t.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], -2)


def _matrix_to_quat_wxyz(m):
    """Rotation matrix -> unit quaternion wxyz with w >= 0 (Shepperd)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qs = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    branch = torch.argmax(qs, -1)

    def _safe(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    s0 = _safe(1.0 + tr) * 2.0
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0, 0.25 * s0], -1)
    s1 = _safe(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1,
                      (m21 - m12) / s1], -1)
    s2 = _safe(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2,
                      (m02 - m20) / s2], -1)
    s3 = _safe(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3,
                      (m10 - m01) / s3], -1)
    qcand = torch.stack([q0, q1, q2, q3], -2)
    onehot = torch.nn.functional.one_hot(branch, 4).to(m.dtype)[..., None]
    q = (qcand * onehot).sum(-2)
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True) + 1e-24)
    q = torch.where(q[..., 3:4] < 0, -q, q)
    return torch.cat([q[..., 3:4], q[..., 0:3]], -1)


def _quat_mult_wxyz(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def camera_frame(params, alive, w2c, trans_delta=None, rot_delta=None):
    """One view's camera-frame Gaussians from arena ``params`` (xyz,
    f_dc, opacity_logit, log_scales, quat wxyz), ``alive`` and a 4x4
    world-to-camera pose, optionally moved by an SE(3) delta: (means,
    quats wxyz, scales, opacities, colours)."""
    if trans_delta is not None or rot_delta is not None:
        if trans_delta is None:
            trans_delta = torch.zeros_like(rot_delta)
        if rot_delta is None:
            rot_delta = torch.zeros_like(trans_delta)
        w2c = se3_delta_to_matrix(trans_delta, rot_delta) @ w2c
    R, t = w2c[:3, :3], w2c[:3, 3]
    means = params["xyz"] @ R.transpose(-1, -2) + t
    q = params["quat"]
    quat_n = q / torch.sqrt((q * q).sum(-1, keepdim=True) + 1e-24)
    quats = _quat_mult_wxyz(_matrix_to_quat_wxyz(R)[None], quat_n)
    opac = torch.sigmoid(params["opacity_logit"]) * alive.to(means.dtype)
    colors = torch.clamp(params["f_dc"] * SH_C0 + 0.5, min=0.0)
    return means, quats, torch.exp(params["log_scales"]), opac, colors


def render_views(params, alive, w2cs, K4, cfg: RasterizeConfig,
                 trans_deltas=None, rot_deltas=None, dtype=torch.float32,
                 bins_from=None):
    """The V views of ``w2cs`` (V, 4, 4), one after another, as the
    mapper's fused ``render_window`` renders them: stacked (V, H, W, ...)
    colour, alpha, depth, mdepth, normal, visibility. ``bins_from``: per view None or
    the ``camera_frame`` to bin at. ``dtype`` rounds the inputs (the
    control); the plain code then computes in it wherever it follows its
    inputs' type."""
    def cast(x):
        return None if x is None else x.to(dtype)

    p = {k: cast(v) for k, v in params.items()}
    outs = []
    for v in range(w2cs.shape[0]):
        td = None if trans_deltas is None else cast(trans_deltas[v])
        rd = None if rot_deltas is None else cast(rot_deltas[v])
        cam = camera_frame(p, alive, cast(w2cs[v]), td, rd)
        bf = None if bins_from is None or bins_from[v] is None \
            else tuple(cast(x) for x in bins_from[v][:4])
        outs.append(rasterize(*cam, cast(K4), cfg, bin_from=bf))
    return {k: torch.stack([o[k] for o in outs]).float() for k in outs[0]}


# ---------------------------------------------------------------------------
# blend work: the (entry, pixel) pairs composited front to back
# ---------------------------------------------------------------------------

# FP32 operations per (entry, pixel) pair, as (rejected, stopping,
# blended): counted from the kernel bodies of the port's tile blend, its
# forward and its backward (the arithmetic, not the implementation: a
# pair is rejected by the alpha test, stops the pixel, or is blended)
FLOPS_PER_PAIR = {"forward": (13, 16, 43), "backward": (13, 16, 85)}


@torch.no_grad()
def blend_census(means_cam, quats_wxyz, scales, opacities, K4,
                 cfg: RasterizeConfig):
    """(rejected, stopping, blended) pairs of one view: each 16x16 tile's
    depth-sorted entries (capped at ``max_per_tile``) visited front to
    back per pixel until the transmittance falls under ``T_MIN``. A pair
    is rejected when its alpha fails the test, stopping when it would
    take the pixel under the threshold, blended otherwise."""
    pre = _preprocess(means_cam, quats_wxyz, scales, opacities, K4, cfg)
    entry_gauss, entry_mask = _bin_gaussians(pre, cfg)
    n_tiles, K = entry_gauss.shape
    C = min(cfg.chunk, K)
    pix = _pixel_grid(cfg, means_cam.device)
    T = torch.ones(n_tiles, TILE * TILE, device=means_cam.device)
    done = torch.zeros_like(T, dtype=torch.bool)
    counts = torch.zeros(3, dtype=torch.int64, device=means_cam.device)
    for c0 in range(0, K, C):
        eg = entry_gauss[:, c0:c0 + C]
        mask = entry_mask[:, c0:c0 + C]
        d = pre["mean2d"][eg][:, None] - pix[:, :, None]
        conic = pre["conic"][eg]
        power = (-0.5 * (conic[:, None, :, 0] * d[..., 0] ** 2
                         + conic[:, None, :, 2] * d[..., 1] ** 2)
                 - conic[:, None, :, 1] * d[..., 0] * d[..., 1])
        alpha = torch.clamp(pre["opacity"][eg][:, None] * torch.exp(power),
                            max=0.99)
        live = mask[:, None, :] & ~done[..., None]
        ok = (power <= 0) & (alpha >= ALPHA_MIN) & live
        one_m = torch.where(ok, 1.0 - alpha, torch.ones_like(alpha))
        cum = torch.cumprod(one_m, -1)
        Tb = T[..., None] * torch.cat([torch.ones_like(cum[..., :1]),
                                       cum[..., :-1]], -1)
        keep = torch.cumprod((Tb * one_m >= T_MIN).to(torch.int32), -1) > 0
        before = torch.cat([torch.ones_like(keep[..., :1]), keep[..., :-1]],
                           -1)
        visited = live & before
        counts[0] += (visited & ~ok).sum()
        counts[1] += (visited & ok & ~keep).sum()
        counts[2] += (visited & ok & keep).sum()
        done = done | ~keep[..., -1]
        T = T * torch.where(keep, one_m, torch.ones_like(one_m)).prod(-1)
    return [int(n) for n in counts]
