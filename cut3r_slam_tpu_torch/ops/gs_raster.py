"""Differentiable 3D-Gaussian-splatting rasterizer (RaDe-GS variant), plain
PyTorch.

Port of ``cut3r_slam_tpu/ops/gs_raster.py``: preprocess (EWA projection
with the RaDe-GS camera/ray planes and per-Gaussian normals), shape-static
tile binning with the fused uint32 tile|depth sort key, and the chunked
front-to-back blend with expected/median depth, coord and normal maps.
``rasterize`` here is the plain oracle (it also returns the coord/mcoord
maps); the mapping path renders through ``ops/gs_raster_cuda.py``, which
shares ``_preprocess`` / ``_bin_gaussians`` / ``_untile`` with it.

Quaternion convention here: **wxyz**.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

__all__ = ["RasterizeConfig", "rasterize", "compute_bins",
           "compute_bin_plan", "quat_wxyz_to_matrix", "median_gate"]

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


def quat_wxyz_to_matrix(q: torch.Tensor) -> torch.Tensor:
    r, x, y, z = q.unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


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
    cam_plane = torch.stack([
        (-(v2 + 1) * tz_safe + plane0 * tx) / nl / fx,
        (uv * tz_safe + plane1 * tx) / nl / fy,
        (uv * tz_safe + plane0 * ty) / nl / fx,
        (-(u2 + 1) * tz_safe + plane1 * ty) / nl / fy,
        (tx + plane0 * tz_safe) / nl / fx,
        (ty + plane1 * tz_safe) / nl / fy,
    ], -1)

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
        "cam_plane": cam_plane, "normal": normal,
        "view_point": torch.stack([tx, ty, tz_safe], -1),
        "valid": valid,
    }


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------

@torch.no_grad()
def _bin_gaussians(pre, cfg: RasterizeConfig, return_inverse: bool = False):
    """Duplicate-sort-range binning with static caps and the fused
    (tile | quantized depth) key. Returns per-tile entry indices
    (n_tiles, max_per_tile) int64 and a validity mask. With
    ``return_inverse`` also the inverse map (P, max_dup) int32: for
    Gaussian p's d-th tile duplicate, the flat position
    ``tile * max_per_tile + k`` it landed at, or -1 where it was culled or
    fell beyond the per-tile cap."""
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
    if not return_inverse:
        return entry_gauss, in_range

    # inverse permutation: pre-sort entry e sits at sorted position pos[e]
    n_e = perm.shape[0]
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(n_e, device=dev)
    starts_pad = torch.cat([starts, starts.new_zeros(1)])
    k_e = pos - starts_pad[tile_flat]
    ok = (tile_flat < cfg.n_tiles) & (k_e >= 0) & (k_e < cfg.max_per_tile)
    inv = torch.where(ok, tile_flat * cfg.max_per_tile + k_e,
                      torch.full_like(k_e, -1))
    return entry_gauss, in_range, inv.to(torch.int32).reshape(P, cfg.max_dup)


@torch.no_grad()
def compute_bins(means_cam, quats_wxyz, scales, opacities, K4,
                 cfg: RasterizeConfig):
    """Tile binning alone, for reuse across an optimization segment.
    Returns (entry_gauss (n_tiles, K) int64, entry_mask (n_tiles, K) bool)."""
    pre = _preprocess(means_cam, quats_wxyz, scales, opacities, K4, cfg)
    return _bin_gaussians(pre, cfg)


@torch.no_grad()
def compute_bin_plan(entry_gauss, entry_mask, n_gauss: int,
                     cfg: RasterizeConfig):
    """The pack backward's segment-reduction plan for one cached binning,
    built once and reused like the bins themselves.

    The pack forward gathers ``raw[entry_gauss]``; its backward reduces
    the entries' gradients onto their Gaussians. A permutation of the flat
    entry positions grouped by Gaussian id, with each Gaussian's segment
    bounds, turns that reduction into a gather and a sum over sorted
    segments. The plan also fixes the occupancy-descending tile order for
    the segment: the order only balances the blend's rows, it does not
    change a result. Sorts are stable, so ties keep the JAX package's
    order. The port's renders read only the order: their pack backward
    (K3, or its plain twin on the CPU) needs no segment plan, so ``perm``
    and ``bounds`` are kept for parity with the JAX package.

    Returns (order, inv_order, perm, bounds):
      order (n_tiles,)      occupancy-descending tile permutation
      inv_order (n_tiles,)  its inverse
      perm (n_tiles * K,)   int32 flat entry positions in the sorted-tile
                            layout, grouped by Gaussian id, masked entries
                            (the sentinel id ``n_gauss``) last
      bounds (n_gauss + 1,) int32 segment bounds into ``perm``
    """
    counts = entry_mask.sum(1)
    order = torch.argsort(-counts, stable=True)
    inv_order = torch.argsort(order, stable=True)
    flat_g = torch.where(entry_mask[order], entry_gauss[order],
                         torch.full_like(entry_gauss, n_gauss)).reshape(-1)
    perm = torch.argsort(flat_g, stable=True)
    bounds = torch.searchsorted(
        flat_g[perm], torch.arange(n_gauss + 1, device=flat_g.device,
                                   dtype=flat_g.dtype))
    return order, inv_order, perm.to(torch.int32), bounds.to(torch.int32)


def check_bins(bins):
    """``bins`` is None, cached (entry_gauss, entry_mask), or those with
    a ``compute_bin_plan`` after them (6 items); anything else raises."""
    if bins is not None and len(bins) not in (2, 6):
        raise ValueError(f"bins: expected (entry_gauss, entry_mask) or those "
                         f"plus (order, inv_order, perm, bounds) from "
                         f"compute_bin_plan, got {len(bins)} items")
    return bins


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
    pix = _pixel_grid(cfg, dev)
    PXT = TILE * TILE

    T = torch.ones(n_tiles, PXT, device=dev)
    wsum = torch.zeros(n_tiles, PXT, device=dev)
    Csum = torch.zeros(n_tiles, PXT, colors.shape[-1], device=dev)
    Dsum = torch.zeros(n_tiles, PXT, device=dev)
    Coordsum = torch.zeros(n_tiles, PXT, 3, device=dev)
    Nsum = torch.zeros(n_tiles, PXT, 3, device=dev)
    mDepth = torch.zeros(n_tiles, PXT, device=dev)
    mCoord = torch.zeros(n_tiles, PXT, 3, device=dev)
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
        camp = pre["cam_plane"][eg]
        norm = pre["normal"][eg]
        vp = pre["view_point"][eg]

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
        coord = torch.stack([
            vp[:, None, :, 0] + camp[:, None, :, 0] * dx + camp[:, None, :, 1] * dy,
            vp[:, None, :, 1] + camp[:, None, :, 2] * dx + camp[:, None, :, 3] * dy,
            vp[:, None, :, 2] + camp[:, None, :, 4] * dx + camp[:, None, :, 5] * dy,
        ], -1)
        Coordsum = Coordsum + torch.einsum("tpc,tpcf->tpf", aT, coord)
        Nsum = Nsum + torch.einsum("tpc,tcf->tpf", aT, norm)

        # median: LAST contribution passing the gate (masked max of iota)
        bm = median_gate(Tb) & contrib
        iota = torch.arange(bm.shape[-1], device=dev).expand_as(bm)
        idx = torch.where(bm, iota, torch.full_like(iota, -1)).max(-1).values
        has = idx >= 0
        idx_c = torch.clamp(idx, min=0)
        md = torch.gather(t_all, -1, idx_c[..., None])[..., 0]
        mc = torch.gather(coord, -2, idx_c[..., None, None].expand(
            *idx_c.shape, 1, 3))[..., 0, :]
        mDepth = torch.where(has, md, mDepth)
        mCoord = torch.where(has[..., None], mc, mCoord)
        anyc = anyc | contrib.any(-1)
        T = T * cum[..., -1]

    return (T, wsum, Csum, Dsum, Coordsum, Nsum, mDepth, mCoord, anyc), pix


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
              means2d_probe: Optional[torch.Tensor] = None,
              bins=None) -> Dict[str, torch.Tensor]:
    """Render one view, plain PyTorch. All Gaussian quantities in CAMERA
    frame: means_cam (P,3); quats_wxyz (P,4); scales (P,3); opacities (P,);
    colors (P,3); K4 = [fx, fy, cx, cy]. Returns H x W maps: color, alpha,
    depth, mdepth, coord, mcoord, normal, plus per-Gaussian radii and
    visibility. ``bins``: cached (entry_gauss, entry_mask), optionally
    followed by their ``compute_bin_plan``, which this blend does not
    need (it fixes only the blend's row order)."""
    dev = means_cam.device
    if bg is None:
        bg = torch.zeros(3, dtype=means_cam.dtype, device=dev)
    check_bins(bins)
    pre = _preprocess(means_cam, quats_wxyz, scales, opacities, K4, cfg)
    if means2d_probe is not None:
        pre["mean2d"] = pre["mean2d"] + means2d_probe
    if bins is None:
        entry_gauss, entry_mask = _bin_gaussians(pre, cfg)
    else:
        entry_gauss, entry_mask = bins[0], bins[1] & pre["valid"][bins[0]]
    carry, _ = _blend_tiles(pre, colors, entry_gauss, entry_mask, cfg)
    (T, wsum, Csum, Dsum, Coordsum, Nsum, mDepth, mCoord, anyc) = carry

    color = _untile(Csum, cfg) + _untile(T, cfg)[..., None] * bg
    alpha = _untile(wsum, cfg)
    anyc2 = _untile(anyc, cfg)
    w_safe = torch.where(anyc2, torch.clamp(alpha, min=1e-12),
                         torch.ones_like(alpha))
    ln = _ray_norm(K4, cfg, dev)
    depth = torch.where(anyc2, _untile(Dsum, cfg) / ln / w_safe,
                        torch.zeros_like(alpha))
    mdepth = _untile(mDepth, cfg) / ln
    coord = torch.where(anyc2[..., None],
                        _untile(Coordsum, cfg) / w_safe[..., None],
                        torch.zeros(3, device=dev))
    mcoord = _untile(mCoord, cfg)
    nsum = _untile(Nsum, cfg)
    nlen = torch.sqrt((nsum * nsum).sum(-1, keepdim=True)
                      + NORMALIZE_EPS ** 2)
    normal = torch.where(anyc2[..., None], nsum / nlen,
                         torch.zeros(3, device=dev))
    return {
        "color": color, "alpha": alpha, "depth": depth, "mdepth": mdepth,
        "coord": coord, "mcoord": mcoord, "normal": normal,
        "radii": pre["radius"],
        "visibility": pre["valid"] & (pre["radius"] > 0),
    }
