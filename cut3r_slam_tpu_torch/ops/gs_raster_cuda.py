"""Tile-blend forward/backward kernels (CUDA, sm_90a) and the differentiable
render entries built on them.

Port of ``cut3r_slam_tpu/ops/gs_raster_pallas.py``. The per-(entry, pixel)
Gaussian exponent and ray depth are polynomials in tile-local pixel
coordinates, so each tile entry is packed into 16 floats (``_assemble_A``:
rgb, normal, weight-one, q0..q5, t0..t2; log-opacity and the entry mask are
folded into q0). The blend over the packed entries is:

* K1 ``blend_forward`` -> ``csrc/gs_blend_fwd.cu`` (replaces
  ``_blend_fwd_kernel``), optionally saving each 32-entry chunk's inbound
  transmittance ``tchk`` for the backward;
* K2 ``blend_backward`` -> ``csrc/gs_blend_bwd.cu`` (replaces
  ``_blend_bwd_kernel``), one reverse pass from the saved ``tchk``;
* K3 ``pack_backward`` -> ``csrc/gs_pack_bwd.cu``, the backward of the
  pack gather ``raw[entry_gauss]``: each Gaussian row's sum over its
  masked-in entries, in ascending entry order (bitwise torch's
  stable-sorted indexing backward, without its serial walk over the
  masked slots, which all point at a view's Gaussian 0).

Each wrapper launches its kernel for CUDA tensors (or raises) and counts
the launch in ``LAUNCHES``; for CPU tensors it runs the plain PyTorch
version beside it (``blend_forward_plain`` / ``blend_backward_plain``, the
autograd VJP of the plain forward; ``pack_backward_plain``). ``_BlendFn``
is the autograd Function over K1 / K2, ``_PackGatherFn`` the pack gather
with K3 as its backward. Everything else around the blend (preprocess,
binning, the occupancy sort, the pack gather's forward and the
image-space maps) is plain PyTorch on either device. Every gradient
render's pack gather takes ``_PackGatherFn``: its backward is K3 on the
card and its plain twin on the CPU.

Divergences from the Pallas kernel, both towards ``ops/gs_raster.rasterize``
semantics: a pixel that stops at T_MIN stays stopped for the rest of the
row (the Pallas forward re-tests the stop per chunk), and a row is blended
up to its last masked-in entry (the Pallas loop bound is the entry count,
which a cached binning with holes can undercut).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..utils.profiling import count, span
from .gs_raster import (RasterizeConfig, TILE, ALPHA_MIN, T_MIN,
                        NORMALIZE_EPS, median_gate, _preprocess,
                        _bin_gaussians, _untile, _ray_norm, check_bins)

__all__ = ["rasterize_cuda", "rasterize_cuda_forward", "rasterize_cuda_multi",
           "blend_forward", "blend_backward", "blend_forward_plain",
           "blend_backward_plain", "pack_backward", "pack_backward_plain",
           "packed_entries", "LAUNCHES", "CHUNK"]

PX = TILE * TILE   # 256 pixels per tile
NCH = 16           # packed entry channels
NOUT = 8           # accumulated channels (rows 0..7 of an entry)
CHUNK = 32         # entries per chunk (csrc/gs_blend_common.cuh CHUNK)

# kernel launch counts, incremented only where a kernel is launched
LAUNCHES = {"gs_blend_fwd": 0, "gs_blend_bwd": 0, "gs_pack_bwd": 0}


def _n_chunks(K: int) -> int:
    return max(1, -(-K // CHUNK))


def _pixel_xy(device):
    p = torch.arange(PX, device=device)
    return (p % TILE).float(), torch.div(p, TILE, rounding_mode="floor").float()


def _check(name, t, dtype, ndim, device="cuda"):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous() \
            or t.device.type != device:
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"{device.upper()} tensor, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


def _check_aligned(name, t):
    """The kernels stage packed entries with 16-byte asynchronous copies."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned (a view at "
                         f"storage offset {t.storage_offset()})")


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# K1: forward
# ---------------------------------------------------------------------------

def blend_forward_plain(A, extent, with_residuals: bool = False):
    """Plain PyTorch K1 on packed entries A (R, K, 16), extent (R,).
    Differentiable in A. Returns O (R, 256, 8), dsum, mdep, tleft (R, 256)
    and, with residuals, tchk (R, nC, 256)."""
    R, K, _ = A.shape
    dev = A.device
    x, y = _pixel_xy(dev)
    xx, yy, xy = x * x, y * y, x * y
    T = torch.ones(R, PX, device=dev)
    done = torch.zeros(R, PX, dtype=torch.bool, device=dev)
    O = torch.zeros(R, PX, NOUT, device=dev)
    dsum = torch.zeros(R, PX, device=dev)
    mdep = torch.zeros(R, PX, device=dev)
    nC = _n_chunks(K)
    tchks = []
    kmax = int(extent.max()) if R else 0
    for c in range(nC):
        base = c * CHUNK
        if base >= kmax:
            tchks.append(torch.zeros(R, PX, device=dev))
            continue
        unreached = done | (extent[:, None] <= base)
        tchks.append(torch.where(unreached, torch.zeros_like(T), T).detach())
        Ac = A[:, base:base + CHUNK]                           # (R, C, 16)
        C = Ac.shape[1]
        inside = (base + torch.arange(C, device=dev))[None, :] \
            < extent[:, None]                                  # (R, C)
        q = [Ac[..., 7 + k, None] for k in range(6)]            # (R, C, 1)
        power = q[0] + q[1] * x + q[2] * y + q[3] * xx + q[4] * yy + q[5] * xy
        t_all = Ac[..., 13, None] + Ac[..., 14, None] * x + Ac[..., 15, None] * y
        alpha_raw = torch.exp(power)
        alpha_c = torch.clamp(alpha_raw, max=0.99)
        ok = (alpha_c >= ALPHA_MIN) & inside[..., None]
        alpha0 = torch.where(ok, alpha_c, torch.zeros_like(alpha_c))
        one_m0 = 1.0 - alpha0
        inc0 = torch.cumprod(one_m0, 1)                         # (R, C, PX)
        keepb = (T[:, None] * inc0 >= T_MIN) & ~done[:, None]
        keep = keepb.to(A.dtype)
        alpha = alpha0 * keep
        Tb = T[:, None] * inc0 / one_m0                         # strict prefix
        aT = alpha * Tb
        O = O + torch.einsum("rcp,rck->rpk", aT, Ac[..., :NOUT])
        dsum = dsum + (aT * t_all).sum(1)
        bm = median_gate(Tb) & (aT > 0)
        iota = torch.arange(C, device=dev)[None, :, None].expand_as(bm)
        idx = torch.where(bm, iota, torch.full_like(iota, -1)).max(1).values
        take = torch.gather(t_all, 1, idx.clamp(min=0)[:, None])[:, 0]
        mdep = torch.where(idx >= 0, take, mdep)
        stop = (T[:, None] * inc0)[:, -1] < T_MIN   # inc0 is nonincreasing
        T = T * torch.where(keepb, inc0, torch.ones_like(inc0)).min(1).values
        done = done | stop
    outs = (O, dsum, mdep, T)
    if with_residuals:
        return outs, torch.stack(tchks, 1)
    return outs


def blend_forward(A, extent, with_residuals: bool = False):
    """K1 wrapper: the CUDA kernel for CUDA tensors (or raise), the plain
    version for CPU tensors."""
    if A.device.type == "cpu":
        with torch.no_grad():
            return blend_forward_plain(A, extent, with_residuals)
    _check("A", A, torch.float32, 3)
    _check("extent", extent, torch.int32, 1)
    R, K, nch = A.shape
    if nch != NCH or extent.shape[0] != R:
        raise ValueError(f"A {tuple(A.shape)} / extent {tuple(extent.shape)}")
    _check_aligned("A", A)
    from ..kernels import load
    lib = load("gs_blend_fwd")
    nC = _n_chunks(K)
    f32 = dict(dtype=torch.float32, device=A.device)
    O = torch.empty(R, PX, NOUT, **f32)
    dsum = torch.empty(R, PX, **f32)
    mdep = torch.empty(R, PX, **f32)
    tleft = torch.empty(R, PX, **f32)
    tchk = torch.empty(R, nC, PX, **f32) if with_residuals else None
    rc = lib.gs_blend_fwd(A.data_ptr(), extent.data_ptr(), R, K, nC,
                          O.data_ptr(), dsum.data_ptr(), mdep.data_ptr(),
                          tleft.data_ptr(),
                          tchk.data_ptr() if tchk is not None else None,
                          _stream_ptr(A.device))
    LAUNCHES["gs_blend_fwd"] += 1
    if rc != 0:
        raise RuntimeError(f"gs_blend_fwd launch failed: cudaError {rc}")
    outs = (O, dsum, mdep, tleft)
    return (outs, tchk) if with_residuals else outs


# ---------------------------------------------------------------------------
# K2: backward
# ---------------------------------------------------------------------------

def blend_backward_plain(A, extent, gO, gd, gmd, gT):
    """Plain PyTorch K2: the autograd VJP of ``blend_forward_plain`` at
    the given cotangents. Returns dA (R, K, 16)."""
    with torch.enable_grad():
        Ad = A.detach().requires_grad_(True)
        outs = blend_forward_plain(Ad, extent)
        pairs = [(o, g) for o, g in zip(outs, (gO, gd, gmd, gT))
                 if o.requires_grad]       # none when every row is empty
        if not pairs:
            return torch.zeros_like(A)
        (dA,) = torch.autograd.grad([o for o, _ in pairs], (Ad,),
                                    [g for _, g in pairs], allow_unused=True)
    return torch.zeros_like(A) if dA is None else dA


def blend_backward(A, extent, tchk, tleft, gO, gd, gmd, gT):
    """K2 wrapper: the CUDA kernel for CUDA tensors (or raise), the plain
    VJP for CPU tensors."""
    if A.device.type == "cpu":
        return blend_backward_plain(A, extent, gO, gd, gmd, gT)
    for name, t, nd in (("A", A, 3), ("tchk", tchk, 3), ("tleft", tleft, 2),
                        ("gO", gO, 3), ("gd", gd, 2), ("gmd", gmd, 2),
                        ("gT", gT, 2)):
        _check(name, t, torch.float32, nd)
    _check("extent", extent, torch.int32, 1)
    R, K, _ = A.shape
    nC = _n_chunks(K)
    if tchk.shape != (R, nC, PX) or gO.shape != (R, PX, NOUT):
        raise ValueError(f"tchk {tuple(tchk.shape)} / gO {tuple(gO.shape)}")
    _check_aligned("A", A)
    from ..kernels import load
    lib = load("gs_blend_bwd")
    dA = torch.empty_like(A)
    rc = lib.gs_blend_bwd(A.data_ptr(), extent.data_ptr(), R, K, nC,
                          tchk.data_ptr(), tleft.data_ptr(), gO.data_ptr(),
                          gd.data_ptr(), gmd.data_ptr(), gT.data_ptr(),
                          dA.data_ptr(), _stream_ptr(A.device))
    LAUNCHES["gs_blend_bwd"] += 1
    if rc != 0:
        raise RuntimeError(f"gs_blend_bwd launch failed: cudaError {rc}")
    return dA


class _BlendFn(torch.autograd.Function):
    """Differentiable packed blend: K1 forward (with residuals), K2
    backward."""

    @staticmethod
    def forward(ctx, A, extent):
        (O, dsum, mdep, tleft), tchk = blend_forward(A, extent,
                                                     with_residuals=True)
        ctx.save_for_backward(A, extent, tchk, tleft)
        ctx.mark_non_differentiable(extent)
        return O, dsum, mdep, tleft

    @staticmethod
    def backward(ctx, gO, gd, gmd, gT):
        A, extent, tchk, tleft = ctx.saved_tensors
        if gO is None:
            gO = torch.zeros(A.shape[0], PX, NOUT, device=A.device)
        gd, gmd, gT = [torch.zeros_like(tleft) if g is None else g
                       for g in (gd, gmd, gT)]
        with span("raster.blend_bwd"):
            dA = blend_backward(A, extent, tchk, tleft, gO.contiguous(),
                                gd.contiguous(), gmd.contiguous(),
                                gT.contiguous())
        return dA, None


def _blend(A, extent, differentiable: bool):
    if differentiable and A.requires_grad:
        return _BlendFn.apply(A, extent)
    return blend_forward(A, extent)


# ---------------------------------------------------------------------------
# K3: pack-gather backward
# ---------------------------------------------------------------------------

def pack_backward_plain(dG, entry_gauss, entry_mask, n_rows: int):
    """Plain PyTorch K3: dRaw (n_rows, 16), row r the sum of dG (E, 16)
    over the masked-in entries e with entry_gauss[e] == r."""
    return dG.new_zeros(n_rows, dG.shape[1]).index_put_(
        (entry_gauss[entry_mask],), dG[entry_mask], accumulate=True)


def _pack_work_ints(n_rows: int, cap: int) -> int:
    """K3's int32 scratch (csrc/gs_pack_bwd.cu): row counts and row lists
    of ``cap`` slots."""
    return n_rows * (1 + cap)


def pack_backward(dG, entry_gauss, entry_mask, n_rows: int, cap: int):
    """K3 wrapper: dG (E, 16) float32, entry_gauss (E,) int64, entry_mask
    (E,) bool, all on one device; ``cap``: the rows' list capacity (the
    binning's ``max_dup``; a row with more entries is still summed, by a
    scan over every entry). The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; malformed inputs raise on either."""
    dev = dG.device.type
    for name, t, dtype in (("dG", dG, torch.float32),
                           ("entry_gauss", entry_gauss, torch.int64),
                           ("entry_mask", entry_mask, torch.bool)):
        _check(name, t, dtype, 2 if t is dG else 1, dev)
    E = dG.shape[0]
    if dG.shape[1] != NCH or entry_gauss.shape[0] != E \
            or entry_mask.shape[0] != E or E >= 2 ** 31 \
            or not 0 <= n_rows < 2 ** 31 or cap < 1:
        raise ValueError(f"dG {tuple(dG.shape)} / entry_gauss "
                         f"{tuple(entry_gauss.shape)} / entry_mask "
                         f"{tuple(entry_mask.shape)} / n_rows {n_rows} / "
                         f"cap {cap}")
    if dev == "cpu":
        return pack_backward_plain(dG, entry_gauss, entry_mask, n_rows)
    if dev != "cuda":
        raise ValueError(f"dG: expected a CUDA or CPU tensor, got {dG.device}")
    _check_aligned("dG", dG)
    from ..kernels import load
    lib = load("gs_pack_bwd")
    work = torch.empty(_pack_work_ints(n_rows, cap), dtype=torch.int32,
                       device=dG.device)
    dRaw = torch.empty(n_rows, NCH, dtype=torch.float32, device=dG.device)
    rc = lib.gs_pack_bwd(dG.data_ptr(), entry_gauss.data_ptr(),
                         entry_mask.data_ptr(), E, n_rows, cap,
                         work.data_ptr(), dRaw.data_ptr(),
                         _stream_ptr(dG.device))
    LAUNCHES["gs_pack_bwd"] += 1
    if rc != 0:
        raise RuntimeError(f"gs_pack_bwd launch failed: cudaError {rc}")
    return dRaw


class _PackGatherFn(torch.autograd.Function):
    """raw (N, 16) -> raw[entry_gauss] (R, K, 16), whose backward is K3
    over the masked-in entries (entry_mask (R, K)); the masked-out
    entries' cotangents are zero by construction (``_assemble_A`` folds
    -1e30 into their q0, so the blend rejects them). ``cap`` is the
    binning's ``max_dup``: ``_bin_gaussians`` gives a Gaussian at most that
    many slots a view, and cached bins come from it, so every render's
    rows fit K3's lists; only hand-built bins reach its scan past them."""

    @staticmethod
    def forward(ctx, raw, entry_gauss, entry_mask, cap):
        ctx.save_for_backward(entry_gauss, entry_mask)
        ctx.n_rows, ctx.cap = raw.shape[0], cap
        return raw[entry_gauss]

    @staticmethod
    def backward(ctx, dG):
        entry_gauss, entry_mask = ctx.saved_tensors
        with span("raster.pack_bwd"):
            dRaw = pack_backward(dG.reshape(-1, NCH).contiguous(),
                                 entry_gauss.reshape(-1),
                                 entry_mask.reshape(-1), ctx.n_rows,
                                 ctx.cap)
        return dRaw, None, None, None


# ---------------------------------------------------------------------------
# packing + image maps
# ---------------------------------------------------------------------------

def _tile_origins(cfg: RasterizeConfig, device):
    ty = torch.arange(cfg.tiles_y, device=device)
    tx = torch.arange(cfg.tiles_x, device=device)
    tgy, tgx = torch.meshgrid(ty, tx, indexing="ij")
    return (tgx.reshape(-1) * TILE).float(), (tgy.reshape(-1) * TILE).float()


def _build_raw(pre, colors):
    """(..., P, 16) per-Gaussian packed attribute rows (one gather per
    render instead of ~9 narrow ones)."""
    t = pre["t_center"]
    colors = colors.expand(t.shape + (3,))
    return torch.stack([
        pre["mean2d"][..., 0], pre["mean2d"][..., 1],
        pre["conic"][..., 0], pre["conic"][..., 1], pre["conic"][..., 2],
        torch.log(torch.clamp(pre["opacity"], min=1e-30)).expand(t.shape),
        t, pre["ray_plane"][..., 0], pre["ray_plane"][..., 1],
        colors[..., 0], colors[..., 1], colors[..., 2],
        pre["normal"][..., 0], pre["normal"][..., 1], pre["normal"][..., 2],
        torch.zeros_like(t),
    ], -1)


def _assemble_A(G, ox, oy, entry_mask):
    """Packed entries (R, K, 16) from gathered rows G (R, K, 16) and per-row
    tile origins ox/oy (R,)."""
    mx = G[..., 0] - ox[:, None]
    my = G[..., 1] - oy[:, None]
    c0, c1, c2 = G[..., 2], G[..., 3], G[..., 4]
    logopa = G[..., 5]
    tc = G[..., 6]
    rp0, rp1 = G[..., 7], G[..., 8]
    q0 = (-0.5 * (c0 * mx * mx + c2 * my * my) - c1 * mx * my + logopa
          + torch.where(entry_mask, torch.zeros_like(mx),
                        torch.full_like(mx, -1e30)))
    q1 = c0 * mx + c1 * my
    q2 = c2 * my + c1 * mx
    t0 = tc + rp0 * mx + rp1 * my
    return torch.stack([G[..., 9], G[..., 10], G[..., 11],
                        G[..., 12], G[..., 13], G[..., 14],
                        torch.ones_like(q0),
                        q0, q1, q2, -0.5 * c0, -0.5 * c2, -c1,
                        t0, -rp0, -rp1], -1).contiguous()


def _extent(entry_mask):
    """1 + last masked-in entry per row (0 for an empty row), int32."""
    K = entry_mask.shape[1]
    pos = torch.arange(1, K + 1, device=entry_mask.device, dtype=torch.int32)
    return torch.where(entry_mask, pos, torch.zeros_like(pos)).amax(1) \
        .to(torch.int32).contiguous()


def _image_maps(Opx, dsum, mdep, T, bg, K4, cfg: RasterizeConfig):
    """Image-space outputs from untiled accumulators: Opx (n_tiles, 256, 8),
    dsum / mdep / T (n_tiles, 256)."""
    csum = Opx[..., 0:3]
    nsum = Opx[..., 3:6]
    color = _untile(csum, cfg) + _untile(T, cfg)[..., None] * bg
    w = _untile(Opx[..., 6], cfg)
    anyc = w > 0
    w_safe = torch.where(anyc, torch.clamp(w, min=1e-12), torch.ones_like(w))
    ln = _ray_norm(K4, cfg, Opx.device)
    depth = torch.where(anyc, _untile(dsum, cfg) / ln / w_safe,
                        torch.zeros_like(w))
    mdepth = _untile(mdep, cfg) / ln
    nsum_img = _untile(nsum, cfg)
    nlen = torch.sqrt((nsum_img ** 2).sum(-1, keepdim=True)
                      + NORMALIZE_EPS ** 2)
    normal = torch.where(anyc[..., None], nsum_img / nlen,
                         torch.zeros(3, device=Opx.device))
    return {"color": color, "alpha": w, "depth": depth, "mdepth": mdepth,
            "normal": normal}


# ---------------------------------------------------------------------------
# render entries
# ---------------------------------------------------------------------------

def _pack_rows(pre, colors, entry_gauss, entry_mask, order, ox1, oy1,
               max_dup):
    """Gather and pack the occupancy-sorted tile rows of one or more views.
    ``pre`` leaves are (V, P, ...); entry_gauss / entry_mask / order are
    (V, n_tiles, K) / (V, n_tiles); ``max_dup``: the binning's tiles per
    Gaussian (K3's list capacity). Returns (A (V * n_tiles, K, 16),
    extent (V * n_tiles,) int32) in the sorted row order. Counts the
    views as ``render.views.grad`` (``_PackGatherFn``) or
    ``render.views.nograd``."""
    V, P = pre["t_center"].shape[:2]
    nt, K = entry_gauss.shape[1:]
    voff = (torch.arange(V, device=entry_gauss.device) * P)[:, None, None]
    eg_s = torch.gather(entry_gauss, 1, order[..., None].expand(V, nt, K))
    em_s = torch.gather(entry_mask, 1, order[..., None].expand(V, nt, K))
    raw = _build_raw(pre, colors).reshape(V * P, NCH)
    eg_flat = (eg_s + voff).reshape(V * nt, K)
    em_flat = em_s.reshape(V * nt, K)
    if raw.requires_grad:
        count("render.views.grad", V)
        G = _PackGatherFn.apply(raw, eg_flat, em_flat, max_dup)
    else:
        count("render.views.nograd", V)
        G = raw[eg_flat]
    A = _assemble_A(G, ox1[order].reshape(-1), oy1[order].reshape(-1),
                    em_flat)
    return A, _extent(em_flat)


def _prepare(means_cam, quats_wxyz, scales, opacities, colors, K4,
             cfg: RasterizeConfig, means2d_probe, bins):
    """Preprocess, bin (or take cached bins), occupancy-sort and pack V
    views; means_cam (V, P, 3). ``bins``: stacked (V, ...) cached
    (entry_gauss, entry_mask), optionally followed by their
    ``compute_bin_plan`` outputs, whose tile order then replaces the fresh
    occupancy sort. Returns (pre, A, extent, inv_order)."""
    dev = means_cam.device
    V = means_cam.shape[0]
    with span("raster.preprocess"):
        pre = _preprocess(means_cam, quats_wxyz, scales, opacities, K4, cfg)
        if means2d_probe is not None:
            pre["mean2d"] = pre["mean2d"] + means2d_probe
    if bins is None:
        with span("raster.bin"):
            per = [_bin_gaussians({k: v[i] for k, v in pre.items()}, cfg)
                   for i in range(V)]
            entry_gauss = torch.stack([p[0] for p in per])
            entry_mask = torch.stack([p[1] for p in per])
    else:
        entry_gauss, entry_mask = bins[0], bins[1]
        entry_mask = entry_mask & torch.gather(
            pre["valid"], 1, entry_gauss.reshape(V, -1)).reshape(
                entry_gauss.shape)
    if bins is None or len(bins) == 2:
        # occupancy sort per view: busy tiles launch first (load balance
        # only; every row blends independently)
        counts = entry_mask.sum(2)
        order = torch.argsort(-counts, dim=1, stable=True)
        inv_order = torch.argsort(order, dim=1)
    else:
        # the plan's order, fixed at bin time; the fresh validity above
        # still masks entries
        order, inv_order = bins[2].long(), bins[3].long()
    ox1, oy1 = _tile_origins(cfg, dev)
    with span("raster.pack"):
        A, extent = _pack_rows(pre, colors, entry_gauss, entry_mask, order,
                               ox1, oy1, cfg.max_dup)
    return pre, A, extent, inv_order


def packed_entries(means_cam, quats_wxyz, scales, opacities, colors, K4,
                   cfg: RasterizeConfig):
    """The blend kernels' inputs for V views (means_cam (V, P, 3)):
    (A (V * n_tiles, K, 16), extent (V * n_tiles,) int32)."""
    with torch.no_grad():
        _, A, extent, _ = _prepare(means_cam, quats_wxyz, scales, opacities,
                                   colors, K4, cfg, None, None)
    return A, extent


def _rasterize_impl(means_cam, quats_wxyz, scales, opacities, colors, K4,
                    cfg: RasterizeConfig, bg, means2d_probe, bins,
                    differentiable):
    """Shared single/multi-view body; means_cam (V, P, 3)."""
    dev = means_cam.device
    if bg is None:
        bg = torch.zeros(3, dtype=means_cam.dtype, device=dev)
    V = means_cam.shape[0]
    nt = cfg.n_tiles
    pre, A, extent, inv_order = _prepare(
        means_cam, quats_wxyz, scales, opacities, colors, K4, cfg,
        means2d_probe, bins)
    with span("raster.blend"):
        O, dsum, mdep, T = _blend(A, extent, differentiable)
    unperm = (inv_order + (torch.arange(V, device=dev) * nt)[:, None]
              ).reshape(-1)
    O = O[unperm].reshape(V, nt, PX, NOUT)
    dsum = dsum[unperm].reshape(V, nt, PX)
    mdep = mdep[unperm].reshape(V, nt, PX)
    T = T[unperm].reshape(V, nt, PX)
    views = [_image_maps(O[v], dsum[v], mdep[v], T[v], bg, K4, cfg)
             for v in range(V)]
    maps = {k: torch.stack([m[k] for m in views]) for k in views[0]}
    maps["radii"] = pre["radius"]
    maps["visibility"] = pre["valid"] & (pre["radius"] > 0)
    return maps


def _single(maps):
    return {k: v[0] for k, v in maps.items()}


def _batched(bins):
    """One view's cached bins (2 or 6 items, as ``check_bins`` takes
    them) with a leading view axis."""
    check_bins(bins)
    return None if bins is None else tuple(b[None] for b in bins)


def rasterize_cuda(means_cam, quats_wxyz, scales, opacities, colors, K4,
                   cfg: RasterizeConfig, bg=None, means2d_probe=None,
                   bins=None) -> Dict[str, torch.Tensor]:
    """Differentiable one-view render through K1/K2 (plain blend on CPU).
    Outputs color, alpha, depth, mdepth, normal (H, W, ...) and per-Gaussian
    radii / visibility. ``bins``: cached (entry_gauss, entry_mask) from
    ``compute_bins``, optionally followed by their ``compute_bin_plan``
    (order, inv_order, perm, bounds), whose order replaces the occupancy
    sort; ``means2d_probe``: (P, 2) zeros whose gradient is the viewspace
    positional gradient."""
    probe = None if means2d_probe is None else means2d_probe[None]
    b = _batched(bins)
    return _single(_rasterize_impl(
        means_cam[None], quats_wxyz[None], scales, opacities, colors, K4,
        cfg, bg, probe, b, differentiable=True))


def rasterize_cuda_forward(means_cam, quats_wxyz, scales, opacities, colors,
                           K4, cfg: RasterizeConfig, bg=None,
                           bins=None) -> Dict[str, torch.Tensor]:
    """Forward-only one-view render (K1 without residuals); ``bins`` as
    ``rasterize_cuda`` takes them."""
    b = _batched(bins)
    with torch.no_grad():
        return _single(_rasterize_impl(
            means_cam[None], quats_wxyz[None], scales, opacities, colors,
            K4, cfg, bg, None, b, differentiable=False))


def rasterize_cuda_multi(means_cam, quats_wxyz, scales, opacities, colors,
                         K4, cfg: RasterizeConfig, bg=None, bins=None,
                         means2d_probe=None) -> Dict[str, torch.Tensor]:
    """Fused V-view render: ONE K1 (and ONE K2) launch over the V * n_tiles
    tile rows. means_cam (V, P, 3) / quats_wxyz (V, P, 4) per-view camera
    frame; scales / opacities / colors shared. ``bins``: stacked
    (V, n_tiles, K) cached bins, optionally followed by the V views'
    stacked plans; ``means2d_probe``: (V, P, 2). Outputs carry a leading
    V axis."""
    return _rasterize_impl(means_cam, quats_wxyz, scales, opacities, colors,
                           K4, cfg, bg, means2d_probe, check_bins(bins),
                           differentiable=True)
