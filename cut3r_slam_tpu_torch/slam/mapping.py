"""Gaussian mapping backend, per-frame variant (port of the single-device
paths of ``cut3r_slam_tpu/slam/mapping.py``).

Host code orchestrates; every optimization loop is a Python loop over the
same fused renders the JAX package's Pallas side uses on the chip:

* ``pose_refine``: Adam on one view's se3 deltas against cached bins
  re-binned once per ``opt_segment`` iterations; loss
  5·ratio·L1_rgb[alpha>th] + ratio·var(log d − log d_gt) + 0.05·(2−ratio)·‖δ‖²;
  then the gt depth is scale-corrected and unprojected for seeding.
* ``optimization_steps``: the window renders through ONE fused multi-view
  blend per iteration (``render_window``) with bins cached per segment;
  RGB 0.8·L1 + 0.2·(1−SSIM), inverse-depth L1, depth-normal consistency,
  isotropic regularization, per-view exposure; host early stop.
* ``pose_refine_multi``: the same problem for B new keyframes at once:
  each iteration renders all B views through ONE ``render_window`` with
  per-view deltas, the loss is the sum of the per-view terms and Adam runs
  on the stacked (B, 3) deltas (``Mapping.parallel_kf_refine``).
* ``global_ba_steps``: ``gba_views_per_iter`` = k distinct random views per
  solver step (one fused render, one Gaussian Adam step on the batch-mean
  gradient, per-view pose/exposure Adam), in blocks of
  ``gba_resample_every`` = m steps that share one tile binning made at the
  block-start poses, in segments of ``gba_segment`` steps; densification
  stats accumulate and ``densify_and_prune`` runs once, mid-way. The view
  draws and the split noise come from a ``torch.Generator`` unless the
  caller injects them (``view_idx`` / ``split_noise``), as the parity tests
  do with the JAX package's draws.
* ``data_update``: forward renders for the tracker's depth/pose writeback.
* ``gaussian_update``: the loop-closure writeback: set the corrected
  camera poses, rigidly move the Gaussians of every corrected submap
  (``lc_transform``, their Adam moments zeroed), then refine every valid
  camera's pose against the moved map.

Parameters update in place: the hot paths run on live-prefix views of the
arena (``arena[:last_alive_bound]``), so writes reach the full arena
directly. Dead slots' gradients are masked before Adam (``_mask_grads``).
Every render and loss runs under ``full_f32`` (no TF32: the TPU kernels
run their contractions at Precision.HIGHEST).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import full_f32, resolve_device
from ..ops.gs_raster import RasterizeConfig
from ..ops.ssim import ssim
from ..utils.profiling import timed
from ..geometry.lie import se3_matrix
from ..geometry.pointmap import depth_to_normal, depth_to_pointmap
from ..geometry.quaternion import (matrix_to_quat, quat_normalize,
                                   xyzw_to_wxyz)
from .camera import CameraBuffer, se3_delta_to_matrix
from .gaussian_map import (GaussianArena, PARAM_KEYS, seed_from_pointmap,
                           densify_and_prune, last_alive_bound)
from .renderer import render_view, render_window, bin_window, quat_mult_wxyz

__all__ = ["MappingConfig", "MappingBackend"]


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    height: int
    width: int
    capacity: int = 2 ** 18          # Gaussian arena slots
    cam_capacity: int = 512
    window_size: int = 10
    pose_refine_iters: int = 50
    pose_lr: float = 0.0003
    exposure_lr: float = 0.001
    lambda_depth: float = 0.5
    lambda_normal: float = 0.05
    lambda_iso: float = 10.0
    position_lr: float = 0.00016
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.001
    rotation_lr: float = 0.001
    densify_grad_threshold: float = 0.0002
    opacity_threshold: float = 0.005
    gba_segment: int = 50
    opt_segment: int = 10
    window_opt_iters: int = 20
    new_view_opt_iters: int = 50
    gba_per_view: int = 10
    # views rendered per global-BA solver step (1 = one view a step)
    gba_views_per_iter: int = 1
    # global-BA steps per view draw, sharing one tile binning
    gba_resample_every: int = 1
    # refine a submap's new keyframes in one batched problem
    parallel_kf_refine: bool = False
    alpha_th: float = 0.5
    opt_early_stop_rel: float = 0.0
    downsample: int = 2
    max_per_tile: int = 512
    kernel_size: float = 0.1


def _mask_grads(grads: Dict[str, torch.Tensor], alive: torch.Tensor):
    """Zero gradients of dead arena slots (their forward is masked, but the
    preprocess math on zeroed params can produce NaN cotangents)."""
    return {k: torch.where(alive.reshape((-1,) + (1,) * (g.dim() - 1)), g,
                           torch.zeros_like(g)) for k, g in grads.items()}


class Adam:
    """The JAX package's hand-rolled Adam: moments in dicts of tensors, one
    step counter, f32 bias corrections; parameters update in place."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def sliced(self, n: int) -> "Adam":
        """A view of the first ``n`` rows of every moment (shared t is
        written back by the caller through ``self.t``)."""
        out = Adam.__new__(Adam)
        out.m = {k: v[:n] for k, v in self.m.items()}
        out.v = {k: v[:n] for k, v in self.v.items()}
        out.t = self.t
        return out

    @torch.no_grad()
    def step(self, params, grads, lrs, b1=0.9, b2=0.999, eps=1e-8):
        self.t += 1
        t = torch.tensor(float(self.t), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_((1 - b1) * g)
            self.v[k].mul_(b2).add_((1 - b2) * g * g)
            p.sub_(lrs[k] * (self.m[k] / bc1)
                   / (torch.sqrt(self.v[k] / bc2) + eps))

    @torch.no_grad()
    def zero_rows(self, rows: torch.Tensor):
        for d in (self.m, self.v):
            for k, x in d.items():
                x[rows] = 0


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_(True)


class MappingBackend:
    def __init__(self, cfg: MappingConfig, K4: np.ndarray, device="cuda",
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.K4 = torch.as_tensor(np.asarray(K4, np.float32),
                                  device=self.device)
        self.raster_cfg = RasterizeConfig(
            height=cfg.height, width=cfg.width,
            max_per_tile=cfg.max_per_tile, kernel_size=cfg.kernel_size)
        self.rng_seed = int(seed)
        self.timer = None  # optional utils.profiling.StageTimer
        self.reset_state()

    def reset_state(self):
        cfg = self.cfg
        self.arena = GaussianArena.empty(cfg.capacity, self.device)
        self.adam = Adam(self.arena.params())
        self.cams = CameraBuffer.empty(cfg.cam_capacity, cfg.height,
                                       cfg.width, self.device)
        self.current_window: List[int] = []
        self.initialized = False
        self.gba_losses: List[torch.Tensor] = []
        # GBA view choice + split noise (CPU generator: same draws on
        # every device)
        self.gen = torch.Generator().manual_seed(self.rng_seed)

    # ------------------------------------------------------------------
    def _tm(self, stage: str):
        """Stage timer of ``run_steps``' phases, synchronized on exit (a
        null context without ``self.timer``)."""
        return timed(self.timer, stage, self.device)

    def _timed_steps(self, stage: str, gen):
        """Drive a sub-generator one slice at a time, timing each slice
        under ``stage`` but not the time spent outside it between yields
        (the caller may run tracking frames there)."""
        while True:
            with self._tm(stage):
                try:
                    v = next(gen)
                except StopIteration:
                    return
            yield v

    def _lrs(self):
        c = self.cfg
        return {"xyz": c.position_lr, "f_dc": c.feature_lr,
                "opacity_logit": c.opacity_lr, "log_scales": c.scaling_lr,
                "quat": c.rotation_lr}

    def _sliced(self):
        """Views of the arena and its Adam moments up to the last alive
        slot (the JAX package rounds this up to power-of-two buckets to
        bound XLA recompiles; eager PyTorch has no compile cache)."""
        b = max(last_alive_bound(self.arena.alive), 1)
        return self.arena.slice_prefix(b), self.adam.sliced(b)

    def _img(self, idx):
        return self.cams.image[idx].float() / 255.0

    def _depth(self, idx):
        return self.cams.depth[idx].float()

    # ------------------------------------------------------------------
    def add_keyframe(self, idx: int, image_u8, depth, w2c):
        dev = self.device
        self.cams.add(idx, torch.as_tensor(np.asarray(image_u8), device=dev),
                      torch.as_tensor(np.asarray(depth, np.float32),
                                      device=dev),
                      torch.as_tensor(np.asarray(w2c, np.float32),
                                      device=dev))

    def seed(self, idx: int, pointmap, colors, conf_mask,
             submap_idx: int) -> int:
        """extend_from_pcd_seq equivalent for one keyframe."""
        dev = self.device

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), device=dev).to(dtype)
        n, used = seed_from_pointmap(
            self.arena, t(pointmap).reshape(-1, 3), t(colors).reshape(-1, 3),
            t(conf_mask, torch.bool).reshape(-1), submap_idx)
        # new slots start with zero Adam moments
        self.adam.zero_rows(used)
        return n

    # ------------------------------------------------------------------
    # pose refine
    # ------------------------------------------------------------------
    def _pose_losses(self, out, image, depth_gt, dt, dr):
        """Per-view pose-refine losses over a leading view axis: maps
        (V, H, W, ...), deltas (V, 3) -> (V,)."""
        a_th = self.cfg.alpha_th
        img, d, a = out["color"], out["depth"], out["alpha"]
        amask = (a > a_th).detach()
        ratio = amask.flatten(1).float().mean(1)
        rgb_l = torch.abs((image - img) * amask[..., None]).flatten(1).sum(1) \
            / torch.clamp(amask.flatten(1).sum(1) * 3.0, min=1.0)
        dmask = amask & (depth_gt > 1e-3) & (d > 1e-3)
        diff = torch.where(dmask, torch.log(torch.clamp(d, min=1e-6))
                           - torch.log(torch.clamp(depth_gt, min=1e-6)),
                           torch.zeros_like(d))
        n = torch.clamp(dmask.flatten(1).sum(1).float(), min=1.0)
        mean = diff.flatten(1).sum(1) / n
        var = (diff * diff).flatten(1).sum(1) / n - mean * mean
        pose_l = (dr ** 2).sum(-1) + (dt ** 2).sum(-1)
        return 5 * ratio * rgb_l + ratio * var + 0.05 * (2 - ratio) * pose_l

    def pose_refine(self, idx: int):
        """Refine one view's pose; returns the downsampled (pointmap, valid)
        for seeding and writes the refined pose and scaled depth back."""
        pointmaps, valids = self.pose_refine_multi([idx])
        return pointmaps[0], valids[0]

    @full_f32()
    def pose_refine_multi(self, idxs: List[int]):
        """Refine B views' poses (their initial poses already chained, see
        ``run_steps``); returns the downsampled (pointmaps, valids) stacked
        over the views and writes the refined poses and scaled depths
        back. Every iteration renders all B views through one
        ``render_window`` (one K1, one K2) with per-view deltas; the loss
        is the sum of the per-view terms and Adam runs on the stacked
        (B, 3) deltas, so each view's problem stays its own. Bins are
        re-made once per ``opt_segment`` at the current deltas."""
        cfg, K4, rcfg, dev = self.cfg, self.K4, self.raster_cfg, self.device
        ki = torch.as_tensor(idxs, dtype=torch.long, device=dev)
        B = len(idxs)
        images, depth_gts = self._img(ki), self._depth(ki)
        arena_b, _ = self._sliced()
        params, alive = arena_b.params(), arena_b.alive
        w2cs = self.cams.w2c[ki].clone()
        deltas = {"t": torch.zeros(B, 3, device=dev),
                  "r": torch.zeros(B, 3, device=dev)}
        lrs = {"t": cfg.pose_lr * 10, "r": cfg.pose_lr * 2}
        adam = Adam(deltas)
        seg = max(1, min(cfg.opt_segment, cfg.pose_refine_iters))
        n_seg = -(-cfg.pose_refine_iters // seg)
        for _ in range(n_seg):
            bins = bin_window(params, alive, w2cs, K4, rcfg,
                              trans_deltas=deltas["t"],
                              rot_deltas=deltas["r"])
            for _ in range(seg):
                dt, dr = _leaf(deltas["t"]), _leaf(deltas["r"])
                outs = render_window(params, alive, w2cs, K4, rcfg,
                                     trans_deltas=dt, rot_deltas=dr,
                                     bins=bins)
                loss = self._pose_losses(outs, images, depth_gts, dt,
                                         dr).sum()
                gt_, gr_ = torch.autograd.grad(loss, (dt, dr))
                adam.step(deltas, {"t": gt_, "r": gr_}, lrs)
        with torch.no_grad():
            new_w2c = se3_delta_to_matrix(deltas["t"], deltas["r"]) @ w2cs
            outs = render_window(params, alive, new_w2c, K4, rcfg)
            gt_scaled, pointmaps, valids = self._rescale_and_unproject(
                outs, depth_gts, new_w2c)
            self.cams.w2c[ki] = new_w2c
            self.cams.depth[ki] = gt_scaled.to(torch.bfloat16)
        ds = cfg.downsample
        return pointmaps[:, ::ds, ::ds], valids[:, ::ds, ::ds]

    def _rescale_and_unproject(self, out, depth_gt, w2c):
        """Return-args pass of pose refine, per view of the rendered maps
        (V, H, W): scale-corrected gt depth, its world pointmap, and the
        low-alpha validity mask for seeding."""
        a_th = self.cfg.alpha_th
        a, d = out["alpha"], out["depth"]
        amask = (a > a_th) & (depth_gt > 1e-3) & (d > 1e-3)
        ratio = (a > a_th).flatten(1).float().mean(1)
        diff = torch.where(amask, torch.log(torch.clamp(d, min=1e-6))
                           - torch.log(torch.clamp(depth_gt, min=1e-6)),
                           torch.zeros_like(d))
        scale = torch.exp(diff.flatten(1).sum(1) / torch.clamp(
            amask.flatten(1).sum(1).float(), min=1.0))
        scale = torch.where(ratio > 0.3, torch.clamp(scale, 0.95, 1.05),
                            torch.ones_like(scale))
        gt_scaled = scale[:, None, None] * depth_gt
        valid = (a <= a_th) & (depth_gt > 1e-3)
        pointmap = depth_to_pointmap(gt_scaled, self.K4,
                                     c2w=torch.linalg.inv(w2c))
        return gt_scaled, pointmap, valid

    # ------------------------------------------------------------------
    # windowed optimization
    # ------------------------------------------------------------------
    def _rgb_terms(self, img, image):
        """Per-view 0.8 L1 + 0.2 (1 - SSIM): img/image (V, H, W, 3)."""
        l1 = torch.abs(image - img).flatten(1).mean(1)
        return 0.8 * l1 + 0.2 * (1 - ssim(img, image))

    def _depth_terms(self, d, gt_d, gdn):
        """Per-view inverse-depth L1, depth-normal consistency and dmask."""
        dmask = ((gt_d > 1e-3) & (d > 1e-3)).detach()
        inv_d = torch.where(dmask, 1.0 / torch.clamp(d, min=1e-6)
                            - 1.0 / torch.clamp(gt_d, min=1e-6),
                            torch.zeros_like(d))
        cnt = torch.clamp(dmask.flatten(1).sum(1).float(), min=1.0)
        depth_l = torch.abs(inv_d).flatten(1).sum(1) / cnt
        dn = depth_to_normal(d, self.K4)
        norm_l = ((1 - (dn * gdn).sum(-1)) * dmask).flatten(1).sum(1) / cnt
        return depth_l, norm_l, dmask, cnt

    @staticmethod
    def _iso_terms(params, vis):
        """Per-view isotropy regularizer over visible Gaussians: vis (V, P)."""
        scales = torch.exp(params["log_scales"])
        dev = torch.abs(scales - scales.mean(1, keepdim=True)).mean(1)
        return (dev[None] * vis).sum(1) / torch.clamp(vis.sum(1).float(),
                                                      min=1.0)

    def _window_loss(self, params, pd, ex, alive, images, depths_gt, w2c,
                     weights, bins, gdns):
        cfg = self.cfg
        outs = render_window(params, alive, w2c, self.K4, self.raster_cfg,
                             trans_deltas=pd["t"], rot_deltas=pd["r"],
                             bins=bins)
        img = torch.einsum("vhwi,vij->vhwj", outs["color"], ex["a"]) \
            + ex["b"][:, None, None, :]
        rgb_l = self._rgb_terms(img, images)
        depth_l, norm_l, _, _ = self._depth_terms(outs["depth"], depths_gt,
                                                  gdns)
        iso = self._iso_terms(params, outs["visibility"])
        losses = (rgb_l + cfg.lambda_depth * depth_l
                  + cfg.lambda_normal * norm_l + cfg.lambda_iso * iso)
        return (losses * weights).sum() / torch.clamp(weights.sum(), min=1.0)

    def optimization(self, iters: int, window: List[int],
                     optimize_pose: bool = True):
        loss = 0.0
        for loss in self.optimization_steps(iters, window, optimize_pose):
            pass
        return loss

    def optimization_steps(self, iters: int, window: List[int],
                           optimize_pose: bool = True):
        """GENERATOR yielding the last loss of each ``opt_segment`` slice.
        Only the window's real views render (the JAX package pads the
        window with zero-weight views, which contribute nothing)."""
        cfg, K4, rcfg, dev = self.cfg, self.K4, self.raster_cfg, self.device
        idx = torch.as_tensor(list(window)[-cfg.window_size:],
                              dtype=torch.long, device=dev)
        V = int(idx.shape[0])
        weights = torch.ones(V, device=dev)
        seg = cfg.opt_segment
        n_segs = max(1, (int(iters) + seg - 1) // seg)
        stop_rel = float(cfg.opt_early_stop_rel)
        lrs_pd = {"t": cfg.pose_lr * 10, "r": cfg.pose_lr * 2}
        lrs_ex = {"a": cfg.exposure_lr, "b": cfg.exposure_lr}
        zeros = torch.zeros(V, 3, device=dev)
        pd_adam = Adam({"t": zeros, "r": zeros})
        ex_adam = Adam({"a": torch.zeros(V, 3, 3, device=dev), "b": zeros})
        arena_b, adam_b = self._sliced()
        alive = arena_b.alive
        params = arena_b.params()
        prev_loss = None
        loss = 0.0
        for s in range(n_segs):
            with full_f32():
                images, depths_gt = self._img(idx), self._depth(idx)
                w2c = self.cams.w2c[idx].clone()
                exposure = {"a": self.cams.exposure_a[idx].clone(),
                            "b": self.cams.exposure_b[idx].clone()}
                bins = bin_window(params, alive, w2c, K4, rcfg)
                gdns = depth_to_normal(depths_gt, K4)
                for _ in range(seg):
                    p = {k: _leaf(v) for k, v in params.items()}
                    if optimize_pose:
                        pd = {"t": _leaf(zeros), "r": _leaf(zeros)}
                        ex = {k: _leaf(v) for k, v in exposure.items()}
                    else:
                        pd = {"t": zeros, "r": zeros}
                        ex = exposure
                    loss_t = self._window_loss(p, pd, ex, alive, images,
                                               depths_gt, w2c, weights, bins,
                                               gdns)
                    leaves = list(p.values())
                    if optimize_pose:
                        leaves += [pd["t"], pd["r"], ex["a"], ex["b"]]
                    grads = torch.autograd.grad(loss_t, leaves)
                    gp = _mask_grads(dict(zip(PARAM_KEYS, grads[:5])), alive)
                    adam_b.step(params, gp, self._lrs())
                    if optimize_pose:
                        deltas = {"t": zeros.clone(), "r": zeros.clone()}
                        pd_adam.step(deltas, {"t": grads[5], "r": grads[6]},
                                     lrs_pd)
                        with torch.no_grad():
                            w2c = se3_delta_to_matrix(deltas["t"],
                                                      deltas["r"]) @ w2c
                        ex_adam.step(exposure, {"a": grads[7], "b": grads[8]},
                                     lrs_ex)
                    loss = loss_t.detach()
            self.adam.t = adam_b.t
            if optimize_pose:
                self.cams.w2c[idx] = w2c
                self.cams.exposure_a[idx] = exposure["a"]
                self.cams.exposure_b[idx] = exposure["b"]
            if stop_rel > 0.0:
                cur = float(loss)
                if prev_loss is not None and abs(prev_loss - cur) <= \
                        stop_rel * max(abs(prev_loss), 1e-12):
                    break
                prev_loss = cur
            if s < n_segs - 1:
                yield float(loss)
        yield float(loss)

    # ------------------------------------------------------------------
    # global BA
    # ------------------------------------------------------------------
    def _gba_batch(self, params, alive, w2c_all, expa_all, expb_all,
                   vi_batch, gdns, bins=None):
        """Per-view losses and gradients for a batch of views rendered
        through ONE fused blend (against the block's cached ``bins`` when
        given); Gaussian-space quantities reduced over the batch (sum for
        grads/stats, max for radii)."""
        cfg = self.cfg
        k = vi_batch.shape[0]
        P = params["xyz"].shape[0]
        images, depth_gt = self._img(vi_batch), self._depth(vi_batch)
        w2cs = w2c_all[vi_batch]
        pe = {"t": _leaf(torch.zeros(k, 3, device=self.device)),
              "r": _leaf(torch.zeros(k, 3, device=self.device)),
              "a": _leaf(expa_all[vi_batch]), "b": _leaf(expb_all[vi_batch])}
        probe = _leaf(torch.zeros(k, P, 2, device=self.device))
        p = {kk: _leaf(v) for kk, v in params.items()}
        outs = render_window(p, alive, w2cs, self.K4, self.raster_cfg,
                             trans_deltas=pe["t"], rot_deltas=pe["r"],
                             means2d_probe=probe)
        img = torch.einsum("vhwi,vij->vhwj", outs["color"], pe["a"]) \
            + pe["b"][:, None, None, :]
        rgb_l = self._rgb_terms(img, images)
        depth_l, norm_l, dmask, cnt = self._depth_terms(outs["depth"],
                                                        depth_gt, gdns)
        rn_l = ((1 - (outs["normal"] * gdns).sum(-1)) * dmask).flatten(1) \
            .sum(1) / cnt
        vis = outs["visibility"]
        iso = self._iso_terms(p, vis)
        losses = (rgb_l + cfg.lambda_depth / 10 * depth_l
                  + cfg.lambda_normal * (norm_l + rn_l)
                  + cfg.lambda_iso * iso)
        leaves = list(p.values()) + [probe] + list(pe.values())
        grads = torch.autograd.grad(losses.sum(), leaves)
        with torch.no_grad():
            gp = _mask_grads(dict(zip(PARAM_KEYS, grads[:5])), alive)
            gprobe = torch.where(alive[None, :, None], grads[5],
                                 torch.zeros_like(grads[5]))
            gnorm = torch.sqrt((gprobe * gprobe).sum(-1) + 1e-24)
            ga_c = torch.where(vis, gnorm, torch.zeros_like(gnorm)).sum(0)
            den_c = vis.float().sum(0)
            mr_c = torch.where(vis, outs["radii"],
                               torch.zeros_like(outs["radii"])).max(0).values
            gpes = dict(zip(("t", "r", "a", "b"), grads[6:]))
        return losses.detach(), gp, ga_c, den_c, mr_c, gpes, w2cs

    @torch.no_grad()
    @full_f32()
    def _gba_segment(self, arena_b: GaussianArena, adam_b: Adam,
                     view_idx: torch.Tensor) -> torch.Tensor:
        """One segment: per block (a row of ``view_idx``, k distinct views)
        the views are binned once at the block-start poses when
        ``gba_resample_every`` = m > 1 (m = 1 bins every render afresh) and
        their gt normal maps are made once; then m solver steps. Returns
        the per-step batch-mean losses (n_blocks * m,)."""
        cfg, dev, K4, rcfg = self.cfg, self.device, self.K4, self.raster_cfg
        params, alive = arena_b.params(), arena_b.alive
        C = self.cams.w2c.shape[0]
        k_batch = view_idx.shape[1]
        m_iters = max(1, cfg.gba_resample_every)
        lrs_pe = {"t": cfg.pose_lr * 10, "r": cfg.pose_lr * 2,
                  "a": cfg.exposure_lr, "b": cfg.exposure_lr}
        shapes = {"t": (3,), "r": (3,), "a": (3, 3), "b": (3,)}
        pv_m = {k: torch.zeros((C,) + s, device=dev)
                for k, s in shapes.items()}
        pv_v = {k: torch.zeros((C,) + s, device=dev)
                for k, s in shapes.items()}
        pv_t = torch.zeros(C, dtype=torch.int32, device=dev)
        w2c_all = self.cams.w2c.clone()
        expa_all = self.cams.exposure_a.clone()
        expb_all = self.cams.exposure_b.clone()
        losses = []
        for vi in view_idx:
            bins = bin_window(params, alive, w2c_all[vi], K4, rcfg) \
                if m_iters > 1 else None
            gdns = depth_to_normal(self._depth(vi), K4)
            for _ in range(m_iters):
                with torch.enable_grad():
                    l, gp_sum, ga_c, den_c, mr_c, gpes, w2cs = \
                        self._gba_batch(params, alive, w2c_all, expa_all,
                                        expb_all, vi, gdns, bins)
                adam_b.step(params, {k: g / k_batch
                                     for k, g in gp_sum.items()},
                            self._lrs())
                # per-view Adam on pose delta + exposure (the batch's views
                # are distinct, so the row updates do not collide)
                t_vi = pv_t[vi] + 1
                bc1 = 1 - 0.9 ** t_vi.float()
                bc2 = 1 - 0.999 ** t_vi.float()
                pose_exp = {"t": torch.zeros(k_batch, 3, device=dev),
                            "r": torch.zeros(k_batch, 3, device=dev),
                            "a": expa_all[vi], "b": expb_all[vi]}
                new_pe = {}
                for k in pose_exp:
                    ex = (1,) * (gpes[k].dim() - 1)
                    mk = 0.9 * pv_m[k][vi] + 0.1 * gpes[k]
                    vk = 0.999 * pv_v[k][vi] + 0.001 * gpes[k] ** 2
                    pv_m[k][vi] = mk
                    pv_v[k][vi] = vk
                    new_pe[k] = pose_exp[k] - lrs_pe[k] \
                        * (mk / bc1.reshape((-1,) + ex)) \
                        / (torch.sqrt(vk / bc2.reshape((-1,) + ex)) + 1e-8)
                pv_t[vi] = t_vi
                w2c_all[vi] = se3_delta_to_matrix(new_pe["t"],
                                                  new_pe["r"]) @ w2cs
                expa_all[vi] = new_pe["a"]
                expb_all[vi] = new_pe["b"]
                arena_b.grad_accum.add_(ga_c)
                arena_b.grad_accum_abs.add_(ga_c)
                arena_b.denom.add_(den_c)
                torch.maximum(arena_b.max_radii, mr_c, out=arena_b.max_radii)
                losses.append(l.mean())
        self.adam.t = adam_b.t
        self.cams.w2c.copy_(w2c_all)
        self.cams.exposure_a.copy_(expa_all)
        self.cams.exposure_b.copy_(expb_all)
        return torch.stack(losses)

    def global_ba(self, total_iters: int, densify: bool = True, **draws):
        for _ in self.global_ba_steps(total_iters, densify, **draws):
            pass

    def gba_plan(self, total_iters: int, n_views: int):
        """(k, m, blocks per segment, segments) of a global BA over
        ``total_iters`` view renders: k = min(gba_views_per_iter, n_views)
        views a step, ceil(total / k) steps in blocks of m, whole segments
        of ``gba_segment // m`` blocks."""
        cfg = self.cfg
        k = max(1, min(cfg.gba_views_per_iter, n_views))
        m = max(1, cfg.gba_resample_every)
        n_steps = max(1, -(-total_iters // k))
        blocks_per_seg = max(1, cfg.gba_segment // m)
        n_blocks = max(1, -(-n_steps // m))
        return k, m, blocks_per_seg, max(1, -(-n_blocks // blocks_per_seg))

    def global_ba_steps(self, total_iters: int, densify: bool = True,
                        view_idx: Optional[Sequence] = None,
                        split_noise=None):
        """GENERATOR yielding after each segment (a whole segment always
        runs, as in the JAX package). ``total_iters`` counts view renders:
        with k views a step the Gaussian Adam step count drops k-fold
        while each view's pose/exposure still updates per render.
        ``view_idx``: optional per-segment (blocks per segment, k) view
        draws; ``split_noise``: optional (capacity, 3) densify noise.
        Absent ones are drawn from ``self.gen`` (k distinct views a
        block). The per-step losses of the call land in ``gba_losses``."""
        cfg, dev = self.cfg, self.device
        valid = self.cams.valid.cpu().numpy()
        view_ids = [i for i in range(cfg.cam_capacity) if valid[i]]
        self.gba_losses = []
        if not view_ids or total_iters <= 0:
            return
        k, _, blocks_per_seg, n_segs = self.gba_plan(total_iters,
                                                     len(view_ids))
        ids = torch.as_tensor(view_ids, dtype=torch.long)
        for s in range(n_segs):
            if view_idx is not None:
                vi = torch.tensor(np.asarray(view_idx[s]), dtype=torch.long)
            else:
                vi = torch.stack([
                    ids[torch.randperm(len(view_ids), generator=self.gen)[:k]]
                    for _ in range(blocks_per_seg)])
            arena_b, adam_b = self._sliced()
            self.gba_losses.append(self._gba_segment(arena_b, adam_b,
                                                     vi.to(dev)))
            if densify and s == max(n_segs // 2 - 1, 0):
                if split_noise is None:
                    noise = torch.randn(cfg.capacity, 3, generator=self.gen)
                else:
                    noise = torch.tensor(np.asarray(split_noise, np.float32))
                with full_f32():
                    densify_and_prune(self.arena, noise.to(dev),
                                      max_grad=cfg.densify_grad_threshold,
                                      min_opacity=cfg.opacity_threshold)
                self.adam.zero_rows(~self.arena.alive)
            yield s

    # ------------------------------------------------------------------
    @torch.no_grad()
    @full_f32()
    def data_update(self, window: List[int]):
        """Refined depths / pointmaps / poses for the tracker writeback."""
        arena_b, _ = self._sliced()
        params, alive = arena_b.params(), arena_b.alive
        ds, cs = [], []
        for vi in window:
            w2c = self.cams.w2c[vi]
            out = render_view(params, alive, w2c, self.K4, self.raster_cfg)
            d, a = out["depth"], out["alpha"]
            gt = self._depth(vi)
            vmask = (d > 1e-3) & (gt > 1e-3) & (a > 0.9)
            diff = torch.where(vmask, torch.log(torch.clamp(d, min=1e-6))
                               - torch.log(torch.clamp(gt, min=1e-6)),
                               torch.zeros_like(d))
            scale = torch.exp(diff.sum() / torch.clamp(vmask.sum().float(),
                                                       min=1.0))
            ds.append(torch.clamp(scale, 0.95, 1.05) * gt)
            cs.append(torch.linalg.inv(w2c))
        d = torch.stack(ds).cpu().numpy()
        c = torch.stack(cs).cpu().numpy()
        fx, fy, cx, cy = self.K4.cpu().numpy()
        gy, gx = np.meshgrid(np.arange(d.shape[1], dtype=np.float32),
                             np.arange(d.shape[2], dtype=np.float32),
                             indexing="ij")
        X = (gx[None] - cx) / fx * d
        Y = (gy[None] - cy) / fy * d
        pts = np.stack([X, Y, d], axis=-1)
        p = np.einsum("vij,vhwj->vhwi", c[:, :3, :3], pts) \
            + c[:, None, None, :3, 3]
        return {"depths": d, "pointmaps": p, "c2w": c,
                "window": list(window)}

    # ------------------------------------------------------------------
    # loop closure
    # ------------------------------------------------------------------
    @torch.no_grad()
    @full_f32()
    def lc_transform(self, submap_ids, pose_updates):
        """Rigidly move the alive Gaussians of the listed submaps
        (``arena.kf_id``) by their SE(3) updates (S, 7) [t, q xyzw], compose
        their wxyz rotations, and zero their Adam moments. Rows that match
        no listed submap stay as they are."""
        arena, dev = self.arena, self.device
        ids = torch.as_tensor(np.asarray(submap_ids), dtype=torch.int32,
                              device=dev)
        upd = torch.as_tensor(np.asarray(pose_updates, np.float32),
                              device=dev)
        match = arena.kf_id[:, None] == ids[None, :]
        sel = match.any(-1) & arena.alive
        # argmax of an all-False row is 0; ``sel`` masks those rows out
        which = torch.argmax(match.to(torch.uint8), -1)
        T = se3_matrix(torch.cat([upd[:, :3], quat_normalize(upd[:, 3:7])],
                                 -1))[which]
        new_xyz = torch.einsum("nij,nj->ni", T[:, :3, :3], arena.xyz) \
            + T[:, :3, 3]
        qrot = xyzw_to_wxyz(matrix_to_quat(T[:, :3, :3]))
        new_quat = quat_mult_wxyz(qrot, quat_normalize(arena.quat))
        arena.xyz.copy_(torch.where(sel[:, None], new_xyz, arena.xyz))
        arena.quat.copy_(torch.where(sel[:, None], new_quat, arena.quat))
        self.adam.zero_rows(sel)

    def gaussian_update(self, submap_ids, pose_updates, camera_idx,
                        camera_w2c):
        """Loop-closure writeback: the corrected w2c of every valid camera
        listed, the rigid move of the corrected submaps' Gaussians, then a
        pose refinement of each of those cameras."""
        valid = self.cams.valid.cpu().numpy()
        cams = [int(k) for k in camera_idx if valid[k]]
        w2c = dict(zip((int(k) for k in camera_idx), camera_w2c))
        for k in cams:
            self.cams.w2c[k] = torch.as_tensor(np.asarray(w2c[k], np.float32),
                                               device=self.device)
        self.lc_transform(submap_ids, pose_updates)
        for k in cams:
            self.pose_refine(k)

    # ------------------------------------------------------------------
    def run(self, packet: Dict, iterations: int = 100, **draws):
        """Per-submap mapping update drained in one call; returns the
        data_update dict."""
        gen = self.run_steps(packet, iterations, **draws)
        while True:
            try:
                next(gen)
            except StopIteration as e:
                return e.value

    def run_steps(self, packet: Dict, iterations: int = 100,
                  view_idx: Optional[Sequence] = None, split_noise=None):
        """Per-submap mapping update: GENERATOR yielding after each bounded
        slice of work (a pose refinement, a seeding, an optimization or
        global-BA segment), RETURNING the data_update dict. With
        ``parallel_kf_refine`` and more than one new keyframe after the
        first event, the new keyframes are refined as one batch, seeded,
        then optimized jointly; otherwise one keyframe after another.
        ``view_idx`` / ``split_noise``: optional injected global-BA draws
        (see ``global_ba_steps``)."""
        viz_idx = list(packet["viz_idx"])
        imgs = packet["images"]
        depths = packet["depths"]
        pointmaps = packet["pointmaps"]
        confs = packet["confs"]
        w2cs = packet["w2c"]
        submap_idx = int(packet["submap_idx"])
        ds = self.cfg.downsample
        valid = self.cams.valid.cpu().numpy()
        new_pos = [i for i, idx in enumerate(viz_idx) if not valid[idx]]

        if self.initialized and self.cfg.parallel_kf_refine \
                and len(new_pos) > 1:
            # initial poses chain through the predecessor as below, except
            # that a predecessor new in this event gives its INIT pose (its
            # refinement has not run yet; the joint window optimization
            # afterwards couples the poses again)
            init_w2c = {}
            for i in new_pos:
                w2c = w2cs[i]
                if i > 0:
                    rel = w2cs[i] @ np.linalg.inv(w2cs[i - 1])
                    base = init_w2c[i - 1] if i - 1 in init_w2c \
                        else self.cams.w2c[viz_idx[i - 1]].cpu().numpy()
                    w2c = rel @ base
                init_w2c[i] = w2c
                self.add_keyframe(viz_idx[i], imgs[i], depths[i], w2c)
            new_idxs = [viz_idx[i] for i in new_pos]
            with self._tm("map_refine"):
                pms, vals = self.pose_refine_multi(new_idxs)
            yield "refine"
            with self._tm("map_seed"):
                pms, vals = pms.cpu().numpy(), vals.cpu().numpy()
                for j, i in enumerate(new_pos):
                    idx = viz_idx[i]
                    rgb_ds = imgs[i][::ds, ::ds].astype(np.float32) / 255.0
                    self.seed(idx, pms[j], rgb_ds, vals[j], submap_idx)
                    self._push_window(idx)
            yield "seed"
            # the sequential path's per-keyframe iteration budget
            yield from self._timed_steps("map_window", self.optimization_steps(
                self.cfg.window_opt_iters * len(new_pos),
                self.current_window))
            if self.cfg.new_view_opt_iters > 0:
                # the per-view losses are independent: polishing the new
                # keyframes jointly is the sequential polish of each
                yield from self._timed_steps(
                    "map_polish", self.optimization_steps(
                        self.cfg.new_view_opt_iters, new_idxs,
                        optimize_pose=False))
        else:
            for i in new_pos:
                idx = viz_idx[i]
                w2c = w2cs[i]
                if i > 0:
                    # chain through the refined previous pose
                    rel = w2cs[i] @ np.linalg.inv(w2cs[i - 1])
                    w2c = rel @ self.cams.w2c[viz_idx[i - 1]].cpu().numpy()
                self.add_keyframe(idx, imgs[i], depths[i], w2c)
                rgb_ds = imgs[i][::ds, ::ds].astype(np.float32) / 255.0
                if not self.initialized:
                    with self._tm("map_seed"):
                        self.seed(idx, pointmaps[i], rgb_ds, confs[i] > 0.0,
                                  submap_idx)
                    self.current_window = [idx]
                    yield from self._timed_steps(
                        "map_window", self.optimization_steps(
                            iterations, self.current_window))
                    self.initialized = True
                    continue
                self._push_window(idx)
                with self._tm("map_refine"):
                    pointmap, pvalid = self.pose_refine(idx)
                yield "refine"
                with self._tm("map_seed"):
                    self.seed(idx, pointmap.cpu().numpy(), rgb_ds,
                              pvalid.cpu().numpy(), submap_idx)
                yield from self._timed_steps(
                    "map_window", self.optimization_steps(
                        self.cfg.window_opt_iters, self.current_window))
                if self.cfg.new_view_opt_iters > 0:
                    yield from self._timed_steps(
                        "map_polish", self.optimization_steps(
                            self.cfg.new_view_opt_iters,
                            [self.current_window[-1]], optimize_pose=False))

        n_views = int(self.cams.valid.sum())
        yield from self._timed_steps("map_gba", self.global_ba_steps(
            self.cfg.gba_per_view * n_views, densify=True, view_idx=view_idx,
            split_noise=split_noise))
        with self._tm("map_update"):
            return self.data_update(self.current_window)

    def _push_window(self, idx: int):
        """Append a keyframe to the sliding window (oldest out when full)."""
        w = self.current_window
        self.current_window = (w if len(w) < self.cfg.window_size
                               else w[1:]) + [idx]

    def finalize(self, iters: int = 2000, **draws):
        self.global_ba(iters, densify=True, **draws)

    @torch.no_grad()
    @full_f32()
    def eval_view(self, idx: int) -> float:
        """PSNR of one keyframe's render against its stored image."""
        arena_b, _ = self._sliced()
        img = render_view(arena_b.params(), arena_b.alive, self.cams.w2c[idx],
                          self.K4, self.raster_cfg)["color"]
        mse = float(((img - self._img(idx)) ** 2).mean())
        return -10.0 * np.log10(max(mse, 1e-12))

    # ------------------------------------------------------------------
    # checkpointing: the JAX package's npz keys
    # ------------------------------------------------------------------
    def save(self, path: str):
        import os
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

        def to_np(v):
            return v.float().cpu().numpy() if v.dtype == torch.bfloat16 \
                else v.cpu().numpy()
        out = {f"arena_{f.name}": to_np(getattr(self.arena, f.name))
               for f in dataclasses.fields(self.arena)}
        out.update({f"cams_{f.name}": to_np(getattr(self.cams, f.name))
                    for f in dataclasses.fields(self.cams)})
        out.update({f"adam_m_{k}": to_np(x) for k, x in self.adam.m.items()})
        out.update({f"adam_v_{k}": to_np(x) for k, x in self.adam.v.items()})
        out["adam_t"] = np.asarray(self.adam.t, np.int32)
        np.savez_compressed(path, window=np.asarray(self.current_window),
                            initialized=np.asarray(self.initialized), **out)

    def load(self, path: str):
        z = np.load(path)
        dev = self.device

        def t(key):
            return torch.as_tensor(z[key], device=dev)
        self.arena = GaussianArena(**{
            f.name: t(f"arena_{f.name}")
            for f in dataclasses.fields(GaussianArena)})
        cams = {f.name: t(f"cams_{f.name}")
                for f in dataclasses.fields(CameraBuffer)}
        cams["depth"] = cams["depth"].to(torch.bfloat16)
        self.cams = CameraBuffer(**cams)
        self.adam = Adam(self.arena.params())
        for k in PARAM_KEYS:
            self.adam.m[k] = t(f"adam_m_{k}")
            self.adam.v[k] = t(f"adam_v_{k}")
        self.adam.t = int(z["adam_t"])
        self.current_window = [int(x) for x in z["window"]]
        self.initialized = bool(z["initialized"])
