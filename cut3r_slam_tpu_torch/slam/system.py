"""SLAM orchestrator (port of the live loop of ``cut3r_slam_tpu/slam/
system.py``).

``run(t, img, K, img_map, K_map, second_last, last)``: keyframe filter ->
frontend submap tracking -> (freeze-gated) loop backend -> on a closure,
``mapper.gaussian_update`` and the optional Sim(3) PGBA pass -> mapping
update for the new keyframes + depth / pose writeback into the keyframe
store. ``run_test`` is the same step with ground truth injected in place
of the network's predictions (the JAX package's GT-injection driver).
With ``Mapping.interleave`` = n > 0 a mapping event is a generator
(``MappingBackend.run_steps``) advanced by at most n slices a frame
(``step_mapper``); the backlog drains before the next event and at
``terminate``. ``terminate(t)``: drain, the optional keyframe
densification, the final global BA, the optional trajectory fill, the
rendering eval (``psnr/<it>/*.json``, ``renders_kf/``) and the render
export, the mapper checkpoint and the Gaussian PLY. ``reset_state``
empties every store for a second sequence. ``motion_filter.use_prior``
computes a monocular depth and normal prior per keyframe (``PriorNet``,
from random weights or a ``prior_ckpt`` npz of the JAX package's flax
params, or Omnidata DPT-hybrid from ``omnidata_ckpt_{depth,normal}``),
stored in the keyframe store; no mapping loss reads it, as in the JAX
package. The configuration ported is one device and no GUI; asking for
the GUI or for view-parallel mapping raises NotImplementedError.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import full_f32, resolve_device
from ..models import CUT3R
from ..models.blocks import init_random
from ..models.convert import params_from_jax
from ..models.omnidata import load_omnidata_ckpt, resize_bilinear
from ..models.priors import PriorNet, normalize_imagenet
from ..geometry.lie import se3_from_matrix, se3_matrix
from ..geometry.pointmap import pose_vec_to_matrix
from ..utils.image import CompressedFrameStore
from ..utils.profiling import timed
from .keyframe import KeyframeStore, SUBMAP_SIZE
from .motion_filter import MotionFilter
from .factor_graph import FactorGraph
from .frontend import TrackFrontend, pose_vec_to_matrix_np, \
    submap_postprocess
from .backend import TrackBackend
from .mapping import MappingBackend, MappingConfig
from .renderer import render_window
from .sim3_pgo import PGBABuffer

__all__ = ["SLAMSystem"]


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to cut3r_slam_tpu_torch "
                              "yet (see ROADMAP.md)")


class SLAMSystem:
    def __init__(self, model: CUT3R, cfg: Dict, buffer: int = 512,
                 img_hw=(384, 512), map_hw=None, enable_mapping: bool = True,
                 enable_loop: bool = True, output_dir: str = "outputs/run",
                 device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, system on "
                             f"{self.device}")
        tcfg = cfg.get("Tracking", {})
        mcfg = cfg.get("Mapping", {})
        trcfg = cfg.get("Training", {})
        mf_cfg = tcfg.get("motion_filter", {})
        if bool(cfg.get("GUI", {}).get("active", False)):
            _not_ported("the live viewer (GUI.active)")
        if int(mcfg.get("view_parallel", 0)) > 1:
            _not_ported("view-parallel mapping (Mapping.view_parallel)")

        H, W = img_hw
        self.img_hw = img_hw
        self.map_hw = tuple(map_hw) if map_hw is not None else (H, W)
        self.keyframes = KeyframeStore(
            buffer, img_hw, (H // 16) * (W // 16), model.cfg.enc_embed_dim,
            map_hw=self.map_hw, device=self.device)
        prior = None
        if bool(mf_cfg.get("use_prior", False)):
            prior = build_prior_fns(mf_cfg, (H, W), self.device)
        self.filter = MotionFilter(model, self.keyframes,
                                   thresh=mf_cfg.get("thresh", 0.9),
                                   skip=mf_cfg.get("skip", 5),
                                   kf_every=mf_cfg.get("kf_every", 0),
                                   prior=prior)
        self.graph = FactorGraph()
        self.frontend = TrackFrontend(model, self.keyframes, self.graph)
        # the JAX SLAMSystem reads these three backend keys only (it keeps
        # freeze_after 20 and the Adam rate 5e-4)
        bcfg = tcfg.get("backend", {})
        self.backend = TrackBackend(
            self.frontend, self.keyframes, self.graph,
            loop_iters=bcfg.get("loop_iters", 2000),
            loop_gap=bcfg.get("loop_gap", 8),
            nms_thresh=bcfg.get("nms_thresh", 0.4))
        self.enable_loop = enable_loop
        pgba_cfg = tcfg.get("pgba", {})
        self._pgba_args = None
        if bool(pgba_cfg.get("active", False)):
            self._pgba_args = dict(
                loop_weight=float(pgba_cfg.get("loop_weight", 2.0)),
                iters=int(pgba_cfg.get("iters", 6)),
                conf_weighting=bool(pgba_cfg.get("conf_weighting", False)))
        self.pgba = PGBABuffer(**self._pgba_args) \
            if self._pgba_args is not None else None
        self.mapper: Optional[MappingBackend] = None
        self.enable_mapping = enable_mapping
        self._map_cfg_extra = dict(
            capacity=mcfg.get("arena_capacity", 2 ** 18),
            cam_capacity=buffer,
            window_size=mcfg.get("window_size", 10),
            lambda_depth=mcfg.get("lambda_depth", 0.5),
            lambda_normal=mcfg.get("lambda_normal", 0.05),
            lambda_iso=mcfg.get("lambda_iso", 10.0),
            pose_refine_iters=int(mcfg.get("pose_refine_iters", 50)),
            window_opt_iters=int(mcfg.get("window_opt_iters", 20)),
            new_view_opt_iters=int(mcfg.get("new_view_opt_iters", 50)),
            gba_per_view=int(mcfg.get("gba_per_view", 10)),
            gba_views_per_iter=int(mcfg.get("gba_views_per_iter", 1)),
            gba_resample_every=int(mcfg.get("gba_resample_every", 1)),
            parallel_kf_refine=bool(mcfg.get("parallel_kf_refine", False)),
            opt_early_stop_rel=float(mcfg.get("opt_early_stop", 0.0)),
            pose_lr=trcfg.get("pose_lr", 0.0003))
        # interleaved mapping: > 0 runs at most this many mapping slices
        # per tracking frame; 0 drains each event in the frame that
        # triggers it
        self.map_interleave = int(mcfg.get("interleave", 0))
        self._map_gen = None
        self.frame_map_slices = 0  # mapping slices run in the last frame
        self.timer = None  # optional utils.profiling.StageTimer
        self.output_dir = output_dir
        self.mapping_iters = mcfg.get("iterations", 100)
        self.finalize_iters = cfg.get("opt_params", {}).get(
            "position_lr_max_steps",
            trcfg.get("position_lr_max_steps", 2000))
        self.keep_all_frames = bool(cfg.get("keep_all_frames", True))
        self.images = CompressedFrameStore()
        self.last_t = -1

    def _init_mapper(self, K4_map):
        mh, mw = self.map_hw
        self.mapper = MappingBackend(
            MappingConfig(height=mh, width=mw, **self._map_cfg_extra),
            np.asarray(K4_map, np.float32), device=self.device)
        self.mapper.timer = self.timer

    def _tm(self, stage: str):
        return timed(self.timer, stage, self.device)

    def reset_state(self):
        """Empty every store (keyframes, factor graph, loop backend, PGBA,
        mapper, frame store, any interleaved backlog) for a new sequence;
        the model, the configuration and the timer stay."""
        old = self.keyframes
        kf = KeyframeStore(old.capacity, old.img_hw, int(old.featI.shape[1]),
                           int(old.featI.shape[2]), map_hw=old.map_hw,
                           device=self.device)
        if self.filter.prior is not None:
            kf.ensure_prior_buffers()
        self.keyframes = kf
        self.filter.keyframes = kf
        self.frontend.keyframes = kf
        self.backend.kf = kf
        self.graph = FactorGraph()
        self.frontend.graph = self.graph
        self.backend.graph = self.graph
        self.frontend.is_initialized = False
        self.frontend.t1 = 0
        if getattr(self, "_gt_store", None) is not None:
            self._gt_store.clear()
        self.backend.freeze_counter = 0
        self.backend.closed = []
        self.backend.closed_loop = {"idx_current": [], "idx_matched": [],
                                    "lc_fl": []}
        if self._pgba_args is not None:
            self.pgba = PGBABuffer(**self._pgba_args)
        self._map_gen = None
        if self.mapper is not None:
            self.mapper.reset_state()
        self.images = CompressedFrameStore()
        self.last_t = -1

    def run(self, t: int, img: np.ndarray, K4: np.ndarray,
            img_map: Optional[np.ndarray] = None,
            K4_map: Optional[np.ndarray] = None,
            second_last: bool = False, last: bool = False):
        """Per-frame step. Returns (keyframe taken, new KF range or None)."""
        self.last_t = t
        self.frame_map_slices = 0
        if self.keep_all_frames:
            self.images[t] = img_map if img_map is not None else img
        with self._tm("filter"):
            took = self.filter(t, img, intrinsic=K4, second_last=second_last,
                               last=last, image_map=img_map,
                               intrinsic_map=K4_map)
        return took, self._track_and_map(t, last)

    def run_test(self, t: int, img: np.ndarray, K4: np.ndarray,
                 depth_gt: np.ndarray, c2w_gt: np.ndarray,
                 img_map: Optional[np.ndarray] = None,
                 K4_map: Optional[np.ndarray] = None,
                 second_last: bool = False, last: bool = False,
                 sigma_t: float = 0.05, sigma_r: float = 0.01):
        """GT-injection per-frame step: keyframes store the ground-truth
        depth and pose, and the frontend and the loop backend build
        pointmaps from ground-truth depth with perturbed relative poses in
        place of the submap decode; the rest of the chain (filter, loop,
        PGBA, mapping) runs as in ``run``."""
        if self.frontend.gt_inject is None:
            self._gt_store = {}
            self.frontend.set_gt_injection(
                lambda ts: self._gt_store[int(ts)], sigma_t=sigma_t,
                sigma_r=sigma_r)
        c2w_gt = np.asarray(c2w_gt, np.float32)
        self._gt_store[int(t)] = (np.asarray(depth_gt, np.float32), c2w_gt)
        self.last_t = t
        self.frame_map_slices = 0
        if self.keep_all_frames:
            self.images[t] = img_map if img_map is not None else img
        pose_vec = se3_from_matrix(torch.as_tensor(c2w_gt)).numpy()
        took = self.filter(t, img, intrinsic=K4, pose=pose_vec,
                           depth=depth_gt, second_last=second_last,
                           last=last, image_map=img_map,
                           intrinsic_map=K4_map)
        return took, self._track_and_map(t, last)

    def _track_and_map(self, t: int, last: bool):
        """Frontend tracking, the loop branch and mapping of one frame;
        returns the new keyframe range or None."""
        with self._tm("frontend"):
            run_backend, viz_range, submap_idx = self.frontend.run(t, last)
        if run_backend and self.enable_loop:
            with self._tm("loop_backend"):
                updates = self.backend.run(self.frontend.t1)
            if updates is not None and self.mapper is not None:
                self.mapper.gaussian_update(
                    updates["submap_idx"], updates["pose_updates"],
                    list(updates["camera_idx"]),
                    np.linalg.inv(pose_vec_to_matrix_np(
                        updates["camera_pose"])))
            if updates is not None and self.pgba is not None:
                # loop edge from the LC-corrected poses, then a global
                # Sim(3) pass over all keyframes
                kf = self.keyframes
                self.pgba.on_new_keyframes(kf, kf.count)
                self.pgba.on_loop(self.backend.closed_loop["idx_matched"][-1],
                                  self.backend.closed_loop["idx_current"][-1],
                                  kf)
                self.pgba.solve_and_writeback(kf)
        if viz_range is not None and self.pgba is not None:
            # odometry constraints for the new keyframes
            self.pgba.on_new_keyframes(self.keyframes, self.keyframes.count)
        if viz_range is not None and self.enable_mapping:
            with self._tm("mapping"):
                self.call_mapper(viz_range, submap_idx)
        elif self.enable_mapping and self._map_gen is not None:
            # no new submap this frame: advance the pending event
            with self._tm("mapping"):
                self.step_mapper(self.map_interleave)
        return viz_range

    def call_mapper(self, viz_range, submap_idx):
        """Build the mapping packet and run the event: drained at once, or
        (interleaved) started after the previous event's backlog drains
        and advanced by ``map_interleave`` slices."""
        kf = self.keyframes
        if self.mapper is None:
            if kf.intrinsic_map[0].sum() == 0:
                kf.intrinsic_map[:kf.count] = kf.intrinsic[:kf.count]
            self._init_mapper(kf.intrinsic_map[0])
        idxs = list(viz_range)
        mh, mw = self.map_hw
        ds = self.mapper.cfg.downsample
        imgs = kf.image_map[idxs] if kf.image_map[idxs].sum() \
            else kf.image[idxs]
        depths = np.stack([_resize_f(kf.depth[i], mw, mh) for i in idxs])
        pts = kf.pts_ds[torch.as_tensor(idxs, device=kf.device)].cpu().numpy()
        confs = kf.submap_conf[submap_idx][:len(idxs)].cpu().numpy() \
            if submap_idx is not None \
            else np.ones((len(idxs), mh // ds, mw // ds), np.float32)
        confs = np.stack([_resize_f(c, mw // ds, mh // ds) for c in confs])
        pts = np.stack([_resize_pts(p, mw // ds, mh // ds) for p in pts])
        w2cs = np.linalg.inv(pose_vec_to_matrix_np(
            np.asarray(kf.pose[idxs], np.float32)))
        packet = {"viz_idx": idxs, "images": imgs, "depths": depths,
                  "pointmaps": pts, "confs": confs, "w2c": w2cs,
                  "submap_idx": submap_idx or 0, "tstamp": kf.tstamp[idxs]}
        if self.map_interleave > 0:
            self.drain_mapper()
            self._map_gen = self.mapper.run_steps(packet, self.mapping_iters)
            self.step_mapper(self.map_interleave)
        else:
            upd = self.mapper.run(packet, self.mapping_iters)
            self.frame_map_slices += 1
            self._apply_map_update(upd)

    def _apply_map_update(self, upd):
        """Write refined poses/depths back into the keyframe store."""
        if upd is None:
            return
        from scipy.spatial.transform import Rotation
        kf = self.keyframes
        for d, c2w, k in zip(upd["depths"], upd["c2w"], upd["window"]):
            q = Rotation.from_matrix(
                np.asarray(c2w[:3, :3], np.float64)).as_quat()
            kf.pose[k] = np.concatenate([np.asarray(c2w[:3, 3]), q]).astype(
                np.float32)
            th, tw = kf.img_hw
            kf.depth[k] = _resize_f(d, tw, th)

    def step_mapper(self, n_slices: int):
        """Advance the pending interleaved mapping event by at most
        ``n_slices`` slices; the slice that finishes the event (its
        ``data_update``) counts too, and its writeback is applied."""
        for _ in range(max(0, n_slices)):
            if self._map_gen is None:
                return
            self.frame_map_slices += 1
            try:
                next(self._map_gen)
            except StopIteration as e:
                self._map_gen = None
                self._apply_map_update(e.value)
                return

    def drain_mapper(self):
        """Run the pending interleaved mapping event to completion."""
        while self._map_gen is not None:
            self.step_mapper(1)

    # ------------------------------------------------------------------
    def add_kf_densify(self, gap: int = 30) -> int:
        """Terminate-time densification: for every keyframe gap wider than
        ``gap`` frames, decode the middle frame against its predecessor
        keyframe (the predecessor's stored tokens + the middle frame's,
        padded to the submap's six views), append it as a keyframe and
        add it to the map (pose refine, seed, a 20-iteration polish)."""
        kf = self.keyframes
        if self.mapper is None or not self.images:
            return 0
        dev = self.device
        th, tw = kf.img_hw
        mh, mw = self.map_hw
        added = 0
        for i in range(kf.count - 1):
            t0, t1 = int(kf.tstamp[i]), int(kf.tstamp[i + 1])
            tm = (t0 + t1) // 2
            if t1 - t0 <= gap or tm not in self.images:
                continue
            im_t = _resize_u8(self.images[tm], tw, th)
            feat_mid = self.filter.encode(im_t)
            pts, conf, c2w = self.frontend.decode_feats(
                torch.stack([kf.featI[i]] + [feat_mid] * 5))
            anchor = pose_vec_to_matrix(torch.as_tensor(kf.pose[i],
                                                        device=dev))
            poses, depths, _, _, _, _ = submap_postprocess(
                pts, conf, c2w, anchor, torch.as_tensor(kf.depth[i],
                                                        device=dev),
                init=False, ds=2)
            depth = depths[1].cpu().numpy()
            new_idx = kf.count
            kf.append(tm, im_t, pose=se3_from_matrix(poses[1]).cpu().numpy(),
                      depth=_resize_f(depth, tw, th),
                      intrinsic=kf.intrinsic[i])
            img_m = _resize_u8(self.images[tm], mw, mh)
            self.mapper.add_keyframe(new_idx, img_m, _resize_f(depth, mw, mh),
                                     np.linalg.inv(poses[1].cpu().numpy()))
            pointmap, valid = self.mapper.pose_refine(new_idx)
            self.mapper.seed(new_idx, pointmap.cpu().numpy(),
                             img_m[::2, ::2].astype(np.float32) / 255.0,
                             valid.cpu().numpy(), i // SUBMAP_SIZE)
            self.mapper.optimization(20, [new_idx], optimize_pose=False)
            added += 1
        return added

    def fill_trajectory(self):
        """Poses of the non-keyframe frames, each refined against the final
        map from the nearest earlier keyframe; returns (timestamps, (N, 7)
        c2w [t, q xyzw]) or None."""
        if self.mapper is None or not self.images:
            return None
        from .trajectory_filler import TrajectoryFiller
        kf = self.keyframes
        # densified keyframes append out of timestamp order
        order = np.argsort(kf.tstamp[: kf.count])
        kf_ts = kf.tstamp[: kf.count][order]
        mh, mw = self.map_hw
        ts = [t for t in sorted(self.images) if t not in set(kf_ts.tolist())]
        imgs = [_resize_u8(self.images[t], mw, mh) for t in ts]
        poses = TrajectoryFiller(self.mapper, iters=100).fill(
            imgs, ts, kf_ts, kf.pose[: kf.count][order])
        return ts, poses

    def terminate(self, t: int, eval_render: bool = True,
                  export_renders: bool = True, add_kf: bool = False,
                  fill: bool = False) -> Dict:
        """Drain, flush the last keyframes, then (with a mapper) the
        optional densification, the final global BA, the optional
        trajectory fill (``traj_full.txt``), the rendering eval, the
        render export, the checkpoint and the Gaussian PLY."""
        self.drain_mapper()
        self.frontend.run(t, last_frame=True)
        result = {}
        if self.mapper is None:
            return result
        os.makedirs(self.output_dir, exist_ok=True)
        if add_kf:
            result["added_kf"] = self.add_kf_densify()
        self.mapper.finalize(iters=int(self.finalize_iters))
        filled = self.fill_trajectory() if fill else None
        if filled:
            with open(os.path.join(self.output_dir, "traj_full.txt"),
                      "w") as f:
                for tt, p in zip(*filled):
                    f.write(f"{tt} " + " ".join(f"{v:.9f}" for v in p)
                            + "\n")
        if eval_render:
            kf_out = self.eval_rendering_kf()
            result["psnr_kf"] = kf_out["mean_psnr"]
            result["eval_kf"] = kf_out
            result["eval_full"] = self.eval_rendering_full(filled)
        if export_renders:
            self.export_renders(os.path.join(self.output_dir, "renders_kf"))
        self.mapper.save(os.path.join(self.output_dir, "gaussians.npz"))
        from ..utils.viz import save_gaussians_ply
        save_gaussians_ply(os.path.join(self.output_dir, "3dgs_final.ply"),
                           self.mapper.arena)
        return result

    # ------------------------------------------------------------------
    # terminate-time rendering eval (the JAX package's file layout)
    # ------------------------------------------------------------------
    _EVAL_BATCH = 16

    @torch.no_grad()
    @full_f32()
    def _render_views_batched(self, w2cs: np.ndarray,
                              exp_a: Optional[np.ndarray] = None,
                              exp_b: Optional[np.ndarray] = None):
        """Render V views from the final map in buckets of ``_EVAL_BATCH``,
        each bucket one fused forward (K1). Returns (images (V, H, W, 3)
        in [0, 1] after the per-view exposure affine, depths (V, H, W));
        no exposure = identity."""
        m = self.mapper
        V = len(w2cs)
        if exp_a is None:
            exp_a = np.broadcast_to(np.eye(3, dtype=np.float32), (V, 3, 3))
        if exp_b is None:
            exp_b = np.zeros((V, 3), np.float32)
        arena_b, _ = m._sliced()
        params, alive = arena_b.params(), arena_b.alive

        def t(x):
            return torch.tensor(np.asarray(x, np.float32),
                                device=self.device)
        imgs, depths = [], []
        for s in range(0, V, self._EVAL_BATCH):
            sl = slice(s, s + self._EVAL_BATCH)
            out = render_window(params, alive, t(w2cs[sl]), m.K4,
                                m.raster_cfg)
            img = torch.einsum("vhwi,vij->vhwj", out["color"], t(exp_a[sl])) \
                + t(exp_b[sl])[:, None, None, :]
            imgs.append(torch.clamp(img, 0.0, 1.0).cpu().numpy())
            depths.append(out["depth"].cpu().numpy())
        return np.concatenate(imgs), np.concatenate(depths)

    @staticmethod
    def _save_render(img: np.ndarray, depth: np.ndarray, img_dir: str,
                     depth_dir: str, idx: int):
        """jpg colour + uint16 depth x 6553.5 (the reference's layout)."""
        from ..utils.viz import save_image
        save_image(os.path.join(img_dir, f"{idx:06d}.jpg"),
                   (img * 255).astype(np.uint8))
        save_image(os.path.join(depth_dir, f"{idx:06d}.png"),
                   np.clip(depth * 6553.5, 0, 65535).astype(np.uint16))

    def _valid_kf(self):
        valid = self.mapper.cams.valid.cpu().numpy()
        return [i for i in range(self.keyframes.count) if valid[i]]

    def _write_eval(self, iteration, fname, ps, ss, lp, l1, **extra):
        out = {"mean_psnr": float(np.mean(ps)) if ps else 0.0,
               "mean_ssim": float(np.mean(ss)) if ss else 0.0,
               "mean_lpips": float(np.mean(lp)) if lp else None,
               "mean_l1": float(np.mean(l1)) if l1 else 0.0,
               "n_views": len(ps), **extra}
        jdir = os.path.join(self.output_dir, "psnr", str(iteration))
        os.makedirs(jdir, exist_ok=True)
        with open(os.path.join(jdir, fname), "w") as f:
            json.dump(out, f, indent=4)
        return out

    def _score(self, img, gt, ps, ss, lp):
        from ..utils import eval as E
        mask = gt > 0
        ps.append(E.psnr(img[mask], gt[mask]))
        ss.append(E.ssim(img, gt))
        v = E.lpips(img, gt)
        if v is not None:
            lp.append(v)

    def _render_dirs(self, sub: str, iteration: str):
        dirs = [os.path.join(self.output_dir, sub, f"{k}_{iteration}")
                for k in ("image", "depth")]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        return dirs

    def eval_rendering_kf(self, iteration: str = "final") -> Dict:
        """Keyframe rendering eval: renders under ``renders_kf/`` and
        ``psnr/<iteration>/final_result_kf.json``."""
        from ..utils import eval as E
        img_dir, depth_dir = self._render_dirs("renders_kf", iteration)
        m = self.mapper
        idxs = self._valid_kf()
        ps, ss, lp, l1 = [], [], [], []
        if idxs:
            ii = torch.as_tensor(idxs, device=self.device)
            imgs, depths = self._render_views_batched(
                m.cams.w2c[ii].cpu().numpy(),
                m.cams.exposure_a[ii].cpu().numpy(),
                m.cams.exposure_b[ii].cpu().numpy())
        for j, i in enumerate(idxs):
            img, depth = imgs[j], depths[j]
            gt = m.cams.image[i].cpu().numpy().astype(np.float32) / 255.0
            self._save_render(img, depth, img_dir, depth_dir, i)
            self._score(img, gt, ps, ss, lp)
            l1.append(E.depth_l1(depth, m.cams.depth[i].float().cpu().numpy()))
        return self._write_eval(iteration, "final_result_kf.json", ps, ss,
                                lp, l1)

    def eval_rendering_full(self, filled=None,
                            iteration: str = "final") -> Dict:
        """Full-trajectory eval over every 5th frame, the keyframes and the
        last frame; non-keyframe poses come from the trajectory filler's
        ``filled = (ts, poses)``. Without any, only keyframes are scored
        and the file is ``final_result_kf_only.json`` instead of
        ``final_result.json``."""
        from ..utils import eval as E
        img_dir, depth_dir = self._render_dirs("renders", iteration)
        kf, m = self.keyframes, self.mapper
        kf_ts = {int(kf.tstamp[i]): i for i in range(kf.count)}
        fill_poses = dict(zip((int(x) for x in filled[0]), filled[1])) \
            if filled else {}
        mh, mw = self.map_hw
        all_ts = sorted(self.images) if self.images else sorted(kf_ts)
        valid = m.cams.valid.cpu().numpy()
        eye3 = np.eye(3, dtype=np.float32)
        sel = []   # (t, keyframe index or None, w2c, exposure a, b)
        for j, tt in enumerate(all_ts):
            is_kf = tt in kf_ts
            if tt % 5 != 0 and not is_kf and j != len(all_ts) - 1:
                continue
            if is_kf:
                i = kf_ts[tt]
                if valid[i]:
                    sel.append((tt, i, m.cams.w2c[i].cpu().numpy(),
                                m.cams.exposure_a[i].cpu().numpy(),
                                m.cams.exposure_b[i].cpu().numpy()))
            elif tt in fill_poses:
                c2w = se3_matrix(torch.as_tensor(
                    np.asarray(fill_poses[tt], np.float32))).numpy()
                sel.append((tt, None, np.linalg.inv(c2w).astype(np.float32),
                            eye3, np.zeros(3, np.float32)))
        n_nonkf = sum(1 for x in sel if x[1] is None)
        if sel:
            imgs, depths = self._render_views_batched(
                *(np.stack([x[k] for x in sel]) for k in (2, 3, 4)))
        ps, ss, lp, l1 = [], [], [], []
        for j, (tt, i, _, _, _) in enumerate(sel):
            img, depth = imgs[j], depths[j]
            if i is not None:
                l1.append(E.depth_l1(depth,
                                     m.cams.depth[i].float().cpu().numpy()))
            if tt in self.images:
                gt = self.images[tt]
                if gt.shape[:2] != (mh, mw):
                    gt = np.stack([_resize_f(gt[..., c], mw, mh)
                                   for c in range(3)], -1)
            elif i is not None:
                gt = m.cams.image[i].cpu().numpy()
            else:
                continue
            gt = np.asarray(gt, np.float32) / 255.0
            self._save_render(img, depth, img_dir, depth_dir, tt)
            self._score(img, gt, ps, ss, lp)
        fname = "final_result.json" if n_nonkf > 0 \
            else "final_result_kf_only.json"
        return self._write_eval(iteration, fname, ps, ss, lp, l1,
                                n_views_nonkf=n_nonkf)

    def export_renders(self, outdir: str):
        """Rendered keyframe colour ``color_XXXXX.png`` and uint16 depth x
        6553.5 ``depth_XXXXX.png`` (identity exposure) for the TSDF
        pipeline."""
        import cv2
        os.makedirs(outdir, exist_ok=True)
        idxs = self._valid_kf()
        if not idxs:
            return
        ii = torch.as_tensor(idxs, device=self.device)
        imgs, depths = self._render_views_batched(
            self.mapper.cams.w2c[ii].cpu().numpy())
        for j, i in enumerate(idxs):
            color = np.clip(imgs[j] * 255, 0, 255).astype(np.uint8)
            depth = np.clip(depths[j] * 6553.5, 0, 65535).astype(np.uint16)
            cv2.imwrite(os.path.join(outdir, f"color_{i:05d}.png"),
                        cv2.cvtColor(color, cv2.COLOR_RGB2BGR))
            cv2.imwrite(os.path.join(outdir, f"depth_{i:05d}.png"), depth)

    def save_trajectory(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        kf = self.keyframes
        order = np.argsort(kf.tstamp[: kf.count])
        with open(path, "w") as f:
            for i in order:
                f.write(f"{kf.tstamp[i]} " + " ".join(
                    f"{v:.9f}" for v in kf.pose[i]) + "\n")
        np.save(os.path.join(os.path.dirname(path) or ".", "intrinsics.npy"),
                kf.intrinsic[: kf.count][order])


def build_prior_fns(mf_cfg: Dict, img_hw, device):
    """The mono prior of ``motion_filter``: (depth_fn, normal_fn), each
    (H, W, 3) uint8 image -> (H, W) depth / (H, W, 3) normal map on
    ``device``. Omnidata DPT-hybrid when ``omnidata_ckpt_depth`` or
    ``omnidata_ckpt_normal`` names a checkpoint (the image resized to
    multiples of 32 and the output back, as ``jax.image.resize``
    "bilinear"; a task without a checkpoint gives zeros); else
    ``PriorNet`` depth and normal nets of ``prior_dim`` width and
    ``prior_depth_blocks`` blocks with ``max(prior_dim // 64, 1)`` heads,
    their weights from the ``prior_ckpt`` npz (the JAX package's flax
    params, flattened under ``depth/`` and ``normal/``) or random (seeds 0
    and 1)."""
    H, W = img_hw
    omni = {t: mf_cfg.get(f"omnidata_ckpt_{t}") for t in ("depth", "normal")}
    if any(omni.values()):
        def make(task):
            if omni[task]:
                return omnidata_prior_fn(
                    load_omnidata_ckpt(omni[task], task, device), img_hw)
            shape = (H, W) if task == "depth" else (H, W, 3)
            return lambda img: torch.zeros(shape, device=device)
        return make("depth"), make("normal")

    dim = int(mf_cfg.get("prior_dim", 384))
    depth = int(mf_cfg.get("prior_depth_blocks", 12))
    ckpt = mf_cfg.get("prior_ckpt")
    raw = np.load(ckpt) if ckpt else None
    fns = []
    for seed, task in enumerate(("depth", "normal")):
        net = PriorNet(task, dim, depth, max(dim // 64, 1), device=device)
        if raw is not None:
            pre = task + "/"
            net.load_state_dict(params_from_jax(
                {k[len(pre):]: raw[k] for k in raw.files
                 if k.startswith(pre)}), strict=True)
        else:
            init_random(net, torch.Generator(device=device).manual_seed(seed))
        net.eval()
        fns.append(lambda img, net=net: net(normalize_imagenet(
            torch.as_tensor(np.asarray(img), device=device))[None])[0])
    return tuple(fns)


def omnidata_prior_fn(net, img_hw):
    """An Omnidata net as a prior function: the (H, W, 3) uint8 image in
    [0, 1] resized to multiples of 32, the net, its map resized back to
    (H, W) (``jax.image.resize`` "bilinear" both ways)."""
    H, W = img_hw
    Hn, Wn = max(32, round(H / 32) * 32), max(32, round(W / 32) * 32)

    def fn(img):
        x = torch.as_tensor(np.asarray(img), device=net.device)
        return resize_bilinear(net(resize_bilinear(
            x[None].float() / 255.0, Hn, Wn)), H, W)[0]
    return fn


def _resize_f(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    """Bilinear resize of a float map (cv2 when installed)."""
    if arr.shape[:2] == (h, w):
        return np.asarray(arr, np.float32)
    try:
        import cv2
        return cv2.resize(np.asarray(arr, np.float32), (w, h),
                          interpolation=cv2.INTER_LINEAR)
    except ImportError:
        x = torch.as_tensor(np.asarray(arr, np.float32))[None, None]
        return torch.nn.functional.interpolate(
            x, size=(h, w), mode="bilinear", align_corners=False)[0, 0].numpy()


def _resize_u8(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Bilinear resize of a uint8 colour image, channel by channel."""
    if img.shape[:2] == (h, w):
        return img
    return np.stack([_resize_f(img[..., c], w, h) for c in range(3)],
                    -1).astype(np.uint8)


def _resize_pts(pts: np.ndarray, w: int, h: int) -> np.ndarray:
    if pts.shape[:2] == (h, w):
        return np.asarray(pts, np.float32)
    return np.stack([_resize_f(pts[..., c], w, h) for c in range(3)], -1)
