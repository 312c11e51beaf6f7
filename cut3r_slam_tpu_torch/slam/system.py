"""SLAM orchestrator (port of the live loop of ``cut3r_slam_tpu/slam/
system.py``).

``run(t, img, K, img_map, K_map, second_last, last)``: keyframe filter ->
frontend submap tracking -> (freeze-gated) loop backend -> on a closure,
``mapper.gaussian_update`` and the optional Sim(3) PGBA pass -> mapping
update for the new keyframes + depth / pose writeback into the keyframe
store. ``run_test`` is the same step with ground truth injected in place
of the network's predictions (the JAX package's GT-injection driver).
``terminate(t)``: final global BA, the mapper checkpoint and the Gaussian
PLY. The configuration ported is one device, no mono prior, no GUI,
mapping drained per event (``Mapping.interleave`` = 0); asking for any of
the branches not ported raises NotImplementedError.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import CUT3R
from ..geometry.lie import se3_from_matrix
from .keyframe import KeyframeStore
from .motion_filter import MotionFilter
from .factor_graph import FactorGraph
from .frontend import TrackFrontend, pose_vec_to_matrix_np
from .backend import TrackBackend
from .mapping import MappingBackend, MappingConfig
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
        if bool(mf_cfg.get("use_prior", False)):
            _not_ported("the mono prior (motion_filter.use_prior)")
        if bool(cfg.get("GUI", {}).get("active", False)):
            _not_ported("the live viewer (GUI.active)")
        if int(mcfg.get("view_parallel", 0)) > 1:
            _not_ported("view-parallel mapping (Mapping.view_parallel)")
        if int(mcfg.get("interleave", 0)) > 0:
            _not_ported("interleaved mapping (Mapping.interleave)")
        if int(mcfg.get("gba_views_per_iter", 1)) != 1 \
                or int(mcfg.get("gba_resample_every", 1)) != 1:
            _not_ported("batched global BA (Mapping.gba_views_per_iter / "
                        "gba_resample_every)")
        if bool(mcfg.get("parallel_kf_refine", False)):
            _not_ported("batched keyframe refinement "
                        "(Mapping.parallel_kf_refine)")

        H, W = img_hw
        self.img_hw = img_hw
        self.map_hw = tuple(map_hw) if map_hw is not None else (H, W)
        self.keyframes = KeyframeStore(
            buffer, img_hw, (H // 16) * (W // 16), model.cfg.enc_embed_dim,
            map_hw=self.map_hw, device=self.device)
        self.filter = MotionFilter(model, self.keyframes,
                                   thresh=mf_cfg.get("thresh", 0.9),
                                   skip=mf_cfg.get("skip", 5),
                                   kf_every=mf_cfg.get("kf_every", 0))
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
        self.pgba = None
        if bool(pgba_cfg.get("active", False)):
            self.pgba = PGBABuffer(
                loop_weight=float(pgba_cfg.get("loop_weight", 2.0)),
                iters=int(pgba_cfg.get("iters", 6)),
                conf_weighting=bool(pgba_cfg.get("conf_weighting", False)))
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
            opt_early_stop_rel=float(mcfg.get("opt_early_stop", 0.0)),
            pose_lr=trcfg.get("pose_lr", 0.0003))
        self.output_dir = output_dir
        self.mapping_iters = mcfg.get("iterations", 100)
        self.finalize_iters = cfg.get("opt_params", {}).get(
            "position_lr_max_steps",
            trcfg.get("position_lr_max_steps", 2000))
        self.keep_all_frames = bool(cfg.get("keep_all_frames", True))
        from ..utils.image import CompressedFrameStore
        self.images = CompressedFrameStore()
        self.last_t = -1

    def _init_mapper(self, K4_map):
        mh, mw = self.map_hw
        self.mapper = MappingBackend(
            MappingConfig(height=mh, width=mw, **self._map_cfg_extra),
            np.asarray(K4_map, np.float32), device=self.device)

    def run(self, t: int, img: np.ndarray, K4: np.ndarray,
            img_map: Optional[np.ndarray] = None,
            K4_map: Optional[np.ndarray] = None,
            second_last: bool = False, last: bool = False):
        """Per-frame step. Returns (keyframe taken, new KF range or None)."""
        self.last_t = t
        if self.keep_all_frames:
            self.images[t] = img_map if img_map is not None else img
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
        run_backend, viz_range, submap_idx = self.frontend.run(t, last)
        if run_backend and self.enable_loop:
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
            self.call_mapper(viz_range, submap_idx)
        return viz_range

    def call_mapper(self, viz_range, submap_idx):
        """Build the mapping packet, run the event, write back."""
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
        self._apply_map_update(self.mapper.run(packet, self.mapping_iters))

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

    def terminate(self, t: int, eval_render: bool = False,
                  export_renders: bool = False):
        """Final flush + global BA + checkpoint and PLY dump."""
        if eval_render or export_renders:
            _not_ported("terminate-time render eval / export")
        self.frontend.run(t, last_frame=True)
        if self.mapper is not None:
            self.mapper.finalize(iters=int(self.finalize_iters))
            os.makedirs(self.output_dir, exist_ok=True)
            self.mapper.save(os.path.join(self.output_dir, "gaussians.npz"))
            from ..utils.viz import save_gaussians_ply
            save_gaussians_ply(os.path.join(self.output_dir,
                                            "3dgs_final.ply"),
                               self.mapper.arena)
        return {}

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


def _resize_pts(pts: np.ndarray, w: int, h: int) -> np.ndarray:
    if pts.shape[:2] == (h, w):
        return np.asarray(pts, np.float32)
    return np.stack([_resize_f(pts[..., c], w, h) for c in range(3)], -1)
