"""DROID-SLAM's frontend as a tracker of ``SLAMSystem`` (Teed & Deng,
NeurIPS 2021, arXiv:2108.10869; the public code's ``motion_filter.py``,
``factor_graph.py``, ``droid_frontend.py`` and ``depth_video.py``), on
``DroidNet``'s modules (``models/droid_net.py``), the correlation of
``ops/corr.py`` and the dense BA of ``ops/ba.py``.

- ``DroidVideo``: the keyframe state at 1/8 of the image: fmaps (fnet's
  128 channels), the context ``net`` / ``inp`` (cnet's 256 split 128 /
  128, tanh / relu), disparities, world-to-camera poses, intrinsics / 8
  and each frame's BA damping. The images, timestamps and the camera-
  to-world poses and depths the mapper reads are the ``KeyframeStore``'s,
  slot for slot.
- ``CorrCache``: each edge's 4-level correlation pyramid, built once when
  the edge is added, in a pool of slots; an edge's slot is freed when the
  edge ages out or is pruned (the role a KV cache plays in a language
  model). ``lookup`` samples the (2r+1)^2 window of every level around
  each edge's reprojected pixels (``ops/corr.corr_lookup`` on the pool).
- ``DroidMotionFilter``: fnet on every frame, one update step against the
  last keyframe, a keyframe when the mean |delta| exceeds ``thresh``; with
  ``kf_every`` > 0 the fixed-interval rule of ``motion_filter.py``
  (frames off the interval are not encoded); with a mono prior, each
  keyframe's depth and normal maps into the store
  (``motion_filter.store_priors``), as HI-SLAM2 computes Omnidata's on
  every keyframe it takes.
- ``DroidGraph``: the factor graph of edges (i, j) with their age, hidden
  state, context features, cached pyramid, target and weight;
  neighbourhood and proximity factors (``frame_distance``), the
  ``max_factors`` cap (the oldest removed), ``max_age`` retirement into
  the inactive edges the BA keeps using, keyframe removal; ``update``:
  reprojection, motion features clamped to +-64, the lookup, the update
  operator, ``target = coords1 + delta`` and the dense BA over the window
  with the oldest frames fixed.
- ``DroidFrontend``: the initialisation at ``warmup`` keyframes and the
  per-keyframe update loop, then the writeback into the ``KeyframeStore``:
  every window pose after each update, and a keyframe's depth (1 /
  disparity upsampled by ``cvx_upsample`` with its last update's mask) and
  half-resolution world pointmap once it can no longer be removed; a
  mapping event for every ``SUBMAP_SIZE`` such keyframes.

Precision, DROID-SLAM's public code's: on the card the encoders and the
update operator run under float16 autocast and the fmaps, ``net``,
``inp`` and the pyramids are stored in float16; on the CPU all is
float32. Reprojection, motion features, the lookup's bilinear weights and
the BA are float32.

Spans (``utils.profiling``): ``droid.filter``, ``droid.encode``,
``droid.corr_build``, ``droid.update``, ``droid.corr_lookup``,
``droid.gru``, ``droid.ba``; counters ``droid.edges`` (active edges of
each update), ``droid.ba.edges`` (the BA's edges, active and retired, of
each update), ``droid.updates``, ``droid.kf_removed``; ``ops/ba.py``
counts the BA's steps by path (``ba.steps.kernel``, ``ba.steps.plain``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry.lie import se3_inv, se3_matrix, se3_mul
from ..geometry.projective import MIN_DEPTH, coords_grid, \
    projective_transform
from ..models.droid_net import DroidNet, cvx_upsample
from ..ops.ba import bundle_adjust
from ..ops.corr import build_corr_pyramid, corr_lookup
from ..utils.profiling import count, span
from .keyframe import KeyframeStore, SUBMAP_SIZE
from .motion_filter import store_priors

__all__ = ["DROID_DEFAULTS", "DroidVideo", "CorrCache", "DroidGraph",
           "DroidMotionFilter", "DroidFrontend", "frame_distance",
           "store_dtype"]

# DROID-SLAM's demo settings (``demo.py``'s arguments; ``Tracking.droid``)
DROID_DEFAULTS = dict(
    filter_thresh=2.4, warmup=8, keyframe_thresh=4.0, frontend_thresh=16.0,
    frontend_window=25, frontend_radius=2, frontend_nms=1, beta=0.3)
# the frontend's and the factor graph's constants in DROID-SLAM's code
MAX_FACTORS = 48   # active edges
MAX_AGE = 25       # updates an edge stays active
ITERS1, ITERS2 = 4, 2       # updates a keyframe, before and after removal
INIT_ITERS, INIT_RADIUS = 8, 3
BA_ITERS = 2       # Gauss-Newton iterations of each update's BA
CORR_LEVELS, CORR_RADIUS = 4, 3   # 4 x 7 x 7 = DroidNet's 196 planes
EP = 1e-7          # the BA damping's floor added to 0.2 x eta
FAR = 1000.0       # the distance of a pair seen by under 75% of pixels


def store_dtype(device) -> torch.dtype:
    """The dtype of the fmaps, context and pyramids: float16 on the card,
    float32 on the CPU."""
    return torch.float16 if torch.device(device).type == "cuda" \
        else torch.float32


def _amp(device):
    """The encoders' and the update operator's float16 autocast on the
    card; nothing on the CPU."""
    if torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return torch.autocast("cuda", dtype=torch.float16)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# keyframe state
# ---------------------------------------------------------------------------
class DroidVideo:
    """The keyframes' device state at 1/8 of the image; ``count`` is a host
    int. Poses are world-to-camera SE3 7-vectors [t, q xyzw], identity
    until set; disparities 1 until set."""

    def __init__(self, capacity: int, img_hw, device):
        H, W = img_hw
        h, w = H // 8, W // 8
        self.capacity, self.hw = int(capacity), (h, w)
        self.count = 0
        dev = torch.device(device)
        self.poses = torch.zeros(capacity, 7, device=dev)
        self.poses[:, 6] = 1.0
        self.disps = torch.ones(capacity, h, w, device=dev)
        self.intrinsics = torch.zeros(capacity, 4, device=dev)
        self.damping = torch.full((capacity, h, w), 1e-6, device=dev)
        self.fmaps = torch.zeros(capacity, 128, h, w, device=dev,
                                 dtype=store_dtype(dev))
        self.nets = torch.zeros_like(self.fmaps)
        self.inps = torch.zeros_like(self.fmaps)
        # the last update's upsampling mask of each keyframe not yet
        # written back (from ``upmask_from`` on), for the depth writeback
        self.upmask: Dict[int, torch.Tensor] = {}
        self.upmask_from = 0

    _SHIFTED = ("poses", "disps", "intrinsics", "damping", "fmaps", "nets",
                "inps")

    def append(self, fmap, net, inp, intrinsics8, first: bool):
        i = self.count
        if i >= self.capacity:
            raise RuntimeError(f"DROID keyframe buffer full ({self.capacity})")
        self.fmaps[i] = fmap
        self.nets[i] = net
        self.inps[i] = inp
        self.intrinsics[i] = intrinsics8
        if first:
            self.poses[i] = self.poses.new_tensor([0, 0, 0, 0, 0, 0, 1.0])
            self.disps[i] = 1.0
        self.count += 1

    def remove(self, ix: int):
        """Drop keyframe ``ix``: every later slot moves down by one."""
        n = self.count
        for name in self._SHIFTED:
            buf = getattr(self, name)
            buf[ix:n - 1] = buf[ix + 1:n].clone()
        self.upmask = {(k - 1 if k > ix else k): v
                       for k, v in self.upmask.items() if k != ix}
        self.count -= 1

    def distance(self, ii, jj, beta: float) -> torch.Tensor:
        """DROID's bidirectional frame distance of the pairs (ii, jj)
        (host sequences): the mean of both directions'."""
        n = self.count
        ii = torch.as_tensor(np.asarray(ii), dtype=torch.long,
                             device=self.poses.device)
        jj = torch.as_tensor(np.asarray(jj), dtype=torch.long,
                             device=self.poses.device)
        args = (self.poses[:n], self.disps[:n], self.intrinsics[:n])
        return 0.5 * (frame_distance(*args, ii, jj, beta)
                      + frame_distance(*args, jj, ii, beta))


@torch.no_grad()
def frame_distance(poses, disps, intrinsics, ii, jj, beta: float):
    """The mean flow that frame i's pixels take into frame j, over the
    pixels in front of both cameras: (1 - beta) x the full flow's magnitude
    + beta x that of the translation alone; ``FAR`` where fewer than 75%
    of the pixels are in front of both."""
    h, w = disps.shape[-2:]
    grid = coords_grid(h, w, disps.dtype, disps.device)
    coords, valid = projective_transform(poses, disps, intrinsics, ii, jj)
    full = (coords - grid).norm(dim=-1)
    t = se3_mul(poses[jj], se3_inv(poses[ii]))[:, :3, None, None]
    fx, fy, cx, cy = intrinsics[ii][:, :, None, None].unbind(1)
    d = disps[ii]
    X = (grid[..., 0] - cx) / fx + d * t[:, 0]
    Y = (grid[..., 1] - cy) / fy + d * t[:, 1]
    Z = 1.0 + d * t[:, 2]
    ok = valid[..., 0] * (Z > MIN_DEPTH).to(d.dtype)
    Z = torch.where(Z > MIN_DEPTH, Z, torch.ones_like(Z))
    trans = torch.hypot(fx * X / Z + cx - grid[..., 0],
                        fy * Y / Z + cy - grid[..., 1])
    cnt = ok.sum((1, 2))
    dist = (((1 - beta) * full + beta * trans) * ok).sum((1, 2)) \
        / torch.clamp(cnt, min=1.0)
    return torch.where(cnt >= 0.75 * h * w, dist, torch.full_like(dist, FAR))


# ---------------------------------------------------------------------------
# the correlation cache
# ---------------------------------------------------------------------------
class CorrCache:
    """Per-edge correlation pyramids in a pool of slots: level l holds
    (slots x h w, h_l, w_l) in ``dtype``. ``add`` builds the pyramids of new
    edges into free slots (the pool doubles when none is free); ``free``
    returns slots; ``lookup`` samples the edges' windows."""

    def __init__(self, hw, device, dtype=torch.float32, slots: int = 56):
        self.hw = tuple(hw)
        self.dtype, self.device = dtype, torch.device(device)
        self.levels: List[torch.Tensor] = []
        self.free_slots: List[int] = []
        self._grow(slots)

    @property
    def n_slots(self) -> int:
        return self.levels[0].shape[0] // (self.hw[0] * self.hw[1])

    def _grow(self, n: int):
        h, w = self.hw
        old = self.n_slots if self.levels else 0
        new = []
        for lvl in range(CORR_LEVELS):
            buf = torch.zeros((old + n) * h * w, h >> lvl, w >> lvl,
                              device=self.device, dtype=self.dtype)
            if old:
                buf[:old * h * w] = self.levels[lvl]
            new.append(buf)
        self.levels = new
        self.free_slots += list(range(old, old + n))

    def in_use(self) -> int:
        return self.n_slots - len(self.free_slots)

    def add(self, fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
        """fmap1 / fmap2 (k, 128, h, w) of the new edges' frames i / j ->
        their slots (k,) on the device."""
        k = fmap1.shape[0]
        if len(self.free_slots) < k:
            self._grow(max(k, self.n_slots))
        got, self.free_slots = self.free_slots[:k], self.free_slots[k:]
        h, w = self.hw
        with span("droid.corr_build"):
            pyr = build_corr_pyramid(_nhwc(fmap1).to(self.dtype),
                                     _nhwc(fmap2).to(self.dtype),
                                     CORR_LEVELS)
            slots = torch.as_tensor(got, device=self.device)
            rows = (slots[:, None] * (h * w) + torch.arange(
                h * w, device=self.device)).reshape(-1)
            for lvl, p in enumerate(pyr):
                self.levels[lvl][rows] = p.reshape(
                    k * h * w, *p.shape[-2:]).to(self.dtype)
        return slots

    def free(self, slots: torch.Tensor):
        self.free_slots += [int(s) for s in slots.tolist()]

    def lookup(self, slots: torch.Tensor, coords: torch.Tensor
               ) -> torch.Tensor:
        """coords (E, h, w, 2) of the edges in ``slots`` (E,) -> (E, h, w,
        L (2r+1)^2)."""
        h, w = self.hw
        rows = (slots[:, None] * (h * w) + torch.arange(
            h * w, device=slots.device)).reshape(-1, h, w)
        with span("droid.corr_lookup"):
            return corr_lookup(self.levels, coords, CORR_RADIUS,
                               rows).to(self.dtype)


# ---------------------------------------------------------------------------
# the factor graph
# ---------------------------------------------------------------------------
class DroidGraph:
    """DROID's factor graph. Host: ``ii``, ``jj``, ``age`` and the inactive
    edges' (``ii_inac``, ``jj_inac``); device, edge-aligned: ``slots``
    (pyramids in ``cache``), ``net``, ``inp`` (E, 128, h, w), ``target``,
    ``weight`` (E, h, w, 2); the inactive edges' ``target_inac`` /
    ``weight_inac``."""

    def __init__(self, net: DroidNet, video: DroidVideo,
                 max_factors: int = MAX_FACTORS):
        self.video = video
        self.update_op = net.update
        h, w = video.hw
        dev = video.poses.device
        self.device = dev
        self.coords0 = coords_grid(h, w, torch.float32, dev)
        self.cache = CorrCache((h, w), dev, video.fmaps.dtype,
                               max_factors + 8)
        self.max_factors = int(max_factors)
        z = np.zeros(0, np.int64)
        self.ii, self.jj, self.age = z, z.copy(), z.copy()
        self.ii_inac, self.jj_inac = z.copy(), z.copy()
        self.slots = torch.zeros(0, dtype=torch.long, device=dev)
        self.net = torch.zeros(0, 128, h, w, device=dev,
                               dtype=video.fmaps.dtype)
        self.inp = torch.zeros_like(self.net)
        self.target = torch.zeros(0, h, w, 2, device=dev)
        self.weight = torch.zeros_like(self.target)
        self.target_inac = torch.zeros_like(self.target)
        self.weight_inac = torch.zeros_like(self.target)

    def __len__(self):
        return len(self.ii)

    # ---- edges ------------------------------------------------------------
    def _known(self):
        return set(zip(self.ii.tolist(), self.jj.tolist())) | set(
            zip(self.ii_inac.tolist(), self.jj_inac.tolist()))

    @torch.no_grad()
    def add_factors(self, ii, jj, remove: bool = False):
        """Add the edges (ii, jj) not already active or inactive; with
        ``remove``, the oldest edges first make room under
        ``max_factors``."""
        known = self._known()
        pairs = [(int(i), int(j)) for i, j in zip(ii, jj)]
        keep, seen = [], set()
        for p in pairs:
            if p not in known and p not in seen:
                keep.append(p)
                seen.add(p)
        if not keep:
            return
        ii = np.asarray([p[0] for p in keep], np.int64)
        jj = np.asarray([p[1] for p in keep], np.int64)
        if remove and self.max_factors > 0 and \
                len(self.ii) + len(ii) > self.max_factors and len(self.ii):
            # the oldest edges (the stable order of age, youngest first)
            # beyond max_factors - new go to the inactive edges
            order = np.argsort(self.age, kind="stable")
            drop = np.zeros(len(self.ii), bool)
            drop[order[max(self.max_factors - len(ii), 0):]] = True
            self.rm_factors(drop, store=True)
        v = self.video
        dev = self.device
        iit = torch.as_tensor(ii, device=dev)
        jjt = torch.as_tensor(jj, device=dev)
        slots = self.cache.add(v.fmaps[iit], v.fmaps[jjt])
        target, _ = projective_transform(v.poses, v.disps, v.intrinsics,
                                         iit, jjt)
        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros(len(ii), np.int64)])
        self.slots = torch.cat([self.slots, slots])
        self.net = torch.cat([self.net, v.nets[iit]])
        self.inp = torch.cat([self.inp, v.inps[iit]])
        self.target = torch.cat([self.target, target])
        self.weight = torch.cat([self.weight, torch.zeros_like(target)])

    def rm_factors(self, mask: np.ndarray, store: bool = False):
        """Drop the edges where ``mask``; with ``store`` their targets and
        weights join the inactive edges. Their pyramids' slots are freed."""
        mask = np.asarray(mask, bool)
        if not mask.any():
            return
        m = torch.as_tensor(mask, device=self.device)
        if store:
            self.ii_inac = np.concatenate([self.ii_inac, self.ii[mask]])
            self.jj_inac = np.concatenate([self.jj_inac, self.jj[mask]])
            self.target_inac = torch.cat([self.target_inac, self.target[m]])
            self.weight_inac = torch.cat([self.weight_inac, self.weight[m]])
        self.cache.free(self.slots[m])
        keep = ~m
        self.ii, self.jj, self.age = (a[~mask] for a in
                                      (self.ii, self.jj, self.age))
        self.slots = self.slots[keep]
        self.net, self.inp = self.net[keep], self.inp[keep]
        self.target, self.weight = self.target[keep], self.weight[keep]

    def rm_keyframe(self, ix: int):
        """Remove keyframe ``ix`` from the video and every edge touching
        it; later frames' indices move down by one."""
        self.video.remove(ix)
        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.ii_inac = self.ii_inac - (self.ii_inac >= ix)
        self.jj_inac = self.jj_inac - (self.jj_inac >= ix)
        if m.any():
            mt = torch.as_tensor(~m, device=self.device)
            self.ii_inac, self.jj_inac = self.ii_inac[~m], self.jj_inac[~m]
            self.target_inac = self.target_inac[mt]
            self.weight_inac = self.weight_inac[mt]
        m = (self.ii == ix) | (self.jj == ix)
        self.ii = self.ii - (self.ii >= ix)
        self.jj = self.jj - (self.jj >= ix)
        self.rm_factors(m, store=False)

    def add_neighborhood_factors(self, t0: int, t1: int, r: int = 3):
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1),
                             indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        keep = (np.abs(ii - jj) > 0) & (np.abs(ii - jj) <= r)
        self.add_factors(ii[keep], jj[keep])

    def add_proximity_factors(self, t0: int = 0, t1: int = 0, rad: int = 2,
                              nms: int = 2, beta: float = 0.25,
                              thresh: float = 16.0, remove: bool = False):
        """Edges between frames in [t0, t) and [t1, t) by frame distance,
        closest first under ``thresh``, with non-maximum suppression of
        ``nms`` around every kept and existing edge, up to ``max_factors``;
        the neighbours within ``rad`` + 1 of every frame of [t0, t) too."""
        t = self.video.count
        t0, t1 = max(t0, 0), max(t1, 0)
        ix, jx = np.arange(t0, t), np.arange(t1, t)
        ii, jj = np.meshgrid(ix, jx, indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        d = self.video.distance(ii, jj, beta).cpu().numpy().astype(np.float64)
        d[ii - rad < jj] = np.inf
        d[d > 100] = np.inf
        nj = t - t1

        def suppress(i, j):
            for di in range(-nms, nms + 1):
                for dj in range(-nms, nms + 1):
                    if abs(di) + abs(dj) <= max(min(abs(i - j) - 2, nms), 0):
                        i1, j1 = i + di, j + dj
                        if t0 <= i1 < t and t1 <= j1 < t:
                            d[(i1 - t0) * nj + (j1 - t1)] = np.inf
        for i, j in zip(np.concatenate([self.ii, self.ii_inac]).tolist(),
                        np.concatenate([self.jj, self.jj_inac]).tolist()):
            suppress(i, j)
        es = []
        for i in range(t0, t):
            for j in range(max(i - rad - 1, 0), i):
                es += [(i, j), (j, i)]
                if j >= t1:
                    d[(i - t0) * nj + (j - t1)] = np.inf
        for k in np.argsort(d, kind="stable"):
            if d[k] > thresh:
                continue
            if len(es) > self.max_factors:
                break
            i, j = int(ii[k]), int(jj[k])
            es += [(i, j), (j, i)]
            suppress(i, j)
        if es:
            e = np.asarray(es, np.int64)
            self.add_factors(e[:, 0], e[:, 1], remove)

    # ---- the update -------------------------------------------------------
    @torch.no_grad()
    def update(self, t0: Optional[int] = None):
        """One update iteration over the active edges, then the dense BA of
        the window over them and the inactive edges between frames from
        ``t0`` - 3 on (frames before ``t0`` fixed; default: after the
        oldest source frame, at least 1)."""
        v, dev = self.video, self.device
        with span("droid.update"):
            count("droid.updates")
            count("droid.edges", len(self.ii))
            if t0 is None:
                t0 = max(1, int(self.ii.min()) + 1)
            m = (self.ii_inac >= t0 - 3) & (self.jj_inac >= t0 - 3)
            ii_all = np.concatenate([self.ii_inac[m], self.ii])
            jj_all = np.concatenate([self.jj_inac[m], self.jj])
            lo = int(min(ii_all.min(), jj_all.min()))
            hi = int(max(ii_all.max(), jj_all.max())) + 1
            n_win = hi - lo
            ii_loc = torch.as_tensor(self.ii - lo, device=dev)
            jj_loc = torch.as_tensor(self.jj - lo, device=dev)
            poses, disps = v.poses[lo:hi], v.disps[lo:hi]
            intr = v.intrinsics[lo:hi]
            coords1, _ = projective_transform(poses, disps, intr, ii_loc,
                                              jj_loc)
            motion = torch.cat([coords1 - self.coords0,
                                self.target - coords1], -1).clamp(-64.0, 64.0)
            corr = self.cache.lookup(self.slots, coords1)
            with span("droid.gru"), _amp(dev):
                net, delta, weight, eta, upmask = self.update_op(
                    self.net, self.inp, _nchw(corr), _nchw(motion), ii_loc,
                    n_win)
            self.net = net.to(self.net.dtype)
            self.target = coords1 + _nhwc(delta).float()
            self.weight = _nhwc(weight).float()
            src = np.unique(self.ii) - lo
            src_t = torch.as_tensor(src, device=dev)
            v.damping[lo + src_t] = eta.float()[src_t]
            for s in src.tolist():
                if lo + s >= v.upmask_from:
                    v.upmask[lo + s] = upmask[s].clone()
            mt = torch.as_tensor(m, device=dev)
            target = torch.cat([self.target_inac[mt], self.target])
            weight = torch.cat([self.weight_inac[mt], self.weight])
            eta_ba = 0.2 * v.damping[lo:hi] + EP
            with span("droid.ba"):
                count("droid.ba.edges", len(ii_all))
                p, d, _ = bundle_adjust(
                    target, weight, eta_ba, poses, disps, intr,
                    torch.as_tensor(ii_all - lo, device=dev),
                    torch.as_tensor(jj_all - lo, device=dev),
                    torch.ones(len(ii_all), device=dev), fixedp=t0 - lo,
                    n_frames=n_win, steps=BA_ITERS)
            v.poses[lo:hi] = p
            v.disps[lo:hi] = d
            self.age = self.age + 1


# ---------------------------------------------------------------------------
# the motion filter
# ---------------------------------------------------------------------------
class DroidMotionFilter:
    """Keyframe selection by DROID's flow filter (``thresh`` on the mean
    |delta| of one update step against the last keyframe), or every
    ``kf_every`` frames; frame 0 and a sequence's last two frames are
    always taken. A keyframe's fmap, context and intrinsics / 8 go into
    the video, its image, timestamp and intrinsics into the keyframe
    store, and with ``prior = (depth_fn, normal_fn)`` its prior maps into
    the store's prior buffers."""

    def __init__(self, net: DroidNet, keyframes: KeyframeStore,
                 video: DroidVideo, thresh: float = 2.4, kf_every: int = 0,
                 prior=None):
        self.net, self.keyframes, self.video = net, keyframes, video
        self.device = video.poses.device
        self.thresh, self.kf_every = float(thresh), int(kf_every)
        self.fmap = self.ctx = None   # the last keyframe's fmap, (net, inp)
        self.prior = prior
        if prior is not None:
            keyframes.ensure_prior_buffers()

    def _input(self, image_u8):
        x = torch.as_tensor(np.asarray(image_u8), device=self.device)
        mean = x.new_tensor((0.485, 0.456, 0.406), dtype=torch.float32)
        std = x.new_tensor((0.229, 0.224, 0.225), dtype=torch.float32)
        return _nchw((x[None].float() / 255.0 - mean) / std)

    @torch.no_grad()
    def encode(self, image_u8):
        """fnet's fmap (1, 128, h, w) of an image (the fnet span)."""
        with span("droid.encode"), _amp(self.device):
            return self.net.fnet(self._input(image_u8))

    @torch.no_grad()
    def context(self, image_u8):
        """cnet's (net, inp), each (1, 128, h, w)."""
        with span("droid.encode"), _amp(self.device):
            net, inp = self.net.cnet(self._input(image_u8)).split(128, 1)
            return torch.tanh(net), F.relu(inp)

    @torch.no_grad()
    def motion(self, fmap) -> float:
        """Mean |delta| of one update step from the last keyframe to
        ``fmap`` at zero flow."""
        pyr = build_corr_pyramid(_nhwc(self.fmap), _nhwc(fmap))
        h, w = self.video.hw
        coords0 = coords_grid(h, w, torch.float32, fmap.device)[None]
        corr = corr_lookup(pyr, coords0)
        with _amp(self.device):
            _, delta, _, _, _ = self.net.update(
                self.ctx[0], self.ctx[1], _nchw(corr).to(fmap.dtype),
                fmap.new_zeros(1, 4, h, w),
                torch.zeros(1, dtype=torch.long, device=fmap.device), 1)
        return float(delta.float().norm(dim=1).mean())

    @torch.no_grad()
    def __call__(self, tstamp: int, image_u8: np.ndarray,
                 intrinsic: Optional[np.ndarray] = None,
                 pose=None, depth=None, second_last: bool = False,
                 last: bool = False, image_map=None,
                 intrinsic_map=None) -> bool:
        """Run on every frame; returns True if a keyframe was added."""
        kf = self.keyframes
        with span("droid.filter"):
            take = kf.count == 0 or last or second_last
            if not take and self.kf_every > 0:
                if tstamp % self.kf_every:
                    return False
                take = True
            fmap = self.encode(image_u8)
            if not take:
                take = self.motion(fmap) > self.thresh
            if not take:
                return False
            self.fmap, self.ctx = fmap, self.context(image_u8)
            K = torch.as_tensor(np.asarray(intrinsic, np.float32),
                                device=fmap.device)
            self.video.append(fmap[0], self.ctx[0][0], self.ctx[1][0],
                              K / 8.0, first=kf.count == 0)
            i = kf.append(tstamp, image_u8, intrinsic=intrinsic,
                          image_map=image_map, intrinsic_map=intrinsic_map)
            if self.prior is not None:
                store_priors(kf, self.prior, i, image_u8)
        return True


# ---------------------------------------------------------------------------
# the frontend
# ---------------------------------------------------------------------------
class DroidFrontend:
    """DROID's frontend over the video and graph, with the writeback into
    the keyframe store (``run`` has ``TrackFrontend.run``'s interface:
    (run the loop backend, new keyframe range to map, submap index); it
    never asks for the loop backend)."""

    def __init__(self, net: DroidNet, keyframes: KeyframeStore,
                 video: DroidVideo, graph: DroidGraph, cfg: Dict,
                 remove_keyframes: bool = True):
        self.net, self.keyframes = net, keyframes
        self.video, self.graph, self.cfg = video, graph, cfg
        self.remove_keyframes = remove_keyframes
        self.is_initialized = False
        self.t1 = 0
        self.committed = 0      # keyframes whose depth is written back
        self.handed = 0         # keyframes handed to the mapper

    # ---- DROID's loop ------------------------------------------------------
    def _initialize(self):
        c, g, v = self.cfg, self.graph, self.video
        self.t1 = v.count
        g.add_neighborhood_factors(0, self.t1, r=INIT_RADIUS)
        for _ in range(INIT_ITERS):
            g.update(1)
        g.add_proximity_factors(0, 0, rad=2, nms=2,
                                thresh=c["frontend_thresh"], remove=False)
        for _ in range(INIT_ITERS):
            g.update(1)
        v.poses[self.t1] = v.poses[self.t1 - 1]
        v.disps[self.t1] = v.disps[self.t1 - 4:self.t1].mean()
        self.is_initialized = True
        g.rm_factors(g.ii < c["warmup"] - 4, store=True)

    def _update(self):
        c, g, v = self.cfg, self.graph, self.video
        self.t1 += 1
        if len(g.ii) or len(g.ii_inac):
            g.rm_factors(g.age > MAX_AGE, store=True)
        g.add_proximity_factors(
            self.t1 - 5, max(self.t1 - c["frontend_window"], 0),
            rad=c["frontend_radius"], nms=c["frontend_nms"],
            thresh=c["frontend_thresh"], beta=c["beta"], remove=True)
        for _ in range(ITERS1):
            g.update()
        removed = False
        if self.remove_keyframes:
            d = float(v.distance([self.t1 - 3], [self.t1 - 2], c["beta"])[0])
            if d < c["keyframe_thresh"]:
                g.rm_keyframe(self.t1 - 2)
                self.keyframes.remove(self.t1 - 2)
                self.t1 -= 1
                removed = True
                count("droid.kf_removed")
        if not removed:
            for _ in range(ITERS2):
                g.update()
        v.poses[self.t1] = v.poses[self.t1 - 1]
        v.disps[self.t1] = v.disps[self.t1 - 1].mean()

    # ---- writeback ---------------------------------------------------------
    def _write_poses(self, lo: int):
        """Camera-to-world [t, q xyzw] of keyframes [lo, count) into the
        store."""
        n = self.video.count
        if n > lo:
            self.keyframes.pose[lo:n] = se3_inv(
                self.video.poses[lo:n]).cpu().numpy()

    @torch.no_grad()
    def _commit(self, upto: int):
        """Depths (1 / disparity, convex-upsampled with the frame's last
        update mask) and half-resolution world pointmaps of keyframes
        [committed, upto) into the store."""
        kf, v = self.keyframes, self.video
        lo = self.committed
        if upto <= lo:
            return
        idx = list(range(lo, upto))
        disps = v.disps[lo:upto][:, None]
        masks = [v.upmask.get(i) for i in idx]
        if all(m is not None for m in masks):
            up = cvx_upsample(disps, torch.stack(masks).float())
        else:
            up = F.interpolate(disps, scale_factor=8, mode="bilinear",
                               align_corners=False)
        depth = 1.0 / torch.clamp(up[:, 0], min=1e-3)
        kf.depth[lo:upto] = depth.cpu().numpy()
        K = torch.as_tensor(kf.intrinsic[lo:upto], device=depth.device)
        c2w = torch.as_tensor(kf.pose[lo:upto], device=depth.device)
        kf.pts_ds[lo:upto] = _world_points(depth[:, ::2, ::2], K / 2.0, c2w)
        for i in idx:
            v.upmask.pop(i, None)
        v.upmask_from = upto
        self.committed = upto

    @torch.no_grad()
    def run(self, tstamp: int, last_frame: bool = False
            ) -> Tuple[bool, Optional[range], Optional[int]]:
        """Per-frame trigger: the initialisation once ``warmup`` keyframes
        are in, then one update per new keyframe; the writeback. Returns
        (False, new keyframe range to map or None, None)."""
        c, v = self.cfg, self.video
        if not self.is_initialized and v.count == c["warmup"]:
            self._initialize()
        elif self.is_initialized and self.t1 < v.count:
            self._update()
        else:
            if not last_frame:
                return False, None, None
        if self.is_initialized:
            lo = int(min(self.graph.ii.min(), self.graph.jj.min())) \
                if len(self.graph) else 0
            self._write_poses(min(lo, self.committed))
            self._commit(v.count if last_frame else max(self.t1 - 2, 0))
        elif last_frame:
            self._write_poses(0)
            self._commit(v.count)
        done = self.committed
        if done - self.handed >= SUBMAP_SIZE or (last_frame
                                                 and done > self.handed):
            viz = range(max(self.handed - 1, 0), done)
            self.handed = done
            return False, viz, None
        return False, None, None


def _world_points(depth, K, c2w):
    """(N, h, w) depths, (N, 4) intrinsics at that size and (N, 7)
    camera-to-world poses -> (N, h, w, 3) world points."""
    h, w = depth.shape[-2:]
    grid = coords_grid(h, w, depth.dtype, depth.device)
    fx, fy, cx, cy = (K[:, k, None, None] for k in range(4))
    x = (grid[..., 0] - cx) / fx * depth
    y = (grid[..., 1] - cy) / fy * depth
    p = torch.stack([x, y, depth], -1)
    M = se3_matrix(c2w)
    return torch.einsum("nij,nhwj->nhwi", M[:, :3, :3], p) \
        + M[:, None, None, :3, 3]
