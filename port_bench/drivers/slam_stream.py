"""The SLAM driver: a video through the port's live ``SLAMSystem.run``, in
a closed loop as an offline video is processed (the next frame follows
the previous one's return and a device synchronize).

Set-up: CUT3R's weights drawn from the seed on the device, the video
drawn from the seed, the kernels built, then a warm-up through a
throwaway system at the cell's shapes with the mapping iteration counts
cut (``warmup`` in the traffic file), discarded. The window starts at
frame 0 of a fresh system and ends at the end of the first frame that
finishes at or after ``--seconds``; the frames, and every mapping slice
they ran, count.

The benchmark listens at the program's layer boundaries while the window
runs (``Recorder``): each submap decode's output (``infer_views``), each
render the mapper asks for (``render_window`` / ``render_view`` as
``slam/mapping.py`` calls them) with the binning it was given, the
mapper's window-loss and global-BA batch calls with the gradients that
their backward produced, and the mapper's Adam steps. Drawn from the
seed, a few renders of any size and a few of several views are kept with
their inputs, one window-loss call, one global-BA batch and one Adam step
with its state. After the window the reference judges them:

- tracking: the window's decodes (all, or a sample of ``check_decodes``),
  recomputed by the reference CUT3R (encoder and decoder, float32) from
  the frames themselves: the self pointmaps and confidences are compared,
  the poses read;
- rendering: of each kind, the first kept render that shows something:
  its colour and depth, recomputed by the plain rasterizer from the kept
  inputs (binned where the program binned, at the parameters it binned
  at);
- the mapper's losses: the kept window-loss call and global-BA batch,
  recomputed by the plain loss over the plain rasterizer
  (``reference/map_loss.py``) on the keyframes' frames, the program's
  depth targets, parameters, poses and exposures as the call got them:
  the loss and the gradient of every leaf (Gaussians on alive slots, pose
  deltas, exposure) that the program's backward produced;
- the kept Adam step's update against a plain Adam from the same state.
"""
from __future__ import annotations

import contextlib
import copy
import shutil
import tempfile
import time

import numpy as np
import torch

from port_bench import flops, frames as F
from port_bench.compare import Check, centered_gap, rel_gap, rel_gap_by_leaf
from port_bench.harness import patched
from port_bench.reference import cut3r as ref_cut3r
from port_bench.reference import map_loss as ref_loss
from port_bench.reference import raster as ref_raster
from port_bench.reference.adam import adam_step
from port_bench.trace import Profile, Spans, reduce
from port_bench.weights import model_weights, reference_config

# ---------------------------------------------------------------------------
# faults a test plants under the timed path (the check must fail each)
# ---------------------------------------------------------------------------
FAULTS = ("state_unchanged", "half_batch", "answer_altered")
KEEP = 4     # renders kept per kind for the check


def _merge(base, over):
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def build_model(config, seed, device):
    """The port's CUT3R at the configuration's widths and compute dtype,
    with the benchmark's weights for ``seed``."""
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    widths = config["model"]["widths"]
    dtype = getattr(torch, config["model"]["compute_dtype"])
    with torch.device(device):
        model = CUT3R(CUT3RConfig(**widths, compute_dtype=dtype),
                      device=device)
    model.load_state_dict(model_weights(config["model"], seed, device),
                          strict=True)
    return model.eval()


class Recorder:
    """Listens at the program's layer boundaries during the window: counts
    encodes, decodes, rendered views and Adam steps, and keeps the decodes'
    outputs, a few renders and one Adam step drawn from ``rng``. ``fault``
    plants one of ``FAULTS`` underneath (tests)."""

    def __init__(self, rng, fault=None, keep_decodes=None, tstamps=None):
        self.rng = rng
        self.fault = fault
        self.tstamps = tstamps       # keyframe slot -> frame number
        self.decodes = []            # (tstamps, pts, conf, c2w)
        self.decodes_seen = 0
        self.keep_decodes = keep_decodes  # a reservoir of so many, or all
        self.encodes = 0
        self.views_fwd = 0           # views rendered without gradient
        self.views_grad = 0          # views rendered for a gradient
        self.seen = {"any": 0, "multi": 0}
        # the kept renders, inputs and outputs: a few drawn from all the
        # mapper's renders, a few from those of several views at once
        # (reservoirs of KEEP); the check takes the first of each that
        # shows something (an empty view compares nothing)
        self.renders = {"any": [], "multi": []}
        self.adam_seen = 0
        self.adam = None             # the kept Adam step
        self._binned = (None, None)  # the last binning and its inputs
        self._images = (None, None)  # the last keyframe images and slots
        self.loss_seen = {"window": 0, "gba": 0}
        self.losses = {}             # the kept window-loss and BA calls

    # ---- tracking ---------------------------------------------------------
    def infer_views(self, frontend, orig):
        def wrapped(idxs):
            pts, conf, c2w = orig(idxs)
            if self.fault == "answer_altered":
                pts = pts.clone()
                pts[1] = pts[2]
            ts = [int(frontend.keyframes.tstamp[i]) for i in idxs]
            self.decodes_seen += 1
            n, kept = self.keep_decodes, self.decodes
            if n is None or len(kept) < n:
                kept.append((ts, pts, conf, c2w))
            else:
                j = int(self.rng.integers(self.decodes_seen))
                if j < n:
                    kept[j] = (ts, pts, conf, c2w)
            return pts, conf, c2w
        return wrapped

    def encode(self, orig):
        def wrapped(*a, **k):
            self.encodes += 1
            return orig(*a, **k)
        return wrapped

    # ---- mapping ----------------------------------------------------------
    @staticmethod
    def _clone(d):
        return {k: v.detach().clone() for k, v in d.items()}

    def bin_window(self, orig):
        def wrapped(params, alive, w2cs, K4, rcfg, trans_deltas=None,
                    rot_deltas=None):
            bins = orig(params, alive, w2cs, K4, rcfg,
                        trans_deltas=trans_deltas, rot_deltas=rot_deltas)
            self._binned = (bins, dict(
                params=self._clone(params), alive=alive.clone(),
                w2cs=w2cs.clone(),
                t=None if trans_deltas is None else trans_deltas.clone(),
                r=None if rot_deltas is None else rot_deltas.clone()))
            return bins
        return wrapped

    def render_window(self, orig):
        def wrapped(params, alive, w2c_base, K4, cfg, trans_deltas=None,
                    rot_deltas=None, bins=None, means2d_probe=None):
            V = int(w2c_base.shape[0])
            grad = torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (*params.values(), trans_deltas, rot_deltas))
            if grad:
                self.views_grad += V
            else:
                self.views_fwd += V
            out = orig(params, alive, w2c_base, K4, cfg,
                       trans_deltas=trans_deltas, rot_deltas=rot_deltas,
                       bins=bins, means2d_probe=means2d_probe)
            binned_at = self._binned[1] \
                if bins is not None and bins is self._binned[0] else None
            if bins is None or binned_at is not None:
                keep = None
                for kind in ("any", "multi") if V > 1 else ("any",):
                    self.seen[kind] += 1
                    res = self.renders[kind]
                    slot = len(res) if len(res) < KEEP \
                        else int(self.rng.integers(self.seen[kind]))
                    if slot < KEEP:
                        keep = keep or dict(
                            params=self._clone(params), alive=alive.clone(),
                            w2cs=w2c_base.clone(), K4=K4.clone(), cfg=cfg,
                            t=None if trans_deltas is None
                            else trans_deltas.detach().clone(),
                            r=None if rot_deltas is None
                            else rot_deltas.detach().clone(),
                            bins=bins, binned_at=binned_at,
                            color=out["color"].detach().clone(),
                            depth=out["depth"].detach().clone())
                        res[slot:slot + 1] = [keep]
            return out
        return wrapped

    def render_view(self, orig):
        def wrapped(params, alive, w2c_base, K4, cfg, *a, **k):
            self.views_fwd += 1
            return orig(params, alive, w2c_base, K4, cfg, *a, **k)
        return wrapped

    # ---- the mapper's losses ----------------------------------------------
    def _keep_loss(self, kind):
        self.loss_seen[kind] += 1
        return self.rng.random() < 1.0 / self.loss_seen[kind]

    def _frames_of(self, slots):
        return [int(self.tstamps[int(i)]) for i in slots.tolist()]

    def img(self, orig):
        def wrapped(mapper, idx):
            out = orig(mapper, idx)
            self._images = (out, idx)
            return out
        return wrapped

    def window_loss(self, orig):
        """The mapper's window loss: one call kept with its inputs, its
        loss and, by hooks on its leaves, the gradients its backward
        produces."""
        def wrapped(mapper, params, pd, ex, alive, images, depths_gt, w2c,
                    weights, bins, gdns):
            loss = orig(mapper, params, pd, ex, alive, images, depths_gt,
                        w2c, weights, bins, gdns)
            if not self._keep_loss("window"):
                return loss
            slots = self._images[1] if images is self._images[0] else None
            kept = dict(
                params=self._clone(params), alive=alive.clone(),
                w2cs=w2c.detach().clone(), K4=mapper.K4.clone(),
                cfg=mapper.raster_cfg, depths=depths_gt.detach().clone(),
                weights=weights.detach().clone(),
                exposure={k: v.detach().clone() for k, v in ex.items()},
                t=pd["t"].detach().clone(), r=pd["r"].detach().clone(),
                frames=None if slots is None else self._frames_of(slots),
                binned_at=self._binned[1]
                if bins is not None and bins is self._binned[0] else None,
                loss=loss.detach().clone(), grads={})
            leaves = dict(params)
            leaves.update(t=pd["t"], r=pd["r"], a=ex["a"], b=ex["b"])
            for name, x in leaves.items():
                if x.requires_grad:
                    x.register_hook(lambda g, n=name:
                                    kept["grads"].__setitem__(
                                        n, g.detach().clone()))
            self.losses["window"] = kept
            return loss
        return wrapped

    def gba_batch(self, orig):
        """The mapper's global-BA batch: one call kept with its inputs, its
        per-view losses and the gradients it returns."""
        def wrapped(mapper, params, alive, w2c_all, expa_all, expb_all,
                    vi_batch, gdns, bins=None):
            keep = self._keep_loss("gba")
            if keep:
                kept = dict(
                    params=self._clone(params), alive=alive.clone(),
                    w2cs=w2c_all[vi_batch].clone(), K4=mapper.K4.clone(),
                    cfg=mapper.raster_cfg,
                    depths=mapper._depth(vi_batch).clone(),
                    exposure={"a": expa_all[vi_batch].clone(),
                              "b": expb_all[vi_batch].clone()},
                    frames=self._frames_of(vi_batch))
            out = orig(mapper, params, alive, w2c_all, expa_all, expb_all,
                       vi_batch, gdns, bins)
            if keep:
                losses, gp, _, _, _, gpes, _ = out
                kept["loss"] = losses.detach().clone()
                kept["grads"] = {k: v.detach().clone()
                                 for k, v in {**gp, **gpes}.items()}
                self.losses["gba"] = kept
            return out
        return wrapped

    def adam_step(self, orig):
        rec = self

        def wrapped(opt, params, grads, lrs, *a, **k):
            rec.adam_seen += 1
            keep = rec.rng.random() < 1.0 / rec.adam_seen
            if keep:
                before = dict(params=rec._clone(params),
                              grads=rec._clone(grads), m=rec._clone(opt.m),
                              v=rec._clone(opt.v), t=opt.t,
                              lrs=dict(lrs))
            if rec.fault == "state_unchanged":
                opt.t += 1
            else:
                orig(opt, params, grads, lrs, *a, **k)
            if keep:
                before["after"] = rec._clone(params)
                rec.adam = before
        return wrapped


def _frame_loop(slam, frames, K4, seconds, sync, on_frame=None,
                last_frame=None, paused=lambda: 0.0):
    """Frames in a closed loop until the first that finishes at or after
    ``seconds`` (or frame ``last_frame``, a test's cut), leaving out the
    ``paused()`` seconds (a profiler's start and stop): (window seconds,
    per-frame records)."""
    records = []
    t0 = time.perf_counter()
    for t, img in enumerate(frames):
        if on_frame is not None:
            on_frame(t, "start")
        f0 = time.perf_counter()
        gen_before = slam._map_gen is not None
        _, viz = slam.run(t, img, K4)
        sync()
        f1 = time.perf_counter()
        if on_frame is not None:
            on_frame(t, "end")
        did_map, done = F.frame_accounting(
            viz is not None, slam.frame_map_slices, gen_before,
            slam._map_gen is not None)
        records.append({"t": t, "s": f1 - f0, "slices": slam.frame_map_slices,
                        "mapping": did_map, "events_done": done,
                        "viz": None if viz is None else list(viz),
                        "gauss": None if slam.mapper is None
                        else int(slam.mapper.arena.alive.sum())})
        if f1 - t0 - paused() >= seconds or t == last_frame:
            return f1 - t0 - paused(), records
    raise RuntimeError(f"the traffic's {len(frames)} frames ran out before "
                       f"{seconds} s: lengthen the mix")


def _pose_gap(c2w, ref):
    """The gap of (V, 4, 4) camera-to-world poses against each reference
    pose's own departure from the identity (the model's prior: a still
    camera), not against what all views share."""
    eye = torch.eye(4, device=ref.device, dtype=ref.dtype)
    return rel_gap(c2w - eye, ref - eye)


def _reference_tracking(cell, rec, frames, device, fp8=False):
    """(pts, conf, pose) gaps of every decode of the window against the
    reference CUT3R on the frames themselves."""
    widths = cell.config["model"]["widths"]
    with torch.device(device):
        ref = ref_cut3r.CUT3R(reference_config(widths))
    ref.load_state_dict(model_weights(cell.config["model"], cell.seed,
                                      device))
    ref.eval()
    if fp8:
        ref_cut3r.use_fp8(ref)
    gaps = {"pts": 0.0, "conf": 0.0, "pose": 0.0}
    outs = []
    with torch.no_grad(), ref_cut3r.full_f32():
        for ts, pts, conf, c2w in rec.decodes:
            imgs = torch.as_tensor(np.stack([frames[t] for t in ts]),
                                   device=device)
            feat, pos = ref.encode_image(ref_cut3r.normalize_images(imgs))
            H, W = imgs.shape[1:3]
            out = ref.decode_views(feat[:, None], pos[:, None], H, W,
                                   ("self", "pose"))
            r_pts = out["pts3d_in_self_view"][:, 0]
            r_conf = out["conf_self"][:, 0]
            r_c2w = ref_cut3r.quat_wxyz_to_c2w(out["camera_pose"][:, 0])
            gaps["pts"] = max(gaps["pts"], centered_gap(pts, r_pts,
                                                        (0, 1, 2)))
            gaps["conf"] = max(gaps["conf"], centered_gap(conf, r_conf,
                                                          (0, 1, 2)))
            gaps["pose"] = max(gaps["pose"], _pose_gap(c2w, r_c2w))
            outs.append((r_pts, r_conf, r_c2w))
    del ref
    return gaps, outs


def _ref_cfg(cfg):
    return ref_raster.RasterizeConfig(
        height=cfg.height, width=cfg.width, max_dup=cfg.max_dup,
        max_per_tile=cfg.max_per_tile, chunk=cfg.chunk,
        kernel_size=cfg.kernel_size)


def _reference_render(kept, dtype=torch.float32):
    """The reference's colour and depth of the kept render (binned where
    the program binned), one view at a time."""
    cfg = _ref_cfg(kept["cfg"])
    bat = kept["binned_at"]
    colors, depths = [], []
    for v in range(kept["w2cs"].shape[0]):
        with torch.no_grad():
            out = ref_raster.render_views(
                kept["params"], kept["alive"], kept["w2cs"][v:v + 1],
                kept["K4"], cfg,
                None if kept["t"] is None else kept["t"][v:v + 1],
                None if kept["r"] is None else kept["r"][v:v + 1],
                dtype=dtype, bins_from=None if bat is None
                else [_binned_frame(bat, v)])
        colors.append(out["color"][0])
        depths.append(out["depth"][0])
    return torch.stack(colors), torch.stack(depths)


def _binned_frame(bat, v):
    """View ``v``'s camera-frame Gaussians at the parameters and pose the
    program binned at."""
    return ref_raster.camera_frame(
        bat["params"], bat["alive"], bat["w2cs"][v],
        None if bat["t"] is None else bat["t"][v],
        None if bat["r"] is None else bat["r"][v])


def _shown(reservoirs):
    """The first kept render of each kind whose colour is not empty."""
    out = []
    for res in reservoirs.values():
        for kept in res:
            if bool(kept["color"].abs().sum() > 0):
                out.append(kept)
                break
    return out


def _reference_losses(kind, kept, frames, dtype=torch.float32):
    """The plain loss of a kept window-loss call or global-BA batch on the
    keyframes' own frames: (loss, gradients by leaf)."""
    if kept.get("frames") is None:
        return None, None
    dev = kept["depths"].device
    images = torch.as_tensor(np.stack([frames[t] for t in kept["frames"]]),
                             device=dev).float() / 255.0
    depths = kept["depths"].float()
    cfg = _ref_cfg(kept["cfg"])
    if kind == "window":
        return ref_loss.window_loss_grads(
            kept["params"], kept["alive"], kept["w2cs"], kept["K4"], cfg,
            images, depths, kept["weights"], kept["exposure"], kept["t"],
            kept["r"], binned_at=None if kept["binned_at"] is None else [
                _binned_frame(kept["binned_at"], v)
                for v in range(kept["w2cs"].shape[0])], dtype=dtype)
    return ref_loss.gba_loss_grads(
        kept["params"], kept["alive"], kept["w2cs"], kept["K4"], cfg, images,
        depths, kept["exposure"], dtype=dtype)


def _mapping_outputs(rec, frames, dtype=None):
    """What the mapping checks compare, for each kept item: the program's
    own (``dtype`` None), or the reference's computed in ``dtype``."""
    out = {"renders": [], "losses": {}, "adam": None}
    for kept in _shown(rec.renders):
        out["renders"].append((kept["color"], kept["depth"]) if dtype is None
                              else _reference_render(kept, dtype))
    for kind, kept in sorted(rec.losses.items()):
        out["losses"][kind] = (kept["loss"], kept["grads"]) if dtype is None \
            else _reference_losses(kind, kept, frames, dtype)
    adam = rec.adam
    if adam is not None:
        out["adam"] = adam["after"] if dtype is None else {
            k: v.float() for k, v in adam_step(
                *({k: v.to(dtype) for k, v in adam[n].items()}
                  for n in ("params", "grads", "m", "v")),
                adam["t"], adam["lrs"]).items()}
    return out


def _loss_gaps(kept, got, ref):
    """(loss gap, worst leaf's gradient gap) of a kept call: ``got`` and
    ``ref`` each (loss, gradients by leaf). The leaves are those whose
    gradient the program's backward produced; the Gaussians' count on alive
    slots only (dead slots' are masked before Adam)."""
    if ref[0] is None or got[0] is None:
        return float("nan"), float("nan")
    dev = kept["alive"].device
    lg = rel_gap(torch.as_tensor(got[0]).reshape(-1).to(dev),
                 torch.as_tensor(ref[0]).reshape(-1).to(dev))
    names = list(kept["grads"])
    if not names or set(names) - set(got[1]) - set(ref[1]):
        return lg, float("nan")

    def masked(k, g):
        if k in kept["params"]:
            m = kept["alive"].reshape((-1,) + (1,) * (g.dim() - 1))
            return torch.where(m, g, torch.zeros_like(g))
        return g
    return lg, rel_gap_by_leaf([masked(k, got[1][k]) for k in names],
                               [masked(k, ref[1][k]) for k in names])


def _mapping_gaps(rec, got, ref):
    """The mapping checks' numbers: ``got`` against ``ref``, each from
    ``_mapping_outputs``."""
    gaps = {}

    def add(k, v):
        prev = gaps.get(k, 0.0)
        gaps[k] = max(prev, v) if v == v and prev == prev else float("nan")
    for (c, d), (rc, rd) in zip(got["renders"], ref["renders"]):
        add("render_color", rel_gap(c, rc))
        add("render_depth", rel_gap(d, rd))
    for kind, kept in sorted(rec.losses.items()):
        lg, gg = _loss_gaps(kept, got["losses"][kind], ref["losses"][kind])
        add("map_loss", lg)
        add("map_grad", gg)
    adam = rec.adam
    if adam is not None:
        add("adam_update", max(rel_gap(got["adam"][k] - adam["params"][k],
                                       ref["adam"][k] - adam["params"][k])
                               for k in adam["params"]))
    return gaps


def render_roofline(slam, device, reps=5):
    """Forward and gradient render times (CUDA events, ``reps`` calls of
    each view) of the map the window left, from the keyframe poses of the
    last submap mapped, with the blend census of each view."""
    from cut3r_slam_tpu_torch import full_f32
    from cut3r_slam_tpu_torch.slam.renderer import render_view
    m = slam.mapper
    arena, _ = m._sliced()
    params = {k: v.detach() for k, v in arena.params().items()}
    alive = arena.alive
    kf = slam.keyframes
    last = [i for i in range(kf.count) if bool(m.cams.valid[i])][-6:]
    w2cs = m.cams.w2c[torch.as_tensor(last, device=device)]
    cfg = m.raster_cfg
    census = []
    for v in range(len(last)):
        cam = ref_raster.camera_frame(params, alive, w2cs[v])
        census.append(ref_raster.blend_census(
            cam[0], cam[1], cam[2], cam[3], m.K4, _ref_cfg(cfg)))
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}

    def fwd(v):
        with torch.no_grad():
            render_view(params, alive, w2cs[v], m.K4, cfg)

    def grad(v):
        out = render_view(leaves, alive, w2cs[v], m.K4, cfg)
        torch.autograd.grad(out["color"].mean(), list(leaves.values()))

    def timed(fn):
        fn(0)
        torch.cuda.synchronize(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            for v in range(len(last)):
                fn(v)
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b) * 1e-3 / (reps * len(last))

    with full_f32():
        t_fwd = timed(fwd)
        t_grad = timed(grad)
    return {"fwd_s": t_fwd, "grad_s": t_grad, "census": census,
            "n_gauss": int(alive.sum()), "hw": (cfg.height, cfg.width)}


@contextlib.contextmanager
def _loss_fault(mapping_mod, fault):
    """The half-batch fault, planted in the mapper's losses: of each loss
    over several views, the second half of the views left out and the
    mean taken over the rest."""
    if fault != "half_batch":
        yield
        return
    MB = mapping_mod.MappingBackend
    saved = {k: MB.__dict__[k]
             for k in ("_rgb_terms", "_depth_terms", "_iso_terms")}
    rgb, depth = saved["_rgb_terms"], saved["_depth_terms"]
    iso = saved["_iso_terms"].__func__

    def weights(like):
        n = like.shape[0]
        w = torch.zeros(n, device=like.device, dtype=like.dtype)
        w[:(n + 1) // 2] = n / ((n + 1) // 2)
        return w

    def rgb_terms(self, img, image):
        loss = rgb(self, img, image)
        return loss * weights(loss)

    def depth_terms(self, d, gt_d, gdn):
        dl, nl, dmask, cnt = depth(self, d, gt_d, gdn)
        w = weights(dl)
        kept = w > 0
        return (dl * w, nl * w, dmask & kept[:, None, None],
                torch.where(kept, cnt / torch.clamp(w, min=1.0), cnt))

    def iso_terms(params, vis):
        loss = iso(params, vis)
        return loss * weights(loss)
    MB._rgb_terms, MB._depth_terms = rgb_terms, depth_terms
    MB._iso_terms = staticmethod(iso_terms)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(MB, k, v)


def run(cell, seed, seconds, trace, device="cuda", fault=None,
        check=True, last_frame=None, warmup=True):
    """One run of a SLAM cell. Returns a dict: setup_end (perf_counter at
    the window's start), window_s, records, check (``Check``), readings
    (what the per-layer metrics read), attempted / failed, peak bytes,
    and what the control needs (the recorder, the frames, the reference's
    outputs). ``fault`` plants one of ``FAULTS``; ``last_frame`` ends the
    window there at the latest (tests); ``warmup`` False skips the warm-up
    (a calibration's later seeds in one process)."""
    from cut3r_slam_tpu_torch.slam import mapping as mapping_mod
    from cut3r_slam_tpu_torch.slam.system import SLAMSystem

    cfg, tr = cell.config, cell.traffic
    cell.seed = seed
    dev = torch.device(device)
    card = dev.type == "cuda"

    def sync():
        if card:
            torch.cuda.synchronize(dev)

    phases = {}
    t_phase = [time.perf_counter()]

    def phase(name):
        now = time.perf_counter()
        phases[name] = now - t_phase[0]
        t_phase[0] = now

    H, W = cfg["hw"]
    frames = F.synth_frames(tr["frames"], H, W, seed, tr.get("step_px", 8))
    K4 = F.intrinsics(H, W, tr.get("f_over_w", 0.9))
    phase("frames")
    if card:
        from cut3r_slam_tpu_torch.kernels import build
        build.build_all()
    phase("kernels")
    if card:
        torch.zeros(1, device=dev)
        sync()
    phase("device_init")
    model = build_model(cfg, seed, dev)
    sync()
    phase("model")
    slam_cfg = cfg["slam"]
    mapping_on = bool(tr.get("enable_mapping", True))
    out_dir = tempfile.mkdtemp(prefix="port_bench_slam_")
    try:
        # warm-up: the cell's shapes through a throwaway system
        warm = SLAMSystem(model, _merge(slam_cfg, tr.get("warmup", {})
                                        .get("slam", {})),
                          buffer=cfg["buffer"], img_hw=(H, W),
                          enable_mapping=mapping_on, enable_loop=False,
                          output_dir=out_dir, device=dev)
        warm_s = []
        for t in range(tr["warmup"]["frames"] if warmup else 0):
            f0 = time.perf_counter()
            warm.run(t, frames[t], K4)
            sync()
            warm_s.append(round(time.perf_counter() - f0, 3))
        if warmup:
            warm.drain_mapper()
        sync()
        phases["warmup_frames"] = warm_s
        del warm
        phase("warmup")

        slam = SLAMSystem(model, slam_cfg, buffer=cfg["buffer"],
                          img_hw=(H, W), enable_mapping=mapping_on,
                          enable_loop=bool(cfg.get("enable_loop", False)),
                          output_dir=out_dir, device=dev)
        rec = Recorder(np.random.default_rng([seed, 1]), fault,
                       tr.get("check_decodes"), slam.keyframes.tstamp)
        spans = Spans() if trace else None
        slam.timer = spans
        prof = Profile() if trace and card else None
        traced = tr.get("trace_frames", [0, 1])
        ctx = {}

        def on_frame(t, edge):
            if prof is None:
                return
            if edge == "start" and t == traced[0]:
                ctx["p"] = prof()
                ctx["p"].__enter__()
            elif edge == "end" and t == traced[1] - 1 and "p" in ctx:
                ctx.pop("p").__exit__(None, None, None)

        slam.frontend.infer_views = rec.infer_views(
            slam.frontend, slam.frontend.infer_views)
        slam.filter.encode = rec.encode(slam.filter.encode)
        sync()
        MB = mapping_mod.MappingBackend
        with patched(mapping_mod, "render_window", rec.render_window), \
                patched(mapping_mod, "render_view", rec.render_view), \
                patched(mapping_mod, "bin_window", rec.bin_window), \
                patched(mapping_mod.Adam, "step", rec.adam_step), \
                patched(MB, "_img", rec.img), \
                patched(MB, "_window_loss", rec.window_loss), \
                patched(MB, "_gba_batch", rec.gba_batch), \
                _loss_fault(mapping_mod, fault):
            setup_end = time.perf_counter()
            window_s, records = _frame_loop(
                slam, frames, K4, seconds, sync, on_frame, last_frame,
                (lambda: prof.overhead_s) if prof is not None
                else (lambda: 0.0))
        if "p" in ctx:       # the window ended inside the traced frames
            ctx.pop("p").__exit__(None, None, None)
        peak = torch.cuda.max_memory_allocated(dev) if card else 0
        if prof is not None:
            prof.finish()

        readings = {"window_s": window_s, "records": records,
                    "spans": None if spans is None else dict(spans.totals),
                    "encodes": rec.encodes, "decodes": rec.decodes_seen,
                    "views_fwd": rec.views_fwd, "views_grad": rec.views_grad,
                    "cell": cell.name, "setup_phases": phases}
        if prof is not None and prof.window is not None:
            readings["trace"] = reduce(prof.events, prof.window)
            readings["trace"]["kinds"] = dict(prof.kinds)
        if trace and card and mapping_on and slam.mapper is not None:
            readings["render"] = render_roofline(slam, dev)
        if trace:
            widths = cfg["model"]["widths"]
            readings["flops"] = {
                "encode": flops.encode_flops(widths, H, W),
                "decode": flops.decode_flops(widths, H, W,
                                             tr.get("submap_views", 6))}
        chk = Check(tr["limits"])
        ref = {}
        if check:
            del slam, model
            if card:
                torch.cuda.empty_cache()
            gaps, ref["tracking"] = _reference_tracking(cell, rec, frames,
                                                        dev)
            chk.add("track_pts", gaps["pts"])
            chk.add("track_conf", gaps["conf"])
            # read, not compared: no limit separates the program's pose
            # gaps from the control's over seeds (PERF.md)
            chk.extra["track_pose_gap"] = gaps["pose"]
            readings["track_pose_gap"] = gaps["pose"]
            if mapping_on:
                ref["mapping"] = _mapping_outputs(rec, frames, torch.float32)
                for k, v in _mapping_gaps(rec, _mapping_outputs(rec, frames),
                                          ref["mapping"]).items():
                    chk.add(k, v)
        return {"setup_end": setup_end, "window_s": window_s,
                "check": chk, "readings": readings,
                "attempted": len(records), "failed": 0, "peak": peak,
                "recorder": rec, "frames": frames, "reference": ref}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def controls(cell, result, device):
    """The control through the cell's own check: the reference in the
    precision below the program's (CUT3R through float8, the render, the
    mapper's losses and the Adam step in bfloat16) put in the program's
    place, on the run's own inputs, against the float32 reference of the
    run. Returns the ``Check`` (the pose gap under ``extra``)."""
    rec, frames, ref = result["recorder"], result["frames"], \
        result["reference"]
    chk = Check(cell.traffic["limits"])
    _, low = _reference_tracking(cell, rec, frames, device, fp8=True)
    gaps = {}
    for (cp, cc, cw), (rp, rc, rw) in zip(low, ref["tracking"]):
        for k, v in (("track_pts", centered_gap(cp, rp, (0, 1, 2))),
                     ("track_conf", centered_gap(cc, rc, (0, 1, 2))),
                     ("track_pose_gap", _pose_gap(cw, rw))):
            gaps[k] = max(gaps.get(k, 0.0), v)
    chk.extra["track_pose_gap"] = gaps.pop("track_pose_gap", None)
    if "mapping" in ref:
        gaps.update(_mapping_gaps(
            rec, _mapping_outputs(rec, frames, torch.bfloat16),
            ref["mapping"]))
    for k, v in gaps.items():
        chk.add(k, v)
    return chk
