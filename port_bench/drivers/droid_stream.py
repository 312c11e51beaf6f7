"""The DROID tracking driver: a video through the port's live
``SLAMSystem.run`` with ``Tracking.model: droid`` (DROID-SLAM's frontend,
``slam/droid_frontend.py``), in a closed loop (the next frame follows the
previous one's return and a device synchronize), mapping and loop closure
off.

Set-up: DroidNet's weights drawn from the seed on the device
(``reference/droid.draw_state_dict``, the configuration's ``init``), the
video drawn from the seed, then a warm-up through a throwaway system at
the cell's shapes (``warmup`` frames), discarded. The window starts at
frame 0 of a fresh system and ends at the end of the first frame that
finishes at or after ``--seconds``.

The benchmark listens at the tracker's boundaries while the window runs
(``Recorder``): the factor graph's update iterations, the correlation
cache's builds and lookups, the update operator, the dense BA and the
motion filter's encoders. Drawn from the seed, ``keep_updates`` update
iterations are kept with the graph's and the video's state as the update
found it (the edges with their ages, the retired edges with their targets
and weights, the hidden state and target of every edge, the fmaps, context
and hidden-state seeds of the frames the edges span, every keyframe's
pose, disparity, intrinsics and damping) and what the program made of it
(the lookup, delta, weight, eta, the hidden state the graph carries on,
the BA's inputs, poses and disparities), and one keyframe's encoder
outputs with its image. After the window the reference
(``reference/droid.py``, float32, TF32 off) recomputes them, taking its
inputs from the kept state itself (``_window``: the BA's window, its fixed
frames and the retired edges it keeps; each edge's fmaps and context by
its frames; the hidden state by frame i for an edge added at this update,
the graph's carried state for older edges):

- ``lookup``: the window correlations, from pyramids the reference builds
  from the frames' fmaps, at its own reprojection of the kept poses;
- ``delta``, ``weight``, ``eta``, ``gru_state``: the update operator on
  those inputs, the reference's correlations and motion features (eta of
  the frames that are some edge's source);
- ``ba_edges``: the BA's edges, fixed frames and window size that differ
  from those ``_window`` picks; ``ba_inputs``: the largest relative gap of
  the BA's targets, weights, damping, poses, disparities and intrinsics
  against those ``ba_inputs`` assembles from the kept state and the
  update's own delta, weight and eta (the update's outputs are held by the
  numbers above, so the update operator's rounding does not blur this
  one);
- ``ba_disp``: the BA's step on the disparities (after its iterations
  less before) from the BA's kept inputs, as its distance from the
  reference BA's step in float64 over the float32 reference's distance
  from it (``_ba_ratio``); ``ba_pose``, the same of the poses it moves,
  is read and not compared: the near-static camera leaves the pose step
  so weakly held that no limit separates the program's readings from the
  control's (PERF.md); a wrong pose step reaches the disparities too
  (dz = Q (w - E^T dx));
- ``encode_fmap``, ``encode_ctx``: the kept keyframe's fmap and its
  (net, inp);
- ``nonfinite_poses``: the keyframe poses left that are not finite.

Each is ||program - reference|| / ||reference|| (float64) but the BA's
and the counts.
The control (``controls``) puts the reference in bfloat16 (``low``) in the
program's place on the same kept state.
"""
from __future__ import annotations

import contextlib
import shutil
import tempfile
import time

import numpy as np
import torch

from port_bench import droid_roofline as R
from port_bench import frames as F
from port_bench.compare import Check, rel_gap
from port_bench.harness import patched
from port_bench.peaks import PEAK_BF16, PEAK_FP32
from port_bench.reference import droid as ref
from port_bench.span_probe import CountingSpans, LaunchProfile, attribute
from port_bench.trace import reduce

# faults a test plants under the timed path (the check must fail each)
FAULTS = ("lookup_unscaled", "ba_one_iter", "gru_reset", "ctx_from_j",
          "ba_damping", "ba_no_inactive")
# the tracker's architecture, which the configuration's widths must state
WIDTHS = {"fnet_dim": 128, "fnet_norm": "instance", "cnet_dim": 256,
          "cnet_norm": "none", "gru_dim": 128, "corr_levels": 4,
          "corr_radius": 3, "corr_planes": 196, "upmask": [8, 8, 9]}


def build_model(config, seed, device):
    """The port's DroidNet with the benchmark's weights for ``seed``."""
    from cut3r_slam_tpu_torch.models.droid_net import DroidNet
    m = config["model"]
    if m["widths"] != WIDTHS:
        raise ValueError(f"DroidNet's widths are fixed: {WIDTHS}")
    init = m.get("init", {})
    model = DroidNet(device=device)
    model.load_state_dict(ref.draw_state_dict(
        seed, device, init.get("scale"), init.get("assign")), strict=True)
    return model.eval()


class Recorder:
    """Listens at the tracker's boundaries during the window: counts the
    work (for ``mfu.droid``), keeps ``keep`` update iterations and one
    keyframe's encodes drawn from ``rng``."""

    def __init__(self, rng, keep: int, hw):
        self.rng, self.keep, self.hw = rng, int(keep), tuple(hw)
        self.updates, self.updates_seen = [], 0
        self.frame, self.frames_seen = None, 0
        self._cur = None
        self._last_fmap = None
        self.work = {"fnet": 0, "cnet": 0, "pyramids": 0, "edge_updates": 0,
                     "frame_updates": 0, "ba_flops": 0}
        self.traced = False
        self.traced_lookup_edges = 0

    @staticmethod
    def _c(x):
        return x.detach().clone()

    def graph_update(self, orig):
        rec = self

        def wrapped(graph, t0=None):
            rec.updates_seen += 1
            kept = rec.updates
            slot = len(kept) if len(kept) < rec.keep \
                else int(rec.rng.integers(rec.updates_seen))
            cur = None
            if slot < rec.keep:
                # the graph's and the video's state as the update finds
                # it; of the video's features the frames the edges span
                v = graph.video
                ii, jj = graph.ii.copy(), graph.jj.copy()
                a = int(min(ii.min(), jj.min()))
                b = int(max(ii.max(), jj.max())) + 1
                cur = dict(ii=ii, jj=jj, age=graph.age.copy(), t0=t0,
                           ii_inac=graph.ii_inac.copy(),
                           jj_inac=graph.jj_inac.copy(),
                           target_inac=rec._c(graph.target_inac),
                           weight_inac=rec._c(graph.weight_inac),
                           net=rec._c(graph.net), target=rec._c(graph.target),
                           feat0=a, fmaps=rec._c(v.fmaps[a:b]),
                           nets=rec._c(v.nets[a:b]),
                           inps=rec._c(v.inps[a:b]),
                           poses=rec._c(v.poses[:v.count]),
                           disps=rec._c(v.disps[:v.count]),
                           intr=rec._c(v.intrinsics[:v.count]),
                           damping=rec._c(v.damping[:v.count]))
                rec._cur = cur
            try:
                out = orig(graph, t0)
            finally:
                rec._cur = None
            if cur is not None:
                cur["net_after"] = rec._c(graph.net)
                kept[slot:slot + 1] = [cur]
            return out
        return wrapped

    def lookup(self, orig):
        rec = self

        def wrapped(cache, slots, coords):
            out = orig(cache, slots, coords)
            if rec.traced:
                rec.traced_lookup_edges += int(slots.shape[0])
            if rec._cur is not None:
                rec._cur["corr"] = rec._c(out)
            return out
        return wrapped

    def corr_add(self, orig):
        rec = self

        def wrapped(cache, fmap1, fmap2):
            rec.work["pyramids"] += int(fmap1.shape[0])
            return orig(cache, fmap1, fmap2)
        return wrapped

    def update_op(self, orig):
        rec = self

        def wrapped(net, inp, corr, flow, ii, n_frames):
            out = orig(net, inp, corr, flow, ii, n_frames)
            rec.work["edge_updates"] += int(net.shape[0])
            rec.work["frame_updates"] += int(n_frames)
            if rec._cur is not None:
                rec._cur.update(delta=rec._c(out[1]), weight=rec._c(out[2]),
                                eta=rec._c(out[3]))
            return out
        return wrapped

    def ba(self, orig):
        rec = self

        def wrapped(target, weight, eta, poses, disps, intr, ii, jj, ev,
                    fixedp=1, n_frames=None, steps=1):
            if rec._cur is not None:
                rec._cur["ba_in"] = dict(
                    target=rec._c(target), weight=rec._c(weight),
                    eta=rec._c(eta), poses=rec._c(poses),
                    disps=rec._c(disps), intr=rec._c(intr), ii=ii.clone(),
                    jj=jj.clone(), fixedp=int(fixedp),
                    n_frames=int(n_frames))
            out = orig(target, weight, eta, poses, disps, intr, ii, jj, ev,
                       fixedp=fixedp, n_frames=n_frames, steps=steps)
            rec.work["ba_flops"] += R.ba_flops(
                int(ii.shape[0]), int(n_frames), int(fixedp),
                rec.hw[0] * rec.hw[1], int(steps))
            if rec._cur is not None:
                rec._cur["ba_out"] = (rec._c(out[0]), rec._c(out[1]))
            return out
        return wrapped

    def encode(self, orig):
        rec = self

        def wrapped(filt, image_u8):
            rec.work["fnet"] += 1
            out = orig(filt, image_u8)
            rec._last_fmap = out
            return out
        return wrapped

    def context(self, orig):
        rec = self

        def wrapped(filt, image_u8):
            rec.work["cnet"] += 1
            out = orig(filt, image_u8)
            rec.frames_seen += 1
            if rec.rng.random() < 1.0 / rec.frames_seen:
                rec.frame = dict(image=np.array(image_u8),
                                 fmap=rec._c(rec._last_fmap),
                                 net=rec._c(out[0]), inp=rec._c(out[1]))
            return out
        return wrapped


@contextlib.contextmanager
def _listening(rec, fault, graph_cls, cache_cls, filt_cls, fe_mod, net):
    """The recorder's patches and the fault planted (if any): under the
    recorder where the fault is in what the update is given, over it where
    the fault is in what the update hands the BA."""
    from cut3r_slam_tpu_torch.ops import corr as corr_mod
    with contextlib.ExitStack() as st:
        if fault == "lookup_unscaled":
            # each level sampled at level-0 coordinates: not divided
            def unscaled(orig):
                def wrapped(pyramid, coords, radius=3, rows=None):
                    return torch.cat([corr_mod._bilinear_window_sample(
                        v, coords, radius, rows) for v in pyramid], -1)
                return wrapped
            st.enter_context(patched(fe_mod, "corr_lookup", unscaled))
        if fault == "ba_one_iter":
            st.enter_context(patched(
                fe_mod, "bundle_adjust",
                lambda orig: lambda *a, **k: orig(*a, **{**k, "steps": 1})))
        if fault == "gru_reset":
            def reset(orig):
                def wrapped(graph, t0=None):
                    before = graph.net
                    out = orig(graph, t0)
                    graph.net = before
                    return out
                return wrapped
            st.enter_context(patched(graph_cls, "update", reset))
        if fault == "ctx_from_j":
            # every edge's context copied from its frame j
            def from_j(orig):
                def wrapped(graph, ii, jj, remove=False):
                    out = orig(graph, ii, jj, remove)
                    graph.inp = graph.video.inps[torch.as_tensor(
                        graph.jj, device=graph.device)]
                    return out
                return wrapped
            st.enter_context(patched(graph_cls, "add_factors", from_j))
        if fault == "ba_no_inactive":
            # the BA given none of the retired edges
            def hidden(orig):
                def wrapped(graph, t0=None):
                    names = ("ii_inac", "jj_inac", "target_inac",
                             "weight_inac")
                    kept = [getattr(graph, n) for n in names]
                    for n, x in zip(names, kept):
                        setattr(graph, n, x[:0])
                    try:
                        return orig(graph, t0)
                    finally:
                        for n, x in zip(names, kept):
                            setattr(graph, n, x)
                return wrapped
            st.enter_context(patched(graph_cls, "update", hidden))
        st.enter_context(patched(graph_cls, "update", rec.graph_update))
        st.enter_context(patched(cache_cls, "lookup", rec.lookup))
        st.enter_context(patched(cache_cls, "add", rec.corr_add))
        st.enter_context(patched(fe_mod, "bundle_adjust", rec.ba))
        st.enter_context(patched(filt_cls, "encode", rec.encode))
        st.enter_context(patched(filt_cls, "context", rec.context))
        st.enter_context(patched(net.update, "forward", rec.update_op))
        if fault == "ba_damping":
            # the BA's damping without its 0.2
            def undamped(orig):
                def wrapped(target, weight, eta, *a, **k):
                    return orig(target, weight, 5.0 * eta, *a, **k)
                return wrapped
            st.enter_context(patched(fe_mod, "bundle_adjust", undamped))
        yield


def _check_constants(fe_mod, const):
    """The configuration states the tracker's constants as the program
    fixes them."""
    from cut3r_slam_tpu_torch.ops import ba
    import inspect
    damp = inspect.signature(ba._damp).parameters
    have = {"max_factors": fe_mod.MAX_FACTORS, "max_age": fe_mod.MAX_AGE,
            "iters1": fe_mod.ITERS1, "iters2": fe_mod.ITERS2,
            "init_iters": fe_mod.INIT_ITERS,
            "init_radius": fe_mod.INIT_RADIUS, "ba_iters": fe_mod.BA_ITERS,
            "corr_levels": fe_mod.CORR_LEVELS,
            "corr_radius": fe_mod.CORR_RADIUS,
            "damping_floor": fe_mod.EP,
            "lm": damp["lm"].default, "ep": damp["ep"].default}
    if have != const:
        raise ValueError(f"the tracker's constants {have} are not the "
                         f"configuration's {const}")


def _frame_loop(slam, frames, K4, seconds, sync, on_frame, last_frame,
                paused):
    """Frames in a closed loop until the first that finishes at or after
    ``seconds`` (or frame ``last_frame``): (window seconds, records)."""
    records = []
    t0 = time.perf_counter()
    for t, img in enumerate(frames):
        on_frame(t, "start")
        f0 = time.perf_counter()
        took, _ = slam.run(t, img, K4)
        sync()
        f1 = time.perf_counter()
        on_frame(t, "end")
        records.append({"t": t, "s": f1 - f0, "kf": bool(took),
                        "edges": len(slam.graph), "slices": 0,
                        "gauss": None})
        if f1 - t0 - paused() >= seconds or t == last_frame:
            return f1 - t0 - paused(), records
    raise RuntimeError(f"the traffic's {len(frames)} frames ran out before "
                       f"{seconds} s: lengthen the mix")


def _window(u):
    """The update's BA window from the kept graph state, as DROID-SLAM's
    ``FactorGraph.update`` takes it: frames before ``t0`` fixed (by
    default one after the oldest source frame, at least 1), the retired
    edges between frames from ``t0`` - 3 on, the window over every edge's
    frames. Returns (lo, hi, t0, the retired edges' mask, the BA's edges
    (retired first) in window indices)."""
    t0 = u["t0"] if u["t0"] is not None else max(1, int(u["ii"].min()) + 1)
    m = (u["ii_inac"] >= t0 - 3) & (u["jj_inac"] >= t0 - 3)
    ii = np.concatenate([u["ii_inac"][m], u["ii"]])
    jj = np.concatenate([u["jj_inac"][m], u["jj"]])
    lo, hi = int(min(ii.min(), jj.min())), int(max(ii.max(), jj.max())) + 1
    return lo, hi, t0, m, ii - lo, jj - lo


def ba_inputs(u, coords1, delta, weight, eta, floor, low=False):
    """The BA's inputs assembled from the kept graph state and an update's
    outputs (delta and weight (E, 2, h, w), eta (window frames, h, w)):
    targets coords1 + delta after the kept retired edges' targets, their
    weights likewise, the damping 0.2 x (each source frame's new eta, the
    kept damping elsewhere) + ``floor``, the window's kept poses,
    disparities and intrinsics, the edges and the fixed frames. ``low``
    rounds the assembled tensors to bfloat16 (the control's)."""
    lo, hi, t0, m, ii, jj = _window(u)
    mt = torch.as_tensor(m, device=coords1.device)
    damping = u["damping"].clone()
    src = torch.as_tensor(np.unique(u["ii"]), device=coords1.device)
    damping[src] = eta.float()[src - lo]
    out = dict(
        target=torch.cat([u["target_inac"][mt], coords1
                          + delta.float().permute(0, 2, 3, 1)]),
        weight=torch.cat([u["weight_inac"][mt],
                          weight.float().permute(0, 2, 3, 1)]),
        eta=0.2 * damping[lo:hi] + floor)
    out = {k: ref._bf16(x, low) for k, x in out.items()}
    out.update(poses=u["poses"][lo:hi], disps=u["disps"][lo:hi],
               intr=u["intr"][lo:hi], ii=ii, jj=jj, fixedp=t0 - lo,
               n_frames=hi - lo)
    return out


def reference_outputs(cell, rec, device, low=False):
    """The reference's numbers for every kept item: for each kept update
    (its reprojection, corr, delta, weight, eta, net, BA poses (P, 4, 4),
    BA disparities), from inputs it takes from the kept graph and video
    state itself (the window, the edges' fmaps, context ``inp`` and, for
    an edge added at this update, hidden state by frame i; the hidden
    state the graph carries for older edges), and the kept keyframe's
    (fmap, net, inp); float32, or the control's bfloat16 where ``low``
    (with its assembled BA inputs)."""
    c = cell.config["constants"]
    init = cell.config["model"].get("init", {})
    net = ref.DroidNet().to(device)
    net.load_state_dict(ref.draw_state_dict(
        cell.seed, device, init.get("scale"), init.get("assign")))
    net.eval()
    out = {"updates": [], "frame": None}
    amp = ref.low_precision(device, low)
    with torch.no_grad(), ref.full_f32():
        for u in rec.updates:
            lo, hi, _, _, _, _ = _window(u)
            dev = u["poses"].device
            ii_loc = torch.as_tensor(u["ii"] - lo, device=dev)
            jj_loc = torch.as_tensor(u["jj"] - lo, device=dev)
            fi = torch.as_tensor(u["ii"] - u["feat0"], device=dev)
            fj = torch.as_tensor(u["jj"] - u["feat0"], device=dev)
            new = torch.as_tensor(u["age"] == 0, device=dev)
            h0 = torch.where(new[:, None, None, None], u["nets"][fi],
                             u["net"])
            G = ref.pose_mats(u["poses"][lo:hi])
            coords1, _ = ref.reproject(G, u["disps"][lo:hi],
                                       u["intr"][lo:hi], ii_loc, jj_loc)
            h, w = coords1.shape[1:3]
            grid = ref.coords_grid(h, w, coords1.device)
            motion = torch.cat([coords1 - grid, u["target"].float() - coords1],
                               -1).clamp(-64.0, 64.0)
            corr = ref.lookup(ref.pyramid(u["fmaps"][fi], u["fmaps"][fj],
                                          low=low), coords1)
            with amp:
                net_new, delta, weight, eta, _ = net.update(
                    h0.float(), u["inps"][fi].float(),
                    corr.permute(0, 3, 1, 2), motion.permute(0, 3, 1, 2),
                    ii_loc, hi - lo)
            b = u["ba_in"]
            args = (b["target"], b["weight"], b["eta"], b["poses"],
                    b["disps"], b["intr"], b["ii"], b["jj"], b["fixedp"])
            ba = dict(iters=c["ba_iters"], lm=c["lm"], ep=c["ep"])
            Gb, db = ref.dense_ba(*args, low=low, **ba)
            r = dict(coords1=coords1, corr=corr, delta=delta.float(),
                     weight=weight.float(), eta=eta.float(),
                     net=net_new.float(), ba_pose=Gb, ba_disp=db,
                     ba64=None if low else ref.dense_ba(
                         *args, dtype=torch.float64, **ba))
            if low:
                r["ba_in"] = ba_inputs(u, coords1, delta, weight, eta,
                                       c["damping_floor"], low=True)
            out["updates"].append(r)
        if rec.frame is not None:
            img = torch.as_tensor(rec.frame["image"], device=device)[None]
            with amp:
                fmap, n, i = net.encode(img)
            out["frame"] = (fmap.float(), n.float(), i.float())
    return out


EPS32 = 2.0 ** -23     # float32's unit roundoff


def _ba_ratio(got, r32, r64, before):
    """How far ``got``'s step (after less ``before``) lies from the
    float64 reference's, over how far the float32 reference's lies from
    it (at least float32's rounding of the step itself): the BA's float32
    rounding is amplified by its conditioning, which the float32
    reference shares, so the ratio reads ~1 for a float32 solve of the
    same mathematics whatever the conditioning."""
    step = [(x.double() - before.double()).reshape(-1)
            for x in (got, r32, r64)]
    den = max(float(torch.linalg.vector_norm(step[1] - step[2])),
              EPS32 * float(torch.linalg.vector_norm(step[2])), 1e-300)
    return float(torch.linalg.vector_norm(step[0] - step[2])) / den


def _ba_input_gaps(got, want):
    """(edges and window sizes that differ, the largest relative gap of
    the BA's tensor inputs) between the BA's inputs ``got`` and those
    assembled from the kept state ``want``."""
    gi = [np.asarray(torch.as_tensor(got[k]).cpu()) for k in ("ii", "jj")]
    n = max(len(gi[0]), len(want["ii"]))
    off = int(got["fixedp"] != want["fixedp"]) \
        + int(got["n_frames"] != want["n_frames"])
    if len(gi[0]) != len(want["ii"]):
        return n + off, 1.0
    off += int(((gi[0] != want["ii"]) | (gi[1] != want["jj"])).sum())
    if got["n_frames"] != want["n_frames"]:
        return off, 1.0
    return off, max(rel_gap(got[k], want[k]) for k in
                    ("target", "weight", "eta", "poses", "disps", "intr"))


def _gaps(rec, got, ref_out, floor):
    """The compared numbers (``got`` against ``ref_out``, each from
    ``program_outputs`` / ``reference_outputs``) and those read beside
    them; ``floor`` the BA damping's."""
    gaps, read = {}, {}

    def add(k, v):
        gaps[k] = max(gaps.get(k, 0.0), v)
    for u, g, r in zip(rec.updates, got["updates"], ref_out["updates"]):
        add("lookup", rel_gap(g["corr"], r["corr"]))
        add("delta", rel_gap(g["delta"], r["delta"]))
        add("weight", rel_gap(g["weight"], r["weight"]))
        add("gru_state", rel_gap(g["net"], r["net"]))
        lo, hi = _window(u)[:2]
        if g["eta"].shape[0] == hi - lo:
            src = torch.as_tensor(np.unique(u["ii"]) - lo,
                                  device=r["eta"].device)
            add("eta", rel_gap(g["eta"][src], r["eta"][src]))
            edges, inputs = _ba_input_gaps(g["ba_in"], ba_inputs(
                u, r["coords1"], g["delta"], g["weight"], g["eta"], floor))
        else:   # the update was given another window of frames
            add("eta", 1.0)
            edges, inputs = 1, 1.0
        add("ba_edges", edges)
        add("ba_inputs", inputs)
        b = u["ba_in"]
        fx = b["fixedp"]
        G64, d64 = r["ba64"]
        add("ba_disp", _ba_ratio(g["ba_disp"], r["ba_disp"], d64,
                                 b["disps"]))
        read["ba_pose"] = max(read.get("ba_pose", 0.0), _ba_ratio(
            g["ba_pose"][fx:], r["ba_pose"][fx:], G64[fx:],
            ref.pose_mats(b["poses"])[fx:]))
    if got["frame"] is not None:
        gf, rf = got["frame"], ref_out["frame"]
        add("encode_fmap", rel_gap(gf[0], rf[0]))
        add("encode_ctx", rel_gap(torch.cat(gf[1:], 1),
                                  torch.cat(rf[1:], 1)))
    return gaps, read


def program_outputs(rec):
    """What the program made of the kept items, as ``reference_outputs``
    lays them out."""
    out = {"updates": [], "frame": None}
    for u in rec.updates:
        out["updates"].append(dict(
            corr=u["corr"].float(), delta=u["delta"].float(),
            weight=u["weight"].float(), eta=u["eta"].float(),
            net=u["net_after"].float(), ba_in=u["ba_in"],
            ba_pose=ref.pose_mats(u["ba_out"][0]),
            ba_disp=u["ba_out"][1].float()))
    if rec.frame is not None:
        f = rec.frame
        out["frame"] = (f["fmap"].float(), f["net"].float(),
                        f["inp"].float())
    return out


def _flops(rec, H, W, amp: bool):
    """(low-precision operations, float32 operations) of the window's
    work."""
    h, w = H // 8, W // 8
    fnet, cnet = R.encoder_flops(H, W)
    per_edge, per_frame = R.update_flops(h, w)
    k = rec.work
    net = (k["fnet"] * fnet + k["cnet"] * cnet
           + k["pyramids"] * R.pyramid_flops(h, w)
           + k["edge_updates"] * per_edge + k["frame_updates"] * per_frame)
    return (net, k["ba_flops"]) if amp else (0, net + k["ba_flops"])


def run(cell, seed, seconds, trace, device="cuda", fault=None, check=True,
        last_frame=None, warmup=True):
    """One run of the DROID tracking cell. Returns a dict: setup_end
    (perf_counter at the window's start), window_s, records, check
    (``Check``), readings (what the metrics read), attempted / failed,
    peak bytes, and what the control needs (the recorder, the reference's
    outputs). ``fault`` plants one of ``FAULTS``; ``last_frame`` ends the
    window there at the latest (tests); ``warmup`` False skips the
    warm-up."""
    from cut3r_slam_tpu_torch.slam import droid_frontend as fe_mod
    from cut3r_slam_tpu_torch.slam.system import SLAMSystem

    cfg, tr = cell.config, cell.traffic
    cell.seed = seed
    const = cfg["constants"]
    _check_constants(fe_mod, const)
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
        torch.zeros(1, device=dev)
        sync()
    phase("device_init")
    model = build_model(cfg, seed, dev)
    sync()
    phase("model")
    slam_cfg = cfg["slam"]
    out_dir = tempfile.mkdtemp(prefix="port_bench_droid_")
    try:
        def system():
            return SLAMSystem(model, slam_cfg, buffer=cfg["buffer"],
                              img_hw=(H, W), enable_mapping=False,
                              enable_loop=False, output_dir=out_dir,
                              device=dev)
        warm = system()
        warm_s = []
        for t in range(tr["warmup"]["frames"] if warmup else 0):
            f0 = time.perf_counter()
            warm.run(t, frames[t], K4)
            sync()
            warm_s.append(round(time.perf_counter() - f0, 3))
        phases["warmup_frames"] = warm_s
        del warm
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        phase("warmup")

        slam = system()
        rec = Recorder(np.random.default_rng([seed, 1]),
                       tr.get("keep_updates", 2), (H // 8, W // 8))
        spans = CountingSpans() if trace else None
        slam.timer = spans
        prof = LaunchProfile() if trace and card else None
        traced = tr.get("trace_frames", [0, 1])
        ctx, counters = {}, {}

        def on_frame(t, edge):
            if edge == "start" and t == traced[0]:
                rec.traced = True
                if spans is not None:
                    counters["start"] = dict(spans.counters)
                if prof is not None:
                    ctx["p"] = prof()
                    ctx["p"].__enter__()
            elif edge == "end" and t == traced[1] - 1 and rec.traced:
                rec.traced = False
                if "p" in ctx:
                    ctx.pop("p").__exit__(None, None, None)
                if spans is not None:
                    counters["end"] = dict(spans.counters)

        sync()
        with _listening(rec, fault, fe_mod.DroidGraph, fe_mod.CorrCache,
                        fe_mod.DroidMotionFilter, fe_mod, model):
            setup_end = time.perf_counter()
            window_s, records = _frame_loop(
                slam, frames, K4, seconds, sync, on_frame, last_frame,
                (lambda: prof.overhead_s) if prof is not None
                else (lambda: 0.0))
        if "p" in ctx:      # the window ended inside the traced frames
            ctx.pop("p").__exit__(None, None, None)
        peak = torch.cuda.max_memory_allocated(dev) if card else 0
        n_kf = slam.keyframes.count
        poses = torch.as_tensor(slam.keyframes.pose[:n_kf])
        nonfinite = int((~torch.isfinite(poses).all(-1)).sum())
        amp = fe_mod.store_dtype(dev) == torch.float16
        readings = {"window_s": window_s, "records": records,
                    "cell": cell.name, "setup_phases": phases,
                    "keyframes": n_kf, "work": dict(rec.work),
                    "spans": None if spans is None else dict(spans.totals)}
        low, f32 = _flops(rec, H, W, amp)
        readings["least_s"] = low / PEAK_BF16 + f32 / PEAK_FP32
        if prof is not None:
            prof.finish()
        if prof is not None and prof.window is not None:
            readings["trace"] = reduce(prof.events, prof.window)
            readings["trace"]["kinds"] = dict(prof.kinds)
            span_iv = [(s, e, n) for k, n, s, e in prof.events
                       if k == "span"]
            att = attribute(span_iv, prof.ops, prof.calls, prof.waits,
                            prof.window,
                            inside=("droid.update", "droid.corr_lookup"))
            c0, c1 = counters.get("start", {}), counters.get("end", {})
            readings["droid_trace"] = {
                "updates": c1.get("droid.updates", 0)
                - c0.get("droid.updates", 0),
                "edges": c1.get("droid.edges", 0) - c0.get("droid.edges", 0),
                "update_device_s": att["inside"]["droid.update"]["device_s"],
                "lookup_device_s":
                    att["inside"]["droid.corr_lookup"]["device_s"],
                "lookup_bytes": R.lookup_bytes(
                    rec.traced_lookup_edges, H // 8, W // 8,
                    const["corr_levels"], const["corr_radius"],
                    2 if amp else 4, 2 if amp else 4)}
        if spans is not None:
            readings["counters"] = dict(spans.counters)
        chk = Check(tr["limits"])
        refs = {}
        if check:
            del slam
            if card:
                torch.cuda.empty_cache()
            refs = reference_outputs(cell, rec, dev)
            gaps, chk.extra = _gaps(rec, program_outputs(rec), refs,
                                    const["damping_floor"])
            for k, v in gaps.items():
                chk.add(k, v)
            chk.add("nonfinite_poses", nonfinite)
            readings.update(chk.extra)
        return {"setup_end": setup_end, "window_s": window_s, "check": chk,
                "readings": readings, "attempted": len(records), "failed": 0,
                "peak": peak, "recorder": rec, "reference": refs}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def controls(cell, result, device):
    """The control through the cell's own check: the reference in bfloat16
    (``reference_outputs(low=True)``) in the program's place on the run's
    kept inputs, against the run's float32 reference."""
    rec = result["recorder"]
    chk = Check(cell.traffic["limits"])
    low = reference_outputs(cell, rec, device, low=True)
    gaps, chk.extra = _gaps(rec, low, result["reference"],
                            cell.config["constants"]["damping_floor"])
    for k, v in gaps.items():
        chk.add(k, v)
    chk.add("nonfinite_poses", 0)
    return chk
