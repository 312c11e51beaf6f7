"""The DROID tracking driver with the monocular prior on: ``droid_stream``'s
run (the same video, closed loop, warm-up, window, DROID checks and
trace) through a ``SLAMSystem`` whose configuration turns on Omnidata
DPT-Hybrid depth and normal priors (``Tracking.motion_filter``:
``use_prior``, ``prior_model: omnidata``), computed on every keyframe the
DROID filter takes and stored in the keyframe store on the card.

The driver gives the system a prior seed from ``--seed`` and the
configuration's ``prior.init``, but the weights the check rests on are
the benchmark's: ``reference/omnidata.draw_state_dict`` draws each
network once a run from the same seed and ``prior.init``. Each system
the driver builds must hold two Omnidata networks at the configuration's
widths in its filter, into which that draw is loaded strictly, or the
run stops there with an error, before any frame: a program that ignores
the setting is not measured running DROID alone, and the check does not
rest on the program's own draw.

While the window runs the benchmark listens at ``store_priors`` (the
keyframes given a prior) and at the networks' tapped ViT blocks. It keeps
``keep_keyframes`` keyframes drawn from the seed outside the traced
frames, each with its image, the depth and normal maps the store holds
for it and the tokens of both networks' tapped blocks, and the traced
keyframe with its image and maps (no hooks read its tokens). After the
window the reference (``reference/omnidata.py``, float32, TF32 off),
loaded with the same draw, recomputes them from the images:

- ``prior_depth``, ``prior_normal``: ||program - reference|| over the
  reference's spread about its mean (``centered_gap``; the maps sit on
  the head's bias), the largest over the kept keyframes;
- ``vit_tokens``: ||program - reference|| / ||reference|| of the tapped
  blocks' tokens, the program's taps against the published blocks, the
  largest over keyframes, networks and taps;
- ``prior_missed``: the window's keyframes that ``store_priors`` was not
  called for.

The control (``controls``) puts the reference under bfloat16 autocast in
the program's place on the same images and weights. ``FAULTS`` are
planted under the timed path by the tests and by ``calibrate``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from port_bench import harness
from port_bench import omnidata_roofline as OR
from port_bench.compare import centered_gap, rel_gap
from port_bench.reference import omnidata as ref
from port_bench.reference.omnidata import PUBLISHED

FAULTS = ("hook_blocks_7_11", "pos_grid_not_resized", "std_unbiased",
          "same_symmetric", "prev_keyframe_image")
TASKS = ("depth", "normal")
PRIOR_SPANS = ("prior.depth", "prior.normal", "prior.store")


class PriorMissing(RuntimeError):
    """The system under test built no Omnidata prior."""


def _droid():
    return harness.driver("droid_stream")


def _widths(net) -> dict:
    """The keyword widths of a built network, read from its modules."""
    vit = net.pretrained.model
    return dict(vit_dim=int(net.vit_dim), vit_depth=len(vit.blocks),
                vit_heads=int(vit.blocks[0].attn.heads),
                hook_blocks=list(net.hook_blocks),
                features=int(net.scratch.layer1_rn.out_channels),
                resnet_layers=[len(s.blocks) for s in
                               vit.patch_embed.backbone.stages])


def _prior_nets(slam):
    """{task: the Omnidata network} of the system's filter, or raise."""
    from cut3r_slam_tpu_torch.models.omnidata import OmnidataDPT
    prior = getattr(slam.filter, "prior", None) or ()
    nets = [getattr(fn, "net", None) for fn in prior]
    if len(nets) != 2 or not all(isinstance(n, OmnidataDPT) for n in nets):
        raise PriorMissing(
            "the system's filter holds no Omnidata depth and normal prior "
            "(Tracking.motion_filter: use_prior, prior_model omnidata): "
            "this cell does not measure DROID alone")
    return dict(zip(TASKS, nets))


class PriorRecorder:
    """Listens at ``store_priors`` and the tapped ViT blocks during the
    window; keeps ``keep`` keyframes drawn from ``rng`` outside the
    ``traced`` frames and the traced keyframes."""

    def __init__(self, rng, keep: int, traced, fault=None):
        self.rng, self.keep, self.traced_frames = rng, int(keep), traced
        self.fault = fault
        self.kept, self.traced_kf, self.seen, self.stored = [], [], 0, 0
        self.active = self.traced = False
        self.nets, self.state = {}, {}
        self.counters, self.att = {}, None
        self._tokens, self._prev_image, self._hooks = None, None, []

    def _keep(self, keyframes, idx, image_u8, tokens):
        return dict(t=int(keyframes.tstamp[idx]), image=np.array(image_u8),
                    depth=keyframes.prior_depth[idx].detach().clone(),
                    normal=keyframes.prior_normal[idx].detach().clone(),
                    tokens=tokens)

    def store(self, orig):
        rec = self

        def wrapped(keyframes, prior, idx, image_u8):
            given = image_u8
            if rec.fault == "prev_keyframe_image":
                given = image_u8 if rec._prev_image is None \
                    else rec._prev_image
                rec._prev_image = np.array(image_u8)
            if not rec.active:
                return orig(keyframes, prior, idx, given)
            rec.stored += 1
            if rec.traced:
                out = orig(keyframes, prior, idx, given)
                rec.traced_kf.append(rec._keep(keyframes, idx, image_u8,
                                               None))
                return out
            rec.seen += 1
            slot = len(rec.kept) if len(rec.kept) < rec.keep \
                else int(rec.rng.integers(rec.seen))
            if slot >= rec.keep:
                return orig(keyframes, prior, idx, given)
            rec._tokens = {}
            try:
                out = orig(keyframes, prior, idx, given)
            finally:
                tokens, rec._tokens = rec._tokens, None
            rec.kept[slot:slot + 1] = [rec._keep(keyframes, idx, image_u8,
                                                 tokens)]
            return out
        return wrapped

    def listen(self, nets):
        """Hooks on ``nets``' tapped blocks: their tokens, while a kept
        keyframe's maps are computed."""
        self.nets = nets
        for task, net in nets.items():
            for pos, b in enumerate(net.hook_blocks):
                def tap(m, a, out, key=(task, pos)):
                    if self._tokens is not None:
                        self._tokens[key] = out.detach().clone()
                self._hooks.append(
                    net.pretrained.model.blocks[b].register_forward_hook(tap))

    def unlisten(self):
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def frame_loop(self, orig):
        """``droid_stream._frame_loop`` with the recorder active, its
        hooks on the window system's networks and the counters read at
        the traced frames' edges."""
        rec = self
        lo, hi = rec.traced_frames

        def wrapped(slam, frames, K4, seconds, sync, on_frame, last_frame,
                    paused):
            def on(t, edge):
                on_frame(t, edge)
                if edge == "start":
                    rec.traced = lo <= t < hi
                    if t == lo:
                        rec.counters["start"] = dict(getattr(
                            slam.timer, "counters", {}))
                elif t == hi - 1:
                    rec.traced = False
                    rec.counters["end"] = dict(getattr(
                        slam.timer, "counters", {}))
            rec.listen(_prior_nets(slam))
            rec.active = True
            try:
                return orig(slam, frames, K4, seconds, sync, on, last_frame,
                            paused)
            finally:
                rec.active = rec.traced = False
                rec.unlisten()
        return wrapped

    def attribute(self, orig):
        """``attribute`` with the prior's spans among those it measures
        inside."""
        rec = self

        def wrapped(spans, ops, calls, waits, window, inside=(), cpu_ops=()):
            rec.att = orig(spans, ops, calls, waits, window,
                           inside=tuple(inside) + PRIOR_SPANS,
                           cpu_ops=cpu_ops)
            return rec.att
        return wrapped


def draw(cell, seed, device):
    """{task: the benchmark's state dict} of a run: ``draw_state_dict``
    from ``seed`` + the configuration's ``seed_offset`` (+ 1 for normal)
    with its ``prior.init``, drawn on ``device`` and kept on the host."""
    pc = cell.config["prior"]
    base = int(seed) + pc["seed_offset"]
    return {task: {k: v.cpu() for k, v in ref.draw_state_dict(
        task, base + i, device, **pc["init"][task], **pc["widths"]).items()}
        for i, task in enumerate(TASKS)}


def _built(cell, fault, state):
    """``SLAMSystem.__init__`` followed by the check that the system holds
    both Omnidata networks at the configuration's widths, and the load of
    ``state`` into them; a fault that changes the taps is planted here."""
    want = cell.config["prior"]["widths"]

    def make(orig):
        def wrapped(slam, *a, **k):
            orig(slam, *a, **k)
            nets = _prior_nets(slam)
            for task, net in nets.items():
                if _widths(net) != want:
                    raise ValueError(f"the {task} prior's widths "
                                     f"{_widths(net)} are not the "
                                     f"configuration's {want}")
                net.load_state_dict(state[task], strict=True)
                if fault == "hook_blocks_7_11":
                    net.hook_blocks = (7, 11)
        return wrapped
    return make


@contextlib.contextmanager
def _fault(fault):
    """The faults planted inside the network's forward."""
    from cut3r_slam_tpu_torch.models import omnidata as O
    with contextlib.ExitStack() as st:
        if fault == "pos_grid_not_resized":
            def unresized(orig):
                def wrapped(x, out_h, out_w):
                    if x.dim() == 4 and tuple(x.shape[1:3]) == (24, 24):
                        # the 24x24 grid placed in the corner, zeros after
                        y = x.new_zeros(x.shape[0], out_h, out_w, x.shape[3])
                        h, w = min(24, out_h), min(24, out_w)
                        y[:, :h, :w] = x[:, :h, :w]
                        return y
                    return orig(x, out_h, out_w)
                return wrapped
            st.enter_context(harness.patched(O, "resize_bilinear",
                                             unresized))
        if fault == "std_unbiased":
            def unbiased(orig):
                def forward(conv, x):
                    w = conv.weight
                    w = (w - w.mean(dim=(1, 2, 3), keepdim=True)) \
                        / torch.sqrt(w.var(dim=(1, 2, 3), keepdim=True)
                                     + 1e-8)
                    k, s = conv.kernel_size[0], conv.stride[0]
                    return torch.nn.functional.conv2d(O._pad_same(x, k, s),
                                                      w, stride=s)
                return forward
            st.enter_context(harness.patched(O.StdConv2dSame, "forward",
                                             unbiased))
        if fault == "same_symmetric":
            def symmetric(orig):
                def wrapped(x, k, s, value=0.0):
                    p = (k - 1) // 2
                    return torch.nn.functional.pad(x, (p, p, p, p),
                                                   value=value) if p else x
                return wrapped
            st.enter_context(harness.patched(O, "_pad_same", symmetric))
        yield


def _items(rec):
    return rec.kept + rec.traced_kf


def reference_outputs(cell, rec, device, low=False):
    """{task: [(map, {tap position: tokens}) of each kept keyframe]} from
    the reference loaded with the run's draw, float32 with TF32 off, or
    under bfloat16 autocast where ``low``."""
    widths = cell.config["prior"]["widths"]
    out = {}
    for task in TASKS:
        net = ref.OmnidataDPT(task, **widths).to(device)
        net.load_state_dict(rec.state[task], strict=True)
        net.eval()
        res = []
        with torch.no_grad():
            for it in _items(rec):
                img = torch.as_tensor(it["image"], device=device)[None]
                y, toks = net(img.float() / 255.0, low=low)
                res.append((y[0], {i: toks[b][0] for i, b in
                                   enumerate(widths["hook_blocks"])}))
        out[task] = res
        del net
    return out


def _gaps(rec, ref_out, taken):
    """The compared numbers of the prior against ``ref_out`` (the program's
    kept maps and tokens, or ``taken``'s in its place: the control's), and
    those read beside them."""
    gaps = {"prior_depth": 0.0, "prior_normal": 0.0, "vit_tokens": 0.0}
    read = {"prior_zero_share": 0.0, "prior_spread": float("inf"),
            "prior_compared": len(_items(rec))}
    for task in TASKS:
        key = "prior_" + task
        for k, (it, (want, want_tok)) in enumerate(zip(_items(rec),
                                                       ref_out[task])):
            got, got_tok = taken(task, k, it)
            gaps[key] = max(gaps[key], centered_gap(got, want, (0, 1)))
            read["prior_zero_share"] = max(read["prior_zero_share"], float(
                (want == 0).double().mean()))
            w = want.double()
            read["prior_spread"] = min(read["prior_spread"], float(
                (w - w.mean((0, 1))).std() / w.abs().mean()))
            for pos, tok in (got_tok or {}).items():
                gaps["vit_tokens"] = max(gaps["vit_tokens"],
                                         rel_gap(tok, want_tok[pos]))
    return gaps, read


def _program(task, k, it):
    tokens = None if it["tokens"] is None else {
        pos: t[0] for (tk, pos), t in it["tokens"].items() if tk == task}
    return it[task], tokens


def run(cell, seed, seconds, trace, device="cuda", fault=None, check=True,
        last_frame=None, warmup=True):
    """One run of the prior cell: ``droid_stream.run``'s result with the
    prior's numbers added to its check and readings (``prior_trace``:
    device seconds inside the prior's spans, the keyframes and their
    least time in the traced frames; ``prior_least_s``: the window's
    Omnidata least time), and ``prior_reference`` for the control.
    ``fault`` plants one of ``FAULTS``."""
    from cut3r_slam_tpu_torch.slam import droid_frontend as fe_mod
    from cut3r_slam_tpu_torch.slam.system import SLAMSystem
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    cfg, tr = cell.config, cell.traffic
    pc = cfg["prior"]
    if pc["widths"] != PUBLISHED:
        raise ValueError(f"Omnidata's widths are the published ones: "
                         f"{PUBLISHED}")
    if not hasattr(fe_mod, "store_priors"):
        raise PriorMissing("the program's DROID filter stores no prior")
    # the program draws its own plausible networks from these; the
    # benchmark's draw then replaces them (``_built``)
    cfg["slam"]["Tracking"]["motion_filter"].update(
        prior_init=pc["init"], prior_seed=int(seed) + pc["seed_offset"])
    ds = _droid()
    rec = PriorRecorder(np.random.default_rng([seed, 2]),
                        tr["keep_keyframes"], tr["trace_frames"], fault)
    rec.state = draw(cell, seed, device)
    with harness.patched(SLAMSystem, "__init__",
                         _built(cell, fault, rec.state)), \
            harness.patched(fe_mod, "store_priors", rec.store), \
            harness.patched(ds, "_frame_loop", rec.frame_loop), \
            harness.patched(ds, "attribute", rec.attribute), _fault(fault):
        out = ds.run(cell, seed, seconds, trace, device, check=check,
                     last_frame=last_frame, warmup=warmup)
    r = out["readings"]
    H, W = cfg["hw"]
    least_kf = sum(OR.least_s(task, H, W) for task in TASKS)
    if "counters" in r:
        r["prior_least_s"] = r["counters"].get("prior.keyframes", 0) \
            * least_kf
    if rec.att is not None:
        c0, c1 = rec.counters.get("start", {}), rec.counters.get("end", {})
        n = c1.get("prior.keyframes", 0) - c0.get("prior.keyframes", 0)
        r["prior_trace"] = {
            "device_s": sum(rec.att["inside"][s]["device_s"]
                            for s in PRIOR_SPANS),
            "keyframes": n, "least_s": n * least_kf}
    r["prior_keyframes"] = rec.stored
    out["prior_recorder"] = rec
    if check:
        out["prior_reference"] = reference_outputs(cell, rec, device)
        gaps, read = _gaps(rec, out["prior_reference"], _program)
        for k, v in gaps.items():
            out["check"].add(k, v)
        out["check"].add("prior_missed", r["keyframes"] - rec.stored)
        out["check"].extra.update(read)
        r.update(read)
    return out


def controls(cell, result, device):
    """The control through the cell's own check: DROID's (``droid_stream``)
    and the Omnidata reference under bfloat16 autocast in the program's
    place on the kept images, against the run's float32 reference."""
    chk = _droid().controls(cell, result, device)
    rec = result["prior_recorder"]
    low = reference_outputs(cell, rec, device, low=True)
    gaps, read = _gaps(rec, result["prior_reference"],
                       lambda task, k, it: low[task][k])
    for k, v in gaps.items():
        chk.add(k, v)
    chk.add("prior_missed", 0)
    chk.extra.update(read)
    return chk


def calibrate(cell, seed, device, faults=FAULTS, seconds=15.0):
    """The readings the limits are set from (``port_bench.calibrate``): a
    sound run of ``seconds`` with its control, then a short run (to frame
    60, no warm-up) with each of ``faults`` planted."""
    def numbers(chk):
        return {**{k: v["value"] for k, v in chk.report().items()},
                **chk.extra, "correct": chk.correct}
    res = run(cell, seed, seconds, False, device)
    rec = {"program": numbers(res["check"]),
           "control": numbers(controls(cell, res, device)),
           "window_s": res["window_s"], "frames": res["attempted"],
           "peak": res["peak"]}
    del res
    rec["faults"] = {}
    for f in faults:
        out = run(cell, seed, 1e9, False, device, fault=f, last_frame=60,
                  warmup=False)
        rec["faults"][f] = numbers(out["check"])
        del out
    return rec
