"""The training driver: the port's ``make_train_step`` (CUT3R's full
forward, ``cut3r_total_loss``, its backward and the port's AdamW) run
back to back on batches from the port's input pipeline.

Set-up: the benchmark's own multi-view RGB-D scenes drawn from the seed
(``scenes.py``) and written into a temporary directory (``TMPDIR``), the
port's ``MultiViewDataset`` and ``make_batch_iter`` over them, CUT3R's
weights drawn from the seed on the device, one optimizer, and the first
three steps through the window's own call and feed on three batches
that differ (they warm up every shape and are what the reference
follows). The window continues the same step from step 4 and ends at the
end of the first step that finishes at or after ``--seconds``.

The check (after the window, the program's state freed): the reference
(float32 CUT3R, loss and AdamW from the same weights) takes the same
three batches, built again from the scenes' arrays (the views the
program's pipeline picked, found by their images). Compared: step 1's
forward outputs (the self and cross pointmaps and their confidences, by
the gap over what varies in the reference), the first gradient as the
optimizer got it (from its first moment after step 1) and the
parameters' change after three steps, both as the worst leaf's gap of
norms over the larger of the leaf's and the median leaf's reference
norm. Leaves whose reference gradient is under a thousandth of the
median leaf's move by rounding alone and are left out of the change.
Step 1's loss, the worst of the three steps' losses and step 1's poses
(``fwd_pose``) are read and printed beside them (no limit separates them
from the control, PERF.md).
"""
from __future__ import annotations

import contextlib
import shutil
import tempfile
import time

import numpy as np
import torch

from port_bench import flops, scenes
from port_bench.compare import Check, centered_gap, norm_gap_by_leaf
from port_bench.reference import cut3r as ref_cut3r
from port_bench.reference import train as ref_train
from port_bench.trace import Profile, Spans, reduce
from port_bench.weights import model_weights, reference_config

B1 = 0.9
FAULTS = ("state_unchanged", "half_batch", "answer_altered")
# the forward outputs compared at step 1, and the dimensions each varies
# over (all but the channel)
FORWARD = {"pts3d_in_self_view": (0, 1, 2, 3),
           "pts3d_in_other_view": (0, 1, 2, 3),
           "conf_self": (0, 1, 2, 3), "conf": (0, 1, 2, 3),
           "camera_pose": (0, 1)}


def host_threads(cfg):
    """The host's intra-op threads as the configuration states them
    (``host_threads``), else torch's default."""
    if cfg.get("host_threads"):
        torch.set_num_threads(int(cfg["host_threads"]))


def _batches(root, cfg, tr, seed):
    """(the port's batch iterator over the seed's scenes written under
    ``root``, the scenes' arrays)."""
    from cut3r_slam_tpu_torch.datasets import (
        MultiViewDataset, SceneFolderSource, SceneLayout, make_batch_iter)
    H, W = cfg["hw"]
    drawn = scenes.draw_scenes(tr["scenes"], tr["views_per_scene"], (H, W),
                               seed)
    parts = [MultiViewDataset(
        SceneFolderSource(root, SceneLayout("synth"), scenes=[name]),
        num_views=tr["views"], span=tr["span"], resolution=(H, W),
        seed=seed + i) for i, name in enumerate(
            scenes.write_scenes(root, drawn))]
    ds = parts[0]
    for part in parts[1:]:
        ds = ds + part
    return make_batch_iter(ds, batch_size=tr["batch"], seed=seed), drawn


def _distinct(it, n, limit=64):
    """The first ``n`` batches of ``it`` whose images all differ."""
    out = []
    for _ in range(limit):
        b = next(it)
        if all(not np.array_equal(b["imgs"], o["imgs"]) for o in out):
            out.append(b)
        if len(out) == n:
            return out
    raise RuntimeError(f"the mix gave fewer than {n} distinct batches")


def reference_batch(drawn, batch):
    """The reference's own batch for the program's ``batch``: each view
    found among the scenes by its image, then built from the scenes'
    arrays (``scenes.view_batch``)."""
    raw = [(s, i) for s, sc in enumerate(drawn) for i in range(len(sc.rgb))]
    norm = np.stack([(drawn[s].rgb[i].astype(np.float32) / 255.0 - 0.5)
                     / 0.5 for s, i in raw])
    V, B = batch["imgs"].shape[:2]
    seqs = []
    for b in range(B):
        picks = [raw[int(np.argmin(np.abs(norm - batch["imgs"][v, b])
                                   .reshape(len(raw), -1).max(1)))]
                 for v in range(V)]
        seqs.append(scenes.view_batch(drawn, picks))
    return {k: np.concatenate([q[k] for q in seqs], 1) for k in seqs[0]}


def _leaf_norms(tensors):
    norms = torch.stack([torch.linalg.vector_norm(t.double())
                         for t in tensors.values()]).tolist()
    return dict(zip(tensors, norms))


@contextlib.contextmanager
def _loss_hook(fault, seen):
    """The program's ``cut3r_total_loss`` as ``make_train_step`` calls it,
    with the first call's forward outputs kept in ``seen`` and the faults
    that sit there planted: the self pointmap negated where the forward
    produced it (an altered answer), the loss over half of the batch's
    views (B is 1, so the views are the batch)."""
    from cut3r_slam_tpu_torch.train import train_step as ts_mod
    orig = ts_mod.cut3r_total_loss

    def loss(pred, gt, *a, **k):
        if fault == "answer_altered":
            pred = dict(pred, pts3d_in_self_view=-pred["pts3d_in_self_view"])
        if not seen:
            seen.append({n: pred[n].detach().float().clone()
                         for n in FORWARD})
        if fault == "half_batch":
            h = max(1, pred["camera_pose"].shape[0] // 2)
            pred = {n: v[:h] for n, v in pred.items()}
            gt = {n: v[:h] for n, v in gt.items()}
        return orig(pred, gt, *a, **k)
    ts_mod.cut3r_total_loss = loss
    try:
        yield
    finally:
        ts_mod.cut3r_total_loss = orig


def _reference_steps(cell, batches, device, fp8=False):
    """The reference's three steps from the same weights on its own
    batches: (losses, first gradient norms, change norms, step 1's forward
    outputs)."""
    cfg = cell.config
    widths = cfg["model"]["widths"]
    with torch.device(device):
        model = ref_cut3r.CUT3R(reference_config(widths))
    model.load_state_dict(model_weights(cfg["model"], cell.seed, device))
    if fp8:
        ref_cut3r.use_fp8(model)
    opt = ref_train.AdamW(model.named_parameters(), **cfg["optimizer"])
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    losses, grad1, fwd = [], None, None
    with ref_cut3r.full_f32():
        for i, b in enumerate(batches):
            b = {k: torch.as_tensor(v).to(device) for k, v in b.items()}
            for p in model.parameters():
                p.grad = None
            pred = model(b["imgs"])
            if i == 0:
                fwd = {n: pred[n].detach().float().clone() for n in FORWARD}
            loss = ref_train.total_loss(pred, b)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            if i == 0:
                grad1 = _leaf_norms({k: opt.mu[k] / (1 - B1)
                                     for k in opt.mu})
    change = _leaf_norms({k: p.detach() - p0[k]
                          for k, p in model.named_parameters()})
    del model, opt, p0
    return losses, grad1, change, fwd


def pose_frame(pose):
    """Poses (..., 7) as translation and unit quaternion wxyz, returned as
    (..., 12): the translation and the rotation matrix, which q and -q
    share (the heads make w >= 0, so a quaternion near w = 0 may come out
    negated on one side)."""
    t = pose[..., :3]
    q = pose[..., 3:7] / torch.clamp(torch.linalg.vector_norm(
        pose[..., 3:7], dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    rot = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        -1)
    return torch.cat([t, rot], -1)


def compare(prog, ref):
    """The check's numbers from the program's and the reference's
    readings, each (losses, first gradient norms, change norms, step 1's
    forward outputs): the forward's pointmaps (``fwd_pts``), confidences
    (``fwd_conf``) and poses (``fwd_pose``, as translation and rotation
    matrix), the first step's loss
    (``loss1``), the worst of the three steps' losses (``loss``), the
    first gradient (``grad1``) and the change (``change3``), and the
    leaves that read worst (``grad1_leaf``, ``change3_leaf``)."""
    lp, gp, cp, fp = prog
    lr, gr, cr, fr = ref
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr)]
    fp = dict(fp, camera_pose=pose_frame(fp["camera_pose"]))
    fr = dict(fr, camera_pose=pose_frame(fr["camera_pose"]))
    fwd = {n: centered_gap(fp[n], fr[n], dims) for n, dims in FORWARD.items()}
    grad_gap, grad_leaf = norm_gap_by_leaf(gp, gr)
    med = float(np.median(list(gr.values())))
    moving = {k for k, v in gr.items() if v >= 1e-3 * med}
    change_gap, change_leaf = norm_gap_by_leaf(cp, cr, keep=moving)
    return {"fwd_pts": max(fwd["pts3d_in_self_view"],
                           fwd["pts3d_in_other_view"]),
            "fwd_conf": max(fwd["conf_self"], fwd["conf"]),
            "fwd_pose": fwd["camera_pose"],
            "loss1": gaps[0], "loss": max(gaps), "grad1": grad_gap,
            "change3": change_gap, "grad1_leaf": grad_leaf,
            "change3_leaf": change_leaf}


def _program_first_steps(cell, seed, dev, batches, fault=None):
    """The port's model and optimizer from the seed's weights, driven
    through ``make_train_step`` on ``batches``: (step, model, optimizer,
    (losses, first gradient norms, change norms after the steps, step 1's
    forward outputs))."""
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu_torch.train import train_step as ts_mod
    cfg = cell.config
    widths = cfg["model"]["widths"]
    dtype = getattr(torch, cfg["model"]["compute_dtype"])
    with torch.device(dev):
        model = CUT3R(CUT3RConfig(**widths, compute_dtype=dtype), device=dev)
    model.load_state_dict(model_weights(cfg["model"], seed, dev),
                          strict=True)
    model.train()
    opt = ts_mod.make_optimizer(model.parameters(), **cfg["optimizer"])
    if fault == "state_unchanged":
        opt.step = lambda closure=None: None
    step = ts_mod.make_train_step(model, opt)
    names = [k for k, _ in model.named_parameters()]
    losses, grad1, seen = [], None, []
    with _loss_hook(fault, seen):
        for i, b in enumerate(batches):
            losses.append(float(step(b)["total"]))
            if i == 0:
                st = [opt.state[p] for p in model.parameters()]
                grad1 = _leaf_norms(
                    {k: (s["mu"] / (1 - B1)) if s else torch.zeros(1)
                     for k, s in zip(names, st)})
    p0 = model_weights(cfg["model"], seed, dev)
    change = _leaf_norms({k: p.detach() - p0[k]
                          for k, p in model.named_parameters()})
    return step, model, opt, (losses, grad1, change, seen[0])


def _add(chk, gaps):
    """Compared numbers into ``chk``, the rest under its ``extra``."""
    for k, v in gaps.items():
        if k in chk.limits:
            chk.add(k, v)
        else:
            chk.extra[k] = v
    return chk


def run(cell, seed, seconds, trace, device="cuda", fault=None, check=True):
    cfg, tr = cell.config, cell.traffic
    cell.seed = seed
    host_threads(cfg)
    dev = torch.device(device)
    card = dev.type == "cuda"
    root = tempfile.mkdtemp(prefix="port_bench_train_")
    try:
        t0 = time.perf_counter()
        it, drawn = _batches(root, cfg, tr, seed)
        first = _distinct(it, 3)
        t1 = time.perf_counter()
        step, model, opt, prog = _program_first_steps(cell, seed, dev, first,
                                                      fault)
        if card:
            torch.cuda.synchronize(dev)

        prof = Profile() if trace and card else None
        traced = tr.get("trace_steps", [1, 3])
        spans = Spans()
        window_steps, n_failed = 0, 0
        ctx = {}
        setup_end = time.perf_counter()
        with _loss_hook(fault, [None]) if fault else contextlib.nullcontext():
            while True:
                if prof is not None and window_steps == traced[0]:
                    ctx["p"] = prof()
                    ctx["p"].__enter__()
                with spans("data"):
                    batch = next(it)
                with spans("step"):
                    loss = float(step(batch)["total"])  # waits for the step
                window_steps += 1
                n_failed += int(not np.isfinite(loss))
                if "p" in ctx and window_steps == traced[1]:
                    ctx.pop("p").__exit__(None, None, None)
                spent = time.perf_counter() - setup_end
                if spent - (prof.overhead_s if prof else 0.0) >= seconds:
                    break
        window_s = time.perf_counter() - setup_end
        if "p" in ctx:
            ctx.pop("p").__exit__(None, None, None)
        if prof is not None:
            # the profiler's start and stop are no work of the window
            window_s -= prof.overhead_s
            prof.finish()
        peak = torch.cuda.max_memory_allocated(dev) if card else 0

        V, B = tr["views"], tr["batch"]
        readings = {"window_s": window_s, "steps": window_steps,
                    "views": window_steps * V * B, "cell": cell.name,
                    "spans": dict(spans.totals),
                    "setup_phases": {"data": t1 - t0,
                                     "model_and_3_steps": setup_end - t1}}
        if prof is not None and prof.window is not None:
            readings["trace"] = reduce(prof.events, prof.window)
            readings["trace"]["kinds"] = dict(prof.kinds)
        if trace:
            H, W = cfg["hw"]
            readings["flops"] = {"train_step": flops.train_step_flops(
                cfg["model"]["widths"], H, W, V, B)}
        chk = Check(tr["limits"])
        ref_batches = [reference_batch(drawn, b) for b in first]
        ref = None
        if check:
            del step, model, opt
            if card:
                torch.cuda.empty_cache()
            ref = _reference_steps(cell, ref_batches, dev)
            _add(chk, compare(prog, ref))
            for k in ("loss1", "loss", "fwd_pose"):  # read (PERF.md)
                readings["read_" + k] = chk.extra.get(k)
        return {"setup_end": setup_end, "window_s": window_s,
                "check": chk, "readings": readings,
                "attempted": window_steps, "failed": n_failed, "peak": peak,
                "program": prog, "batches": ref_batches, "reference": ref}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def calibrate(cell, seed, device, faults=FAULTS[1:]):
    """The check's readings without a window: the program's, each planted
    fault's and the control's (the reference through float8 in the
    program's place), all against the reference on the seed's first three
    batches, each with whether the cell's check passes it."""
    cell.seed = seed
    host_threads(cell.config)
    dev = torch.device(device)
    root = tempfile.mkdtemp(prefix="port_bench_train_")
    try:
        it, drawn = _batches(root, cell.config, cell.traffic, seed)
        first = _distinct(it, 3)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    progs = {}
    for name in (None,) + tuple(faults):
        out = _program_first_steps(cell, seed, dev, first, name)
        progs[name or "program"] = out[3]
        del out
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    ref_batches = [reference_batch(drawn, b) for b in first]
    ref = _reference_steps(cell, ref_batches, dev)
    progs["control"] = _reference_steps(cell, ref_batches, dev, fp8=True)
    res = {}
    for name, readings in progs.items():
        res[name] = compare(readings, ref)
        res[name]["correct"] = _add(Check(cell.traffic["limits"]),
                                    res[name]).correct
    return res


def controls(cell, result, device):
    """The control through the cell's own check: the reference through
    float8 put in the program's place on the run's own three batches,
    against the run's float32 reference. Returns the ``Check``."""
    ref = result["reference"] or _reference_steps(cell, result["batches"],
                                                  device)
    low = _reference_steps(cell, result["batches"], device, fp8=True)
    return _add(Check(cell.traffic["limits"]), compare(low, ref))
