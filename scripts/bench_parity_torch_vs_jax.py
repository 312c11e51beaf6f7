"""Does the port's bench close the loop that the JAX bench does not? One-off
measurement, not a test.

Both packages track the bench's 40 synthetic frames with one weight draw:
the JAX bench's own (full ``CUT3RConfig()``, ``model.init(PRNGKey(0),
zeros((2, 1, 384, 512, 3)))``, ``bench.py:202-206``), carried to the port
through ``models/convert.params_from_jax``. Each runs its ``SLAMSystem``
with the bench's card-mode configuration (``kf_every`` 2, arena 2^17, a
64-keyframe buffer, loop closure on) and mapping off, in f32 on the CPU
(the card computes CUT3R in bf16, a different rounding), and records per
frame:

* whether the frame became a keyframe, the keyframe and submap counts,
  every keyframe's pose;
* the factor-graph edges added;
* on each ``TrackBackend.run`` scan: the keyframe scanned, the candidates
  of ``detect_loop`` (after the temporal gap), the NMS scores and pick;
* at the end, ``backend.closed``.

The two halves run in separate processes, the JAX half first (it writes
the draw as ``.npy`` files, ~3.2 GB at full width):

    python scripts/bench_parity_torch_vs_jax.py --only jax
    python scripts/bench_parity_torch_vs_jax.py --only torch
    python scripts/bench_parity_torch_vs_jax.py --compare

(without ``--only`` / ``--compare``: all three, one after the other).
``--card`` instead runs the port's own bench draw (bf16, drawn on the
card) over the same frames on the card, with mapping off and then with
the bench's mapping on, and records the same decisions
(``card_nomap.json``, ``card_map.json``).
Everything goes under ``--work`` (``build/bench_parity``): ``params/``,
``jax.json``, ``torch.json`` and ``compare.json``. The comparison prints
the first frame at which the halves' decisions part and the smallest
margin of any NMS score to the threshold. The port half imports nothing of
JAX; the JAX half needs the JAX package and flax. ``--tiny`` rehearses the
script with the tiny model at 64x96.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NMS_THRESH = 0.4


def bench_cfg():
    """The bench's card-mode configuration (``bench.py:207-225``)."""
    return {"Tracking": {"motion_filter": {"kf_every": 2}},
            "Mapping": {"arena_capacity": 2 ** 17, "iterations": 100,
                        "parallel_kf_refine": True, "gba_views_per_iter": 4,
                        "gba_resample_every": 4, "interleave": 3,
                        "opt_early_stop": 0.01}}


def synth_frames(n, H, W, seed=0):
    """``bench.py``'s sliding-window panorama."""
    rng = np.random.default_rng(seed)
    pano = rng.uniform(0, 255, (H + 16, W + 8 * n, 3)).astype(np.float32)
    for _ in range(2):
        pano = (pano + np.roll(pano, 1, 0) + np.roll(pano, 1, 1)
                + np.roll(pano, -1, 0) + np.roll(pano, -1, 1)) / 5.0
    pano = pano.astype(np.uint8)
    return [pano[8:8 + H, i * 8:i * 8 + W] for i in range(n)]


def record(slam, frames, K4, scores_fn):
    """Drive ``slam`` over ``frames`` and record each frame's decisions.
    ``scores_fn(graph, cand, i, c2w_all, pts_all, feat_all, K4)`` returns
    the NMS scores as the package computes them."""
    graph, backend = slam.graph, slam.backend
    scans = []
    detect, nms = graph.detect_loop, graph.nms

    def detect_rec(i, temporal_window=8):
        cand = detect(i, temporal_window=temporal_window)
        scans.append({"i": int(i), "detect": None if cand is None
                      else [int(c) for c in cand]})
        return cand

    def nms_rec(cand, i, c2w_all, pts_all, feat_all, K4, th=NMS_THRESH):
        pick = nms(cand, i, c2w_all, pts_all, feat_all, K4, th=th)
        s = scores_fn(graph, cand, i, c2w_all, pts_all, feat_all, K4)
        scans[-1].update(cand=[int(c) for c in cand],
                         scores=[float(x) for x in s],
                         pick=None if pick is None else int(pick))
        return pick

    graph.detect_loop, graph.nms = detect_rec, nms_rec
    rows = []
    n_edges = 0
    for t, img in enumerate(frames):
        t0 = time.time()
        count0 = slam.keyframes.count
        scans.clear()
        slam.run(t, img, K4)            # as the bench calls it
        kf = slam.keyframes
        ii, jj = np.asarray(graph.ii), np.asarray(graph.jj)
        edges = [[int(a), int(b)] for a, b in zip(ii[n_edges:], jj[n_edges:])]
        n_edges = len(ii)
        rows.append({
            "t": t, "keyframe": kf.count > count0, "kf_count": kf.count,
            "n_submaps": kf.n_submaps,
            "poses": np.asarray(kf.pose[:kf.count], np.float64).tolist(),
            "edges": edges, "scans": [dict(s) for s in scans],
            "closed": [int(c) for c in backend.closed],
            "seconds": round(time.time() - t0, 2)})
        print(json.dumps({k: rows[-1][k] for k in
                          ("t", "keyframe", "kf_count", "n_submaps",
                           "scans", "closed", "seconds")}), flush=True)
    return {"frames": rows, "closed": [int(c) for c in backend.closed],
            "closed_loop": {k: [int(x) for x in backend.closed_loop[k]]
                            for k in ("idx_current", "idx_matched")}}


def jax_half(args, work):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict
    sys.path.insert(0, ROOT)
    from cut3r_slam_tpu.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu.slam import factor_graph as FG
    from cut3r_slam_tpu.slam.system import SLAMSystem

    H, W = args.hw
    cfg = CUT3RConfig.tiny() if args.tiny else CUT3RConfig()
    t0 = time.time()
    params = CUT3R(cfg).init(jax.random.PRNGKey(0),
                             jnp.zeros((2, 1, H, W, 3), jnp.float32))
    flat = flatten_dict(params["params"], sep="/")
    pdir = os.path.join(work, "params")
    os.makedirs(pdir, exist_ok=True)
    names = sorted(flat)
    for i, k in enumerate(names):
        np.save(os.path.join(pdir, f"{i:05d}.npy"), np.asarray(flat[k]))
    with open(os.path.join(pdir, "names.json"), "w") as f:
        json.dump(names, f)
    print(f"init + save: {time.time() - t0:.1f} s", flush=True)

    model = CUT3R(dataclasses.replace(cfg, compute_dtype=jnp.float32))
    slam = SLAMSystem(model, params, bench_cfg(), buffer=64, img_hw=(H, W),
                      enable_mapping=False, enable_loop=True,
                      output_dir=os.path.join(work, "jax_out"))

    def scores(graph, cand, i, c2w_all, pts_all, feat_all, K4):
        fwd, rev = FG._overlap_to_all(
            pts_all[i], jnp.asarray(c2w_all), jnp.asarray(K4, jnp.float32),
            pts_all, jnp.asarray(np.linalg.inv(c2w_all[i])))
        sim = np.asarray(FG._feat_sim_to_all(feat_all[i], feat_all))
        overlap = (np.asarray(fwd) + np.asarray(rev)) / 2
        return 0.8 * overlap[cand] + 0.2 * sim[cand]

    frames = synth_frames(args.frames, H, W)
    K4 = np.asarray([0.9 * W, 0.9 * W, W / 2, H / 2], np.float32)
    return record(slam, frames, K4, scores)


def torch_run(model, args, work, name, mapping=False):
    """The port's ``SLAMSystem`` over the bench frames with ``model``."""
    from cut3r_slam_tpu_torch.slam.factor_graph import _feat_sim_to_all
    from cut3r_slam_tpu_torch.slam.system import SLAMSystem
    H, W = args.hw
    slam = SLAMSystem(model, bench_cfg(), buffer=64, img_hw=(H, W),
                      enable_mapping=mapping, enable_loop=True,
                      output_dir=os.path.join(work, f"{name}_out"),
                      device=model.device)

    def scores(graph, cand, i, c2w_all, pts_all, feat_all, K4):
        fwd, rev = graph._overlap(i, c2w_all, pts_all, K4)
        sim = _feat_sim_to_all(feat_all[i], feat_all).cpu().numpy()
        return 0.8 * ((fwd + rev) / 2)[cand] + 0.2 * sim[cand]

    frames = synth_frames(args.frames, H, W)
    K4 = np.asarray([0.9 * W, 0.9 * W, W / 2, H / 2], np.float32)
    return record(slam, frames, K4, scores)


def torch_half(args, work):
    import torch
    sys.path.insert(0, ROOT)
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu_torch.models.convert import params_from_jax

    torch.set_num_threads(os.cpu_count() or 1)
    pdir = os.path.join(work, "params")
    with open(os.path.join(pdir, "names.json")) as f:
        names = json.load(f)
    flat = {k: np.load(os.path.join(pdir, f"{i:05d}.npy"))
            for i, k in enumerate(names)}
    cfg = CUT3RConfig.tiny() if args.tiny else CUT3RConfig()
    model = CUT3R(dataclasses.replace(cfg, compute_dtype=torch.float32),
                  device="cpu")
    model.load_state_dict(params_from_jax(flat), strict=True)
    model.eval()
    del flat
    with torch.no_grad():
        return torch_run(model, args, work, "torch")


def card_runs(args, work):
    """The port's bench draw on the card (``torch.Generator(device=
    "cuda")``, bf16, as ``cut3r_slam_tpu_torch/bench.py`` makes it) over
    the same frames with mapping off, then with the bench's mapping on
    (one pass, no warm-up). Writes ``card_nomap.json`` and
    ``card_map.json``."""
    import subprocess as sp
    import torch
    sys.path.insert(0, ROOT)
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    card = sp.run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"], capture_output=True,
                  text=True).stdout.strip()
    out = {}
    for name, mapping in (("card_nomap", False), ("card_map", True)):
        t0 = time.time()
        model = CUT3R(CUT3RConfig.tiny() if args.tiny else CUT3RConfig(),
                      device="cuda")
        model.init_random(torch.Generator(device="cuda").manual_seed(0))
        model.eval()
        res = torch_run(model, args, work, name, mapping)
        res.update(package="torch", device=card, mapping=mapping,
                   precision=str(model.cfg.compute_dtype),
                   seconds=round(time.time() - t0, 1))
        with open(os.path.join(work, f"{name}.json"), "w") as f:
            json.dump(res, f, indent=2)
        out[name] = {"closed": res["closed"],
                     "closed_loop": res["closed_loop"],
                     "seconds": res["seconds"]}
        del model
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, **out}))


DECISIONS = ("keyframe", "kf_count", "n_submaps", "edges", "closed")


def compare(work):
    """The first frame at which the halves' decisions part, the largest
    keyframe-pose difference and NMS-score difference before it, and the
    smallest margin of an NMS score to the threshold."""
    res = {}
    for half in ("jax", "torch"):
        with open(os.path.join(work, f"{half}.json")) as f:
            res[half] = json.load(f)
    fj, ft = res["jax"]["frames"], res["torch"]["frames"]
    first, why = None, None
    pose_diff = 0.0
    for a, b in zip(fj, ft):
        diff = [k for k in DECISIONS if a[k] != b[k]]
        sa = [(s["i"], s["detect"], s.get("cand"), s.get("pick"))
              for s in a["scans"]]
        sb = [(s["i"], s["detect"], s.get("cand"), s.get("pick"))
              for s in b["scans"]]
        if sa != sb:
            diff.append("scans")
        if diff:
            first, why = a["t"], diff
            break
        pose_diff = max(pose_diff, float(np.abs(np.subtract(
            a["poses"], b["poses"])).max()))
    margins = {}
    score_diff = 0.0
    for half, fr in (("jax", fj), ("torch", ft)):
        s = [x for r in fr for sc in r["scans"] for x in sc.get("scores", [])]
        margins[half] = (min(abs(x - NMS_THRESH) for x in s) if s else None,
                         max(s) if s else None, len(s))
    for a, b in zip(fj[:first], ft[:first]):
        for x, y in zip(a["scans"], b["scans"]):
            if "scores" in x and "scores" in y:
                score_diff = max(score_diff, float(np.abs(np.subtract(
                    x["scores"], y["scores"])).max()))
    out = {"frames": [len(fj), len(ft)],
           "first_parting_frame": first, "parted_on": why,
           "max_pose_diff_before": pose_diff,
           "max_score_diff_before": score_diff,
           "nms_thresh": NMS_THRESH,
           "nms_margin_min_max_count": margins,
           "closed": {h: res[h]["closed"] for h in res},
           "closed_loop": {h: res[h]["closed_loop"] for h in res},
           "seconds": {h: res[h]["seconds"] for h in res}}
    with open(os.path.join(work, "compare.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--only", choices=["torch", "jax"], default=None)
    p.add_argument("--compare", action="store_true")
    p.add_argument("--card", action="store_true",
                   help="the port's own bench draw on the card, mapping off "
                        "then on")
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--tiny", action="store_true",
                   help="CUT3RConfig.tiny() at 64x96: a quick rehearsal")
    p.add_argument("--work", default=os.path.join(ROOT, "build",
                                                  "bench_parity"))
    args = p.parse_args()
    args.hw = (64, 96) if args.tiny else (384, 512)
    work = args.work.rstrip("/") + ("_tiny" if args.tiny else "")
    os.makedirs(work, exist_ok=True)
    if args.compare:
        compare(work)
        return
    if args.card:
        card_runs(args, work)
        return
    if args.only is None:
        for half in ("jax", "torch"):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--only", half, "--frames", str(args.frames),
                            "--work", args.work]
                           + (["--tiny"] if args.tiny else []), check=True)
        compare(work)
        return
    t0 = time.time()
    res = (jax_half if args.only == "jax" else torch_half)(args, work)
    res.update(package=args.only, hw=list(args.hw), tiny=args.tiny,
               precision="float32", seconds=round(time.time() - t0, 1))
    with open(os.path.join(work, f"{args.only}.json"), "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps({"package": args.only, "closed": res["closed"],
                      "seconds": res["seconds"]}))


if __name__ == "__main__":
    main()
