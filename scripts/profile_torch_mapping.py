"""Where the PyTorch/CUDA port spends its time, on one NVIDIA GPU: the
per-layer trace tool behind PERF.md section 5.

    python3 scripts/profile_torch_mapping.py

Three parts, each at the slice's real widths, on the scenes and model of
chip_smoke.py:

* tracking: the full-width CUT3R (random weights from seed 0, bf16) on
  384x512 frames, timing one encoder call (``MotionFilter.encode``, once
  per keyframe) and one 6-view submap decode (``TrackFrontend.infer_views``,
  once per submap);
* mapping: a MappingBackend at the mapping shape (384x512, arena 2^17,
  max_per_tile 512) with six keyframes of the synthetic panorama, two of
  them seeded as a textured plane (~2 x 49k Gaussians alive), timing one
  iteration of each step kind: a 6-view window optimization, a one-view
  global-BA iteration, a pose refinement (which also re-bins once and
  renders its seeding pass), the batched pose refinement of five views
  (``parallel_kf_refine``) and one global-BA block of the production
  schedule (4 views a step, 4 steps sharing one binning);
* loop closure, at the shapes of chip_smoke.py's phase 7: one
  ``pgo_align`` over 3 submaps of 192x256 pointmaps (200 of its 2000
  Adam iterations), one ``gaussian_update`` of the mapping backend above
  (both submaps moved, then the 6 cameras' pose refinements at phase 7's
  10 iterations each) and one Sim(3) PGBA solve over 21 keyframes (20
  odometry edges and a loop edge, 6 Gauss-Newton iterations).

Prints per-step wall times (host clock around synchronized work, the mean
of three calls), then for each step one profiled call (torch.profiler,
after one warm-up session that absorbs the profiler's start-up): its
kernel launches, the sum of its kernels' device time against the
unprofiled wall time (busy share), and the top kernels by device time.
Every line carries the card's name and power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import plausible_random_cut3r, synth_frames  # noqa: E402
from cut3r_slam_tpu_torch.models import normalize_images  # noqa: E402
from cut3r_slam_tpu_torch.models.patch_embed import \
    patch_positions  # noqa: E402
from cut3r_slam_tpu_torch.ops import gs_raster_cuda as G  # noqa: E402
from cut3r_slam_tpu_torch.slam.mapping import (MappingBackend,  # noqa: E402
                                               MappingConfig)

H, W, F = 384, 512, 400.0
SUBMAP_VIEWS = 6


def timed(fn, n=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def tracking_steps(imgs):
    model = plausible_random_cut3r(seed=0)
    dev = model.device
    x = normalize_images(torch.as_tensor(imgs[0], device=dev))[None]
    with torch.inference_mode():
        feats = torch.stack([model.encode_image(normalize_images(
            torch.as_tensor(im, device=dev))[None])[0][0]
            for im in imgs[:SUBMAP_VIEWS]])
    pos = patch_positions(SUBMAP_VIEWS, H // 16, W // 16, dev)[:, None]

    @torch.inference_mode()
    def encode():
        model.encode_image(x)

    @torch.inference_mode()
    def decode():
        model.decode_views(feats[:, None], pos, H, W,
                           head_outputs=("self", "pose"))
    return {"CUT3R encode, 1 frame": encode,
            f"CUT3R submap decode, {SUBMAP_VIEWS} views": decode}


def mapping_steps(imgs):
    K4 = np.asarray([F, F, W / 2, H / 2], np.float32)
    cfg = MappingConfig(height=H, width=W, capacity=2 ** 17, cam_capacity=16,
                        window_size=10, opt_segment=1, gba_segment=1,
                        pose_refine_iters=1)
    be = MappingBackend(cfg, K4, device="cuda")
    depth = np.full((H, W), 2.0, np.float32)
    yy, xx = np.meshgrid(np.arange(0, H, 2), np.arange(0, W, 2),
                         indexing="ij")
    for i, img in enumerate(imgs):
        w2c = np.eye(4, dtype=np.float32)
        w2c[0, 3] = -0.01 * i
        be.add_keyframe(i, img, depth, w2c)
        if i < 2:
            pts = np.stack([(xx - W / 2) / F * 2.0, (yy - H / 2) / F * 2.0,
                            np.full(xx.shape, 2.0)], -1) - w2c[:3, 3]
            be.seed(i, pts, img[::2, ::2] / 255.0, np.ones(xx.shape, bool), i)
    be.initialized = True
    window = list(range(len(imgs)))

    def gba_block():
        import dataclasses
        base = be.cfg
        be.cfg = dataclasses.replace(base, gba_views_per_iter=4,
                                     gba_resample_every=4, gba_segment=4)
        try:
            be.global_ba(16, densify=False)
        finally:
            be.cfg = base
    return be, {
        f"window V={len(window)} (opt + pose), 1 iteration":
            lambda: be.optimization(1, window),
        "global BA, 1 view, 1 iteration":
            lambda: be.global_ba(1, densify=False),
        "pose refine, 1 view, 1 iteration + seeding render":
            lambda: be.pose_refine(len(window) - 1),
        "pose refine batched, 5 views, 1 iteration + seeding render":
            lambda: be.pose_refine_multi(window[1:]),
        "global BA block, 4 views x 4 steps, one binning": gba_block}


def loop_closure_steps(be):
    """The loop-closure steps; ``be`` is the mapping backend of
    mapping_steps (its gaussian_update runs last: it moves the map)."""
    import dataclasses
    from chip_smoke import drift_chain
    from cut3r_slam_tpu_torch.slam.backend import pgo_align
    from cut3r_slam_tpu_torch.slam.keyframe import KeyframeStore
    from cut3r_slam_tpu_torch.slam.sim3_pgo import PGBABuffer
    dev = be.device
    sub, surface, conf = drift_chain(3, seed=0, h=H // 2, w=W // 2)
    sub, conf = torch.tensor(sub, device=dev), torch.tensor(conf, device=dev)
    cur, lc = sub[2, 3], torch.tensor(surface, device=dev)

    kf = KeyframeStore(32, (16, 16), 1, 4, device=dev)
    rng = np.random.default_rng(0)
    for i in range(21):
        pose = np.zeros(7, np.float32)
        pose[:3] = [0.25 * min(i, 20 - i), 0.0, 0.0] + rng.normal(0, .02, 3)
        pose[6] = 1.0
        kf.append(2 * i, np.zeros((16, 16, 3), np.uint8), pose=pose)
    kf.depth[:21] = 2.0
    pgba = PGBABuffer()
    pgba.on_new_keyframes(kf, 21)
    pgba.on_loop(4, 13, kf)

    upd = np.zeros((2, 7), np.float32)
    upd[:, 3:] = [0.0, 0.0, 0.0, 1.0]
    upd[1, :3] = [0.001, -0.001, 0.0005]
    cams = list(range(6))

    def gaussian_update():
        cfg = be.cfg
        be.cfg = dataclasses.replace(cfg, pose_refine_iters=10)
        try:
            be.gaussian_update([0, 1], upd, cams,
                               list(be.cams.w2c[:6].cpu().numpy()))
        finally:
            be.cfg = cfg
    return {
        "pgo_align, 3 submaps of 192x256, 200 iterations":
            lambda: pgo_align(sub, conf, cur, lc, iters=200),
        "PGBA solve, 21 keyframes, 21 edges, 6 iterations":
            lambda: pgba.solve_and_writeback(kf),
        "gaussian_update, 2 submaps, 6 cameras x 10 refine iterations":
            gaussian_update}


def profile_step(name, fn, wall_ms, card):
    """Device time of one call, from the profiler's kernel rows (the
    operator rows repeat their kernels' time), against the unprofiled
    wall time of the same call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernel rows only: a user annotation (the optimizer's
    # ``Optimizer.step#...`` range) also lands on the device timeline
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"[profile] {name}: {launches} kernel launches, device {total:.2f} "
          f"ms of {wall_ms:.2f} ms wall (busy share {total / wall_ms:.2f}) "
          f"| {card}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    imgs = synth_frames(SUBMAP_VIEWS, H, W)
    steps = tracking_steps(imgs)
    be, map_steps = mapping_steps(imgs)
    steps.update(map_steps)
    steps.update(loop_closure_steps(be))
    print(f"alive Gaussians {int(be.arena.alive.sum())} | {card}")
    walls = {name: timed(fn) for name, fn in steps.items()}
    for name, ms in walls.items():
        print(f"[wall] {name}: {ms:.2f} ms | {card}")
    profile_step("warm-up (profiler start-up)", steps[next(iter(steps))],
                 walls[next(iter(steps))], card)
    for name, fn in steps.items():
        profile_step(name, fn, walls[name], card)
    print(f"launches {G.LAUNCHES} | {card}")


if __name__ == "__main__":
    main()
