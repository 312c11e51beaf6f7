"""Where the DROID stack and the live viewer of the PyTorch/CUDA port spend
their time, on one NVIDIA GPU (PERF.md section 5, chip_smoke.py's phase
12).

    python3 scripts/profile_torch_droid.py

* DROID, at phase 12's clip: ``DroidNet`` at its full widths (random
  weights from seed 0) on 7 synthetic frames of 384x512 (grid 48x64), the
  22 edges |i - j| <= 2, fixedp 2, at torch's default precision (cuDNN
  convolutions with TF32 allowed; the BA under ``full_f32``): the feature
  and context encoders, the correlation pyramid, a forward of one GRU
  step and of 12 (no gradient), one 2-iteration ``bundle_adjust`` alone
  and one value-and-grad step at num_steps 2;
* the viewer's ``/api/render`` without its HTTP: ``render_view`` of a
  mapping backend holding ~98k Gaussians (scripts/profile_torch_mapping.py's
  scene) at 384x512, its copy to the host, and the PNG encode.

Prints per-piece wall times (host clock around synchronized work, the
mean of three calls), then for each piece one profiled call (after one
warm-up session that absorbs the profiler's start-up): its kernel
launches, the sum of its kernels' device time against the wall time
(busy share) and the top kernels. Every line carries the card's name and
power limit.
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

from chip_smoke import (DROID_FRAMES, DROID_STEPS, droid_clip,  # noqa: E402
                        droid_edges, synth_frames)
from cut3r_slam_tpu_torch import full_f32  # noqa: E402
from cut3r_slam_tpu_torch.gui.server import _encode_png  # noqa: E402
from cut3r_slam_tpu_torch.models.blocks import init_random  # noqa: E402
from cut3r_slam_tpu_torch.models.droid_net import DroidNet  # noqa: E402
from cut3r_slam_tpu_torch.ops.ba import bundle_adjust  # noqa: E402
from cut3r_slam_tpu_torch.ops.corr import build_corr_pyramid  # noqa: E402
from cut3r_slam_tpu_torch.slam.renderer import render_view  # noqa: E402
from profile_torch_mapping import (H, W, mapping_steps,  # noqa: E402
                                   profile_step, timed)


def droid_steps(frames):
    h8, w8 = H // 8, W // 8
    net = init_random(DroidNet(device="cuda"),
                      torch.Generator(device="cuda").manual_seed(0))
    poses, disps, intr = droid_clip(DROID_FRAMES, h8, w8, 400.0 / 8, 20)
    ii, jj = droid_edges(DROID_FRAMES)
    args = [torch.tensor(a, device="cuda") for a in (
        poses, np.stack(frames[:DROID_FRAMES]).astype(np.float32), disps,
        intr, ii, jj, np.ones(len(ii), np.float32))]
    p, imgs, d, k, ii, jj, ev = args
    with torch.no_grad():
        fmaps = net.extract_features(imgs)[0].permute(0, 2, 3, 1)
        target = p.new_zeros(len(ii), h8, w8, 2) + 0.5 * w8
    weight = torch.full_like(target, 0.5)
    eta = torch.full((DROID_FRAMES, h8, w8), 1e-2, device="cuda")

    @torch.no_grad()
    def forward(steps):
        net(*args, num_steps=steps, fixedp=2)

    def grad_step():
        net.zero_grad()
        net(*args, num_steps=2, fixedp=2)[2].abs().mean().backward()

    @torch.no_grad()
    def features():
        net.extract_features(imgs)

    @torch.no_grad()
    def pyramid():
        build_corr_pyramid(fmaps[ii], fmaps[jj])

    return {
        f"DroidNet features, {DROID_FRAMES} frames {H}x{W}": features,
        f"correlation pyramid, {len(ii)} edges": pyramid,
        "DroidNet forward, 1 GRU step": lambda: forward(1),
        f"DroidNet forward, {DROID_STEPS} GRU steps":
            lambda: forward(DROID_STEPS),
        "bundle_adjust, 2 iterations": lambda: bundle_adjust(
            target, weight, eta, p, d, k, ii, jj, ev, fixedp=2, steps=2),
        "DroidNet value-and-grad, 2 GRU steps": grad_step}


def viewer_steps(frames):
    be, _ = mapping_steps(frames[:6])
    w2c = torch.eye(4, device="cuda")
    holder = {}

    @torch.no_grad()
    @full_f32()
    def render():
        arena, _ = be._sliced()
        out = render_view(arena.params(), arena.alive, w2c, be.K4,
                          be.raster_cfg)
        holder["img"] = (torch.clamp(out["color"], 0.0, 1.0).cpu().numpy()
                         * 255).astype(np.uint8)

    render()
    return be, {f"viewer render_view + copy to host, {H}x{W}": render,
                f"viewer PNG encode, {H}x{W}":
                    lambda: _encode_png(holder["img"])}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    frames = synth_frames(24, H, W)
    steps = droid_steps(frames)
    be, vsteps = viewer_steps(frames)
    steps.update(vsteps)
    print(f"alive Gaussians {int(be.arena.alive.sum())} | {card}")
    walls = {}
    for name, fn in steps.items():
        torch.cuda.reset_peak_memory_stats()
        walls[name] = timed(fn)
        print(f"[wall] {name}: {walls[name]:.2f} ms, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | "
              f"{card}", flush=True)
    t0 = time.perf_counter()
    first = next(iter(steps))
    profile_step("warm-up (profiler start-up)", steps[first], walls[first],
                 card)
    for name, fn in steps.items():
        profile_step(name, fn, walls[name], card)
    print(f"[profile] done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
