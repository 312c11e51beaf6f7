"""Where a CUT3R training step of the PyTorch/CUDA port spends its time, on
one NVIDIA GPU (PERF.md section 5, the training cell of chip_smoke.py's
phase 9).

    python3 scripts/profile_torch_training.py

The full-width CUT3R with all four heads (``init_trainable`` from seed 0,
as in phase 9; bf16 compute over f32 master weights) on a procedural
scene of 18 views written at 384x512. It times,
at V=4, B=1: the forward pass that keeps the autograd graph, the forward
and its backward, one AdamW step alone (the gradients of a backward kept
in place), and the whole ``make_train_step``; and one
``make_tbptt_train_step`` at V=16 (chunks of 4, gradient through the
last).

Prints per-piece wall times (host clock around synchronized work, the
mean of three calls) and peak memory, then for each piece one profiled
call (torch.profiler, after one warm-up profile): its kernel launches,
the sum of its kernels' device time against the unprofiled wall time
(busy share), and the top kernels by device time. Every line carries
the card's name and power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cut3r_slam_tpu_torch.datasets import (  # noqa: E402
    MultiViewDataset, SceneFolderSource, SceneLayout,
    generate_multiview_scenes, make_batch_iter)
from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig  # noqa: E402
from cut3r_slam_tpu_torch.train.losses import cut3r_total_loss  # noqa: E402
from cut3r_slam_tpu_torch.train.train_step import (  # noqa: E402
    init_train_state, make_tbptt_train_step, make_train_step, to_device)
from profile_torch_mapping import profile_step, timed  # noqa: E402

HW = (384, 512)


def batch(root, num_views, seed):
    """One batch of ``num_views`` views of the scene under ``root`` (a
    span of 16 in a scene of 18 views: no view repeats)."""
    ds = MultiViewDataset(SceneFolderSource(root, SceneLayout("synth")),
                          num_views=num_views, span=16, resolution=HW,
                          seed=seed)
    return to_device(next(make_batch_iter(ds, 1, seed)), "cuda")


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="profile_training_",
                            dir=os.path.join(ROOT, "build"))
    generate_multiview_scenes(root, n_scenes=1, views_per_scene=18, hw=HW,
                              seed=0)
    b4, b16 = batch(root, 4, 0), batch(root, 16, 1)
    model = CUT3R(CUT3RConfig(), device="cuda")
    opt = init_train_state(model, torch.Generator("cuda").manual_seed(0),
                           lr=1e-5, weight_decay=0.05, warmup_steps=0,
                           total_steps=100)

    gt = {k: b4[k] for k in ("pts3d", "camera_pose", "valid_mask", "img")}

    def forward():
        return cut3r_total_loss(model(b4["imgs"]), gt)[0]

    def forward_backward():
        opt.zero_grad(set_to_none=True)
        forward().backward()

    forward_backward()
    steps = {"forward V=4 (autograd graph kept)": forward,
             "forward + backward V=4": forward_backward,
             "AdamW step alone (789.8 M parameters)": opt.step,
             "make_train_step V=4": lambda: make_train_step(model, opt)(b4),
             "make_tbptt_train_step V=16, chunk 4": lambda:
                 make_tbptt_train_step(model, opt, chunk=4,
                                       grad_chunks=1)(b16)}
    for name, fn in steps.items():
        torch.cuda.reset_peak_memory_stats()
        ms = timed(fn)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps[name] = (fn, ms)
        print(f"[wall] {name}: {ms:.2f} ms, peak {peak:.2f} GiB | {card}",
              flush=True)
    first = next(iter(steps.values()))
    profile_step("warm-up (profiler start-up)", first[0], first[1], card)
    for name, (fn, ms) in steps.items():
        profile_step(name, fn, ms, card)


if __name__ == "__main__":
    main()
