"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero, and no result line is printed):
1. environment: torch / CUDA / nvcc versions, the card's name and power
   limit;
2. build: nvcc builds every kernel source of the checkout (in parallel);
3. kernel parity: the tile-blend forward (K1) and backward (K2) kernels
   against their plain PyTorch versions, on the 32x32 test scene, on a
   staging-edge scene (staging_scene: ragged extents, pixels stopping
   inside a stage) and at the mapping shape (512x384, 2^17 Gaussians,
   max_per_tile 512) in the single-view and the V=10 multi-view form;
4. kernel times at the mapping shape (CUDA events), beside the plain
   versions and the bound the card could reach;
5. small-input agreement: one mapping event on the synthetic plane of
   tests/test_torch_mapping.py on the card vs on the CPU;
5b. loop-closure solvers, card vs CPU: pgo_align, pgo_align_multi and
   sim3_pgo_solve on the same small seeded inputs (max |card - cpu| /
   max |cpu| below 1e-4: both run f32 in another summation order, where
   TF32 products would differ by ~5e-4 and a scatter that dropped
   duplicate edges by far more);
5c. batched mapping paths, card vs CPU, at phase 5's shape: one
   pose_refine_multi over three views (poses and scaled-depth pointmaps
   within 1e-4 relative: one refinement is deterministic up to summation
   order) and one global BA of 4 views a step in blocks of 4 steps sharing
   a binning, with injected draws (per-step losses within 1e-2 relative as
   in phase 5, poses within 2e-2);
6. the live slice: SLAMSystem.run over 384x512 synthetic frames with the
   full-width CUT3R (random weights from a seed), loop closure on (the
   JAX package's default; whether a closure fires on random weights is
   printed, not required) and Gaussian mapping, at least two mapping
   events, then terminate; both kernels' launch counters must rise;
7. the loop-closure path at full width: SLAMSystem.run_test (ground-truth
   depth and poses injected in place of the submap decode, relative
   poses perturbed) on an out-and-back trajectory over a textured plane
   at 384x512 with the full-width CUT3R in the motion filter, mapping on,
   the Sim(3) PGBA on and 2000-step PGOs; then one more closure called
   directly, so the repeat-closure PGO (pgo_align_multi) runs at full
   width. It fails unless a closure fired, the seam error and the loop
   error fell across it (mapping moves the keyframe poses that anchor
   the next submap, so the seams are open before the closure), the corrected
   submaps' Gaussians moved, K1 and K2 launched inside gaussian_update,
   and the PGBA scales, poses, depths and Gaussians are finite;
8. the demo driver at the JAX package's production mapping schedule:
   ``cut3r_slam_tpu_torch.demo.main`` over phase 6's frames written as
   512x384 PNGs, full-width CUT3R (phase 6's random weights), loop closure
   on, with parallel keyframe refinement, 4-view global-BA steps in
   4-step blocks, interleave 3 and early stop 0.01 (bench.py's TPU
   schedule) at phase 6's iteration cuts, then terminate with its eval.
   The driver's own ``build_model`` runs once first (no checkpoint:
   random init from seed 0) and must give phase 6's tensors but for the
   two head layers phase 6 rescales; the run then uses phase 6's model.
   The phase attaches a stage timer to the system (the driver, as
   demo.py, times only frames and terminate), so its frame times include
   one synchronization per stage. It fails unless every output file exists, the keyframe eval holds a
   finite PSNR over every valid keyframe, renders_kf holds a colour and a
   depth per keyframe, no frame without a new submap ran more than 3
   mapping slices, K1 and K2 launched inside the batched refine and the
   batched global BA, and all state is finite;
9. CUT3R training at full width (``CUT3RConfig()`` with the self, cross,
   rgb and pose heads, random weights from seed 0, bf16 compute over f32
   master weights, f32 gradients and AdamW state) on procedural scenes
   written at 384x512 (``generate_multiview_scenes`` ->
   ``SceneFolderSource`` -> ``MultiViewDataset`` -> ``make_batch_iter``):
   first the tiny model card vs CPU (f32, no TF32): three
   ``make_train_step`` steps and one truncated-BPTT step from the same
   weights and batches, losses within 1e-5 relative, the gradient of
   every parameter tensor (Adam's first moment after each step taken at
   the starting weights) within 1e-4 of its norm plus 1e-6 of the
   largest tensor's, parameters within
   1e-5 on all but 1e-4 of the elements and the rest within two Adam
   steps, and three steps of ``train`` on the card giving the same
   losses; then step A, ``make_train_step`` on one V=4 batch repeated for
   10 steps (warmup 2 of 10), whose loss at step 10 must be below its
   loss at step 2 (the first update is zero by the schedule); then step
   B, from the same initial weights and schedule, three
   ``make_tbptt_train_step`` steps over V=16 in chunks of 4 with
   gradient through the last, weight decay 0: every encoder and
   patch-embedding tensor must stay bitwise unchanged and the decoder
   must move. The random weights are the package's training init
   (``init_train_state`` / ``init_trainable``: ``init_random`` with the
   pointmap heads' last convolution scaled by 0.05). Every loss
   must be finite, and K1 and K2 must not launch;
then the kernels JSON line, the card line and the result JSON line.

Tolerances (K1 vs plain): every output within 1e-3 + 1e-3|ref| on all but
1e-4 of its elements, the rest bounded by 0.05: single elements may flip
where the T_MIN stop or the quantized median gate sits within float
rounding of its threshold (the kernel multiplies transmittance
sequentially, the plain version through a chunk prefix product). K2 vs
the plain VJP, channel by channel (the 16 packed channels differ in scale
by four orders): max |err_k| / max |ref_k| < 5e-4 for every k (the JAX
suite's gradient tolerance), with the median depth's cotangent nonzero;
rows where K1 and its plain version chose another median contributor
(mdep apart by more than 1e-5 (1 + |mdep|)) are left out of the depth
channels 13-15 only, and counted.

Bounds: the largest of bytes / HBM rate, FP32 FLOPs / FP32 peak and MUFU
operations / MUFU rate, with the (entry, pixel) pairs counted from this
run's inputs by kind (rejected, stopping, blended) and each kind costed
from the kernel bodies (FLOPS_PER_PAIR, MUFU_PER_PAIR).
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks at the 700 W limit (NVIDIA data sheet; 132 SMs at 1.98 GHz)
PEAK_FP32 = 67e12               # FP32 FLOP/s outside the tensor cores
PEAK_MUFU = 132 * 16 * 1.98e9   # exp / reciprocal results per s (16/clk/SM)
PEAK_BYTES = 3.35e12            # HBM3 B/s
# Least work per (entry, pixel) pair the blend visits, counted from the
# kernel bodies as (rejected, stopping, blended) pairs; FMA = 2 FLOPs.
# rejected (alpha < 1/255): power polynomial 5 FMA, the exp's scale, the
#   0.99 clamp, the test = 13 FLOPs and one MUFU exp;
# stopping (T (1 - alpha) < T_MIN): + 1 - alpha, the product, the test = 16;
# blended, K1: + alpha T, 8 + 2 + 1 FMA (channels, depth, its sum) and the
#   median gate = 43;
# blended, K2: the recompute (16) + the cotangent b (9 FMA), dalpha, the
#   median gate, dt, dpower, the suffix FMA, 16 products and their 16 sums
#   into the per-entry reduction = 85, and one more MUFU (1 / (1 - alpha)).
FLOPS_PER_PAIR = {"gs_blend_fwd": (13, 16, 43), "gs_blend_bwd": (13, 16, 85)}
MUFU_PER_PAIR = {"gs_blend_fwd": (1, 1, 1), "gs_blend_bwd": (1, 1, 2)}


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def card_line():
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return p.stdout.strip().splitlines()[0] if p.returncode == 0 else \
        "unknown card"


def synth_frames(n, H, W, seed=0):
    """Sliding-window panorama: textured, overlapping, translating (the
    port's copy of the JAX package's benchmark frames)."""
    rng = np.random.default_rng(seed)
    pano = rng.uniform(0, 255, (H + 16, W + 8 * n, 3)).astype(np.float32)
    for _ in range(2):
        pano = (pano + np.roll(pano, 1, 0) + np.roll(pano, 1, 1)
                + np.roll(pano, -1, 0) + np.roll(pano, -1, 1)) / 5.0
    pano = pano.astype(np.uint8)
    return [np.ascontiguousarray(pano[8:8 + H, i * 8:i * 8 + W])
            for i in range(n)]


def cuda_ms(fn, n=20):
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


# ---------------------------------------------------------------------------
# kernel inputs
# ---------------------------------------------------------------------------

def frustum_scene(P, H, W, f, V, seed):
    """P random Gaussians filling a view frustum (depth 1.5-4.5), seen by
    V slightly shifted cameras. Returns camera-frame (V, P, 3) means,
    (V, P, 4) quats and the shared attributes, on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    z = torch.rand(P, generator=g, device=dev) * 3 + 1.5
    xy = (torch.rand(P, 2, generator=g, device=dev) - 0.5) \
        * torch.tensor([W / f, H / f], device=dev) * z[:, None] * 1.1
    m = torch.cat([xy, z[:, None]], 1)
    q = torch.randn(P, 4, generator=g, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    s = torch.rand(P, 3, generator=g, device=dev) * 0.02 + 0.005
    o = torch.rand(P, generator=g, device=dev) * 0.8 + 0.1
    c = torch.rand(P, 3, generator=g, device=dev)
    shift = torch.tensor([0.01, -0.005, 0.01], device=dev)
    return (torch.stack([m + v * shift for v in range(V)]),
            torch.stack([q] * V), s, o, c)


def small_scene():
    """The random 32x32 scene of tests/test_torch_gs_raster.py, V=3."""
    import torch
    rng = np.random.default_rng(3)
    n = 50
    means = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(1.0, 3.0, n)], -1)
    q = rng.normal(size=(n, 4))
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    arrs = [torch.tensor(np.asarray(a, np.float32), device="cuda") for a in (
        means, q, rng.uniform(0.02, 0.1, (n, 3)), rng.uniform(0.2, 0.9, n),
        rng.uniform(0, 1, (n, 3)))]
    shift = torch.tensor([0.02, -0.01, 0.03], device="cuda")
    arrs[0] = torch.stack([arrs[0] + v * shift for v in range(3)])
    arrs[1] = torch.stack([arrs[1]] * 3)
    return arrs


# (extent, opacity range) per row of staging_scene; K = 200 is a multiple
# of no staging size (32-entry chunks, 128-entry K1 stages)
STAGING_ROWS = ((0, (0.1, 0.5)), (1, (0.3, 0.9)), (31, (0.1, 0.6)),
                (33, (0.1, 0.6)), (200, (0.02, 0.15)),  # never stops
                (200, None),                            # every entry rejected
                (200, (0.2, 0.7)),      # pixels stop inside the first stage
                (97, (0.8, 0.99)),      # every pixel stops: early exit
                (200, (0.16, 0.45)))    # stops around the stage boundary


def staging_scene(seed=0, K=200):
    """Packed entries (numpy f32 (R, K, 16), extent int32 (R,)) built to
    break larger stages: ragged extents 0, 1, 31, 33, 97 and K in one
    launch, pixels that stop in the middle of a stage, and a row whose
    entries are all rejected. Each entry is a 2D Gaussian in tile pixels,
    packed as ops/gs_raster_cuda._assemble_A packs one."""
    rng = np.random.default_rng(seed)
    R = len(STAGING_ROWS)
    mx = rng.uniform(-6.0, 22.0, (R, K))
    my = rng.uniform(-6.0, 22.0, (R, K))
    s0, s1 = rng.uniform(2.0, 9.0, (2, R, K))
    rho = rng.uniform(-0.5, 0.5, (R, K))
    c0, c2, c1 = 1.0 / s0 ** 2, 1.0 / s1 ** 2, rho / (s0 * s1)
    opa = np.stack([rng.uniform(*o, K) if o else np.full(K, 1e-13)
                    for _, o in STAGING_ROWS])
    q0 = -0.5 * (c0 * mx * mx + c2 * my * my) - c1 * mx * my + np.log(opa)
    t0 = np.sort(rng.uniform(1.0, 3.0, (R, K)), 1)
    rp = rng.uniform(-0.01, 0.01, (2, R, K))
    A = np.stack([*rng.uniform(0.0, 1.0, (6, R, K)), np.ones((R, K)),
                  q0, c0 * mx + c1 * my, c2 * my + c1 * mx, -0.5 * c0,
                  -0.5 * c2, -c1, t0 + rp[0] * mx + rp[1] * my, -rp[0],
                  -rp[1]], -1)
    ext = np.asarray([e for e, _ in STAGING_ROWS], np.int32)
    return A.astype(np.float32), ext


# ---------------------------------------------------------------------------
# kernel parity
# ---------------------------------------------------------------------------

def k1_errors(G, A, ext):
    """K1 against the plain forward. Returns (max error of O / dsum / tleft
    / tchk, the largest fraction of elements off, the kernel's outputs, and
    the (R,) mask of rows where the two chose another median contributor:
    mdep apart by more than 1e-5 (1 + |mdep|), where rounding alone moves
    it by about 1e-7)."""
    (O, d, md, T), tchk = G.blend_forward(A, ext, with_residuals=True)
    (O2, d2, md2, T2), tchk2 = G.blend_forward_plain(A, ext, True)
    worst, flips = 0.0, 0.0
    for name, a, b in (("O", O[..., :7], O2[..., :7]), ("dsum", d, d2),
                       ("mdep", md, md2), ("tleft", T, T2),
                       ("tchk", tchk, tchk2)):
        err = (a - b).abs()
        bad = err > 1e-3 + 1e-3 * b.abs()
        frac = float(bad.float().mean())
        flips = max(flips, frac)
        emax = float(err.max())
        if name != "mdep":
            worst = max(worst, emax)
        if frac > 1e-4 or (emax > 0.05 and name != "mdep"):
            fail(f"K1 {name}: {frac:.2e} of elements off, max err {emax}")
    med_flip = ((md - md2).abs() > 1e-5 * (1 + md2.abs())).any(1)
    return worst, flips, (O, d, md, T, tchk), med_flip


def k2_errors(G, A, ext, tchk, T, cots, rows_per_call, med_flip):
    """K2 against the plain VJP, channel by channel: max over entries of
    |err_k| / max |ref_k| for each of the 16 channels. The depth channels
    13-15 leave out the rows in ``med_flip`` (where kernel and plain K1
    chose another median contributor: that pixel's gmd then lands on
    another entry's dt). Returns (per-channel errors, max |err|)."""
    import torch
    dA = G.blend_backward(A, ext, tchk, T, *cots)
    ref = torch.cat([G.blend_backward_plain(
        A[r:r + rows_per_call], ext[r:r + rows_per_call],
        *[c[r:r + rows_per_call] for c in cots])
        for r in range(0, A.shape[0], rows_per_call)], 0)
    err = (dA - ref).abs()
    err[med_flip, :, 13:] = 0.0
    rel = err.amax((0, 1)) / ref.abs().amax((0, 1)).clamp(min=1e-12)
    bad = [k for k in range(rel.shape[0]) if not float(rel[k]) < 5e-4]
    if bad:
        fail(f"K2 channels {bad}: max err / max |ref| = "
             f"{[float(rel[k]) for k in bad]}")
    return rel, float(err.max())


def cotangents(O, d, T):
    """Seeded standard-normal cotangents of K1's four outputs (the median
    depth's included)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(1)
    return [torch.randn(x.shape, generator=g, device="cuda")
            for x in (O, d, d, T)]


def blend_census(A, ext):
    """The (entry, pixel) pairs the kernels visit on these inputs, as
    (rejected, stopping, blended), from the plain forward's decisions
    taken chunk by chunk as blend_forward_plain takes them."""
    import torch
    from cut3r_slam_tpu_torch.ops import gs_raster_cuda as G
    from cut3r_slam_tpu_torch.ops.gs_raster import ALPHA_MIN, T_MIN
    R = A.shape[0]
    dev = A.device
    x, y = G._pixel_xy(dev)
    T = torch.ones(R, G.PX, device=dev)
    done = torch.zeros(R, G.PX, dtype=torch.bool, device=dev)
    counts = torch.zeros(3, dtype=torch.long, device=dev)
    for base in range(0, int(ext.max()), G.CHUNK):
        Ac = A[:, base:base + G.CHUNK]
        inside = ((base + torch.arange(Ac.shape[1], device=dev))[None, :]
                  < ext[:, None])[..., None]
        q = [Ac[..., 7 + k, None] for k in range(6)]
        power = q[0] + q[1] * x + q[2] * y + q[3] * (x * x) \
            + q[4] * (y * y) + q[5] * (x * y)
        alpha_c = torch.clamp(torch.exp(power), max=0.99)
        ok = (alpha_c >= ALPHA_MIN) & inside
        inc0 = torch.cumprod(torch.where(ok, 1.0 - alpha_c,
                                         torch.ones_like(alpha_c)), 1)
        below = T[:, None] * inc0 < T_MIN       # the pixel stops here or before
        before = torch.cat([torch.zeros_like(below[:, :1]), below[:, :-1]], 1)
        visited = inside & ~done[:, None] & ~before
        counts[0] += (visited & ~ok).sum()
        counts[1] += (visited & ok & below).sum()
        counts[2] += (visited & ok & ~below).sum()
        keepb = ~below & ~done[:, None]
        T = T * torch.where(keepb, inc0, torch.ones_like(inc0)).min(1).values
        done = done | below[:, -1]
    return [int(n) for n in counts]


def bound_ms(name, A, ext, tchk, pairs):
    """The least time the card could take for the kernel's work on these
    inputs: the largest of bytes / HBM rate, FP32 FLOPs / FP32 peak and
    MUFU operations / MUFU rate, with ``pairs`` = (rejected, stopping,
    blended) from blend_census. Returns (ms, "bytes" or "operations",
    (bytes ms, FLOP ms, MUFU ms))."""
    R, K, _ = A.shape
    entries = int(ext.long().sum())
    px = R * 256
    if name == "gs_blend_fwd":     # A, extent in; O (8), 3 maps, tchk out
        nbytes = entries * 64 + R * 4 + px * 4 * (8 + 3) + tchk.numel() * 4
    else:                          # A, extent, tchk, tleft, 4 cotangents in
        nbytes = entries * 64 + R * 4 + tchk.numel() * 4 \
            + px * 4 * (1 + 8 + 3) + R * K * 64
    flops = sum(n * f for n, f in zip(pairs, FLOPS_PER_PAIR[name]))
    mufu = sum(n * m for n, m in zip(pairs, MUFU_PER_PAIR[name]))
    parts = (nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3,
             mufu / PEAK_MUFU * 1e3)
    return max(parts), ("bytes" if parts[0] >= max(parts[1:]) else
                        "operations"), parts


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

# iteration counts of the slice runs (phases 6 and 7), cut to fit the time
# limit; widths are not cut
SLICE_MAPPING_CUTS = {
    "arena_capacity": 2 ** 17, "iterations": 20, "pose_refine_iters": 10,
    "window_opt_iters": 10, "new_view_opt_iters": 10, "gba_per_view": 2}


def plausible_random_cut3r(seed):
    """Full-width CUT3R with random weights from a seeded generator. The
    self-pointmap head's last conv is scaled down and biased to (0, 0, 1)
    and the pose head to the identity quaternion, so the random model
    predicts a textured plane in front of a near-static camera (positive
    depths the mapping stage can fit) instead of noise around zero."""
    import torch
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    model = CUT3R(CUT3RConfig(), device="cuda")
    model.init_random(torch.Generator(device="cuda").manual_seed(seed))
    with torch.no_grad():
        last = model.downstream_head.dpt_self.head[4]
        last.weight.mul_(0.05)
        last.bias.copy_(torch.tensor([0.0, 0.0, 1.0, 0.0]))
        fc2 = model.downstream_head.pose_head.mlp.fc2
        fc2.weight.mul_(0.01)
        fc2.bias.copy_(torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]))
    return model.eval()


def small_mapping_agreement():
    """One mapping event on the synthetic plane of tests/test_torch_mapping
    .py, on the card (kernels) and on the CPU (plain blend): the segment
    losses agree to 1e-2 relative (the event is chaotic at float-rounding
    level; the CPU tests hold the plain path to the JAX package)."""
    import torch
    from cut3r_slam_tpu_torch.geometry.pointmap import depth_to_pointmap
    from cut3r_slam_tpu_torch.geometry.lie import se3_exp, se3_matrix
    from cut3r_slam_tpu_torch.slam.mapping import MappingBackend, \
        MappingConfig
    H = W = 32
    K4 = np.array([40.0, 40.0, W / 2, H / 2], np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = (np.stack([(np.sin(xx / 3.0) * 0.5 + 0.5),
                     (np.cos(yy / 4.0) * 0.5 + 0.5),
                     ((xx + yy) % 7) / 7.0], -1) * 255).astype(np.uint8)
    depth = (2.0 + 0.2 * np.sin(xx / 5.0)).astype(np.float32)
    pm = depth_to_pointmap(torch.tensor(depth), torch.tensor(K4)).numpy()
    d2 = se3_matrix(se3_exp(torch.tensor(
        [0.01, -0.01, 0.02, 0.01, 0.0, -0.01]))).numpy()
    packet = {"viz_idx": [0, 1], "images": np.stack([img, img]),
              "depths": np.stack([depth, depth]),
              "pointmaps": np.stack([pm[::2, ::2]] * 2),
              "confs": np.ones((2, H // 2, W // 2), np.float32),
              "w2c": np.stack([np.eye(4, dtype=np.float32), d2]),
              "submap_idx": 0}
    cfg = MappingConfig(height=H, width=W, capacity=2048, cam_capacity=8,
                        window_size=3, pose_refine_iters=4, opt_segment=2,
                        window_opt_iters=4, new_view_opt_iters=2,
                        gba_per_view=2, gba_segment=2, max_per_tile=256)
    losses = {}
    for dev in ("cuda", "cpu"):
        be = MappingBackend(cfg, K4, device=dev)
        gen = be.run_steps(dict(packet), 4)
        ys = []
        while True:
            try:
                ys.append(next(gen))
            except StopIteration:
                break
        losses[dev] = [y for y in ys if isinstance(y, float)]
    a, b = np.asarray(losses["cuda"]), np.asarray(losses["cpu"])
    if a.shape != b.shape or not np.allclose(a, b, rtol=1e-2):
        fail(f"small mapping event: cuda {a} vs cpu {b}")
    return float(np.max(np.abs(a - b) / np.abs(b)))


def drift_chain(B, seed, h=24, w=32, scale=0.03):
    """B submaps (B, 6, h, w, 3) of one surface (a plane at z = 2 with a
    sinusoidal relief) under accumulating SE(3) drift (the first
    undrifted), the surface itself and all-ones seam confidences."""
    import torch
    from cut3r_slam_tpu_torch.geometry.lie import se3_exp, se3_matrix
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.linspace(-0.6, 0.6, h), np.linspace(-1, 1, w),
                         indexing="ij")
    z = 2.0 + 0.5 * np.sin(3 * xs) * np.cos(2 * ys)   # relief
    plane = np.stack([xs, ys, z], -1).astype(np.float32)
    acc, pts = np.eye(4, dtype=np.float32), [plane]
    for _ in range(B - 1):
        xi = np.concatenate([rng.normal(size=3) * scale,
                             rng.normal(size=3) * scale * 0.5])
        acc = se3_matrix(se3_exp(torch.tensor(xi, dtype=torch.float32))) \
            .numpy() @ acc
        pts.append(plane @ acc[:3, :3].T + acc[:3, 3])
    sub = np.stack([np.broadcast_to(p, (6, h, w, 3)) for p in pts])
    return sub.astype(np.float32), plane, np.ones((B, h, w), np.float32)


def loop_solvers_card_vs_cpu():
    """Phase 5b: the loop-closure solvers on the card and on the CPU from
    the same seeded inputs. Compared as max |card - cpu| / max |cpu|, each
    below 1e-4: both PGO objectives and their gradients at a seeded
    correction (four drifted submaps, two loops), the points moved by
    ``apply_pgo``, 10 steps of ``pgo_align`` and of ``pgo_align_multi`` on
    two submaps (a chain whose every correction has a gradient well above
    Adam's eps in those steps), and the step of four ``sim3_pgo_solve``
    iterations on a graph with a repeated edge and two zero-weight (0, 0)
    self-loops. The LC-cloud transforms of ``pgo_align_multi`` include a
    component whose gradient sits near Adam's eps (1e-6 input noise moves
    it by 1.5% of a step on the CPU): they are held to a tenth of a step
    (5e-5) instead. Returns name -> measured difference."""
    import torch
    from cut3r_slam_tpu_torch import full_f32
    from cut3r_slam_tpu_torch.geometry.lie import sim3_exp, sim3_inv, \
        sim3_mul
    from cut3r_slam_tpu_torch.slam import backend as BK
    from cut3r_slam_tpu_torch.slam.sim3_pgo import sim3_pgo_solve
    sub4, plane, conf4 = drift_chain(4, seed=0)
    sub2, _, conf2 = drift_chain(2, seed=0, scale=0.05)
    lc_chain, _, _ = drift_chain(5, seed=3, scale=0.05)
    lc = np.stack([lc_chain[1:3, 0], lc_chain[3:5, 0]])   # 2 loops' clouds
    rng = np.random.default_rng(1)
    xi_at = rng.normal(0, 0.02, (3, 6)).astype(np.float32)
    xl_at = rng.normal(0, 0.02, (2, 6)).astype(np.float32)
    xi = rng.normal(size=(6, 7)).astype(np.float32) * 0.3
    xi[:, 6] *= 0.2
    xi[0] = 0.0
    g = sim3_exp(torch.tensor(xi))
    gt = sim3_exp(torch.tensor(xi * 0.9))
    ii = torch.tensor([0, 1, 2, 3, 4, 0, 1, 1, 1, 0, 0, 2])
    jj = torch.tensor([1, 2, 3, 4, 5, 5, 2, 3, 3, 0, 0, 4])
    rel = sim3_mul(sim3_inv(gt[ii]), gt[jj])
    rel[9:11] = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1.0])
    w = torch.tensor([1, 1, 1, 1, 1, 2, .5, .5, .7, 0, 0, 1.0])
    out = {}
    for dev in ("cuda", "cpu"):
        def t(x):
            return torch.as_tensor(x).to(dev)
        r = {}
        with full_f32():
            seam = BK._seam_terms(t(sub4), t(conf4))
            x = t(xi_at).requires_grad_(True)
            loss = BK._align_loss(x, *seam, t(sub4[3, 0]).reshape(-1, 3),
                                  t(plane).reshape(-1, 3))
            r["pgo_align objective"] = loss.detach()
            r["pgo_align gradient"] = torch.autograd.grad(loss, x)[0]
            xs = (t(xi_at).requires_grad_(True),
                  t(xl_at).requires_grad_(True))
            loss = BK._multi_loss(*xs, *seam, t(lc[:, 0]).reshape(2, -1, 3),
                                  t(lc[:, 1]).reshape(2, -1, 3),
                                  t(sub4[2:4, 0]).reshape(2, -1, 3),
                                  t(np.array([2, 3])), t(np.array([0, 0])))
            r["pgo_align_multi objective"] = loss.detach()
            r["pgo_align_multi gradient"] = torch.cat(
                torch.autograd.grad(loss, xs))
        r["apply_pgo points"] = BK.apply_pgo(
            t(sub4), torch.cat([torch.zeros(1, 6, device=dev), t(xi_at)]))[0]
        r["pgo_align"] = BK.pgo_align(t(sub2), t(conf2), t(sub2[1, 0]),
                                      t(plane), iters=10)
        xm, xl = BK.pgo_align_multi(t(sub2), t(conf2), t(lc),
                                    t(sub2[[1, 1], 0]), t(np.array([1, 1])),
                                    t(np.array([0, 0])), iters=10)
        r["pgo_align_multi"], r["pgo_align_multi LC transforms"] = xm, xl
        r["sim3_pgo_solve step"] = sim3_pgo_solve(
            t(g), t(ii), t(jj), t(rel), t(w), iters=4) - t(g)
        out[dev] = r
    diffs = {}
    for k, ref in out["cpu"].items():
        err = float((out["cuda"][k].cpu() - ref).abs().max())
        if k.endswith("LC transforms"):
            diffs[k] = err
            if not err < 5e-5:
                fail(f"{k}: card vs cpu max abs diff {err:.3e} >= 5e-5")
            continue
        diffs[k] = err / float(ref.abs().max())
        if not diffs[k] < 1e-4:
            fail(f"{k}: card vs cpu max rel diff {diffs[k]:.3e} >= 1e-4")
    return diffs


def batched_mapping_card_vs_cpu():
    """Phase 5c (see the module docstring). Returns name -> measured
    difference."""
    import torch
    from cut3r_slam_tpu_torch.slam.mapping import MappingBackend, \
        MappingConfig
    from cut3r_slam_tpu_torch.geometry.pointmap import depth_to_pointmap
    from cut3r_slam_tpu_torch.geometry.lie import se3_exp, se3_matrix
    H = W = 32
    K4 = np.array([40.0, 40.0, W / 2, H / 2], np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = (np.stack([(np.sin(xx / 3.0) * 0.5 + 0.5),
                     (np.cos(yy / 4.0) * 0.5 + 0.5),
                     ((xx + yy) % 7) / 7.0], -1) * 255).astype(np.uint8)
    depth = (2.0 + 0.2 * np.sin(xx / 5.0)).astype(np.float32)
    cfg = MappingConfig(height=H, width=W, capacity=2048, cam_capacity=8,
                        pose_refine_iters=4, opt_segment=2, max_per_tile=256,
                        gba_views_per_iter=4, gba_resample_every=4,
                        gba_segment=8)
    rng = np.random.default_rng(0)
    be = MappingBackend(cfg, K4, device="cpu")
    for i in range(5):
        xi = rng.normal(0, 0.01, 6).astype(np.float32) if i else \
            np.zeros(6, np.float32)
        be.add_keyframe(i, img, depth,
                        se3_matrix(se3_exp(torch.tensor(xi))).numpy())
    pm = depth_to_pointmap(torch.tensor(depth), torch.tensor(K4)).numpy()
    be.seed(0, pm[::2, ::2], img[::2, ::2].astype(np.float32) / 255.0,
            np.ones((H // 2, W // 2), bool), 0)
    with torch.no_grad():   # anisotropic Gaussians: no noise-led rotations
        alive = be.arena.alive
        q = be.arena.quat[alive] + torch.tensor(rng.normal(
            0, 0.2, (int(alive.sum()), 4)), dtype=torch.float32)
        be.arena.quat[alive] = q / q.norm(dim=1, keepdim=True)
        be.arena.log_scales[alive] += torch.tensor(rng.normal(
            0, 0.1, (int(alive.sum()), 3)), dtype=torch.float32)
    state = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_5c_"), "s.npz")
    be.save(state)
    views = [np.stack([rng.permutation(5)[:4] for _ in range(2)])
             for _ in range(2)]
    noise = rng.normal(size=(2048, 3)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        be = MappingBackend(cfg, K4, device=dev)
        be.load(state)
        pms, _ = be.pose_refine_multi([1, 2, 3])
        r = {"pose_refine_multi poses": be.cams.w2c[1:4].cpu(),
             "pose_refine_multi scaled-depth pointmaps": pms.cpu()}
        be.load(state)
        be.global_ba(64, densify=True, view_idx=views, split_noise=noise)
        r["global BA per-step losses"] = torch.cat(be.gba_losses).cpu()
        r["global BA poses"] = be.cams.w2c.cpu()
        out[dev] = r
    if out["cpu"]["global BA per-step losses"].numel() != 16:
        fail("phase 5c: the global BA did not run 2 segments of 2 blocks "
             "of 4 steps")
    tol = {"pose_refine_multi poses": ("rel", 1e-4),
           "pose_refine_multi scaled-depth pointmaps": ("rel", 1e-4),
           "global BA per-step losses": ("elem", 1e-2),
           "global BA poses": ("abs", 2e-2)}
    diffs = {}
    for k, (kind, bound) in tol.items():
        a, b = out["cuda"][k], out["cpu"][k]
        err = (a - b).abs()
        d = float(err.max()) if kind == "abs" else \
            float(err.max() / b.abs().max()) if kind == "rel" else \
            float((err / b.abs()).max())
        diffs[k] = d
        if not d < bound:
            fail(f"phase 5c: {k}, card vs cpu {d:.3e} >= {bound}")
    return diffs


# ---------------------------------------------------------------------------
# phase 7: the loop-closure path
# ---------------------------------------------------------------------------

LC_H, LC_W, LC_F, LC_FRAMES, LC_STEP = 384, 512, 400.0, 40, 0.25


def gt_plane_frames(n=LC_FRAMES, step=LC_STEP, seed=3):
    """Ground truth of an out-and-back trajectory over a textured plane at
    z = 2 (the scene of tests/test_e2e_gt_loop.py at 384x512, f = 400):
    the camera slides along x by ``step`` per frame for n/2 frames and
    back. Returns [(image u8, depth, c2w)] and K4. At 0.25 m per frame
    the view shifts by 0.39 of its width per metre, so keyframes more than
    8 apart never overlap by the factor graph's 0.3 on the way out and the
    loop closes on the way back, after two submaps have been mapped."""
    H, W, f = LC_H, LC_W, LC_F
    rng = np.random.default_rng(seed)
    tex = rng.uniform(40, 215, (256, 512, 3)).astype(np.float32)
    for _ in range(3):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
               + np.roll(tex, 1, 1) + np.roll(tex, -1, 1)) / 5.0
    half = n // 2
    txs = [step * t for t in range(half)]
    txs += [txs[-1] - step * (t + 1) for t in range(n - half)]
    K4 = np.asarray([f, f, W / 2, H / 2], np.float32)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    out = []
    for tx in txs:
        x = (u - K4[2]) / f * 2.0 + tx
        y = (v - K4[3]) / f * 2.0
        ti = ((x + 2.0) * 50).astype(int) % 512      # 50 texels per metre
        tj = ((y + 2.0) * 50).astype(int) % 256
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = tx
        out.append((tex[tj, ti].astype(np.uint8),
                    np.full((H, W), 2.0, np.float32), c2w))
    return out, K4


def kf_ate(kf, gt_c2w):
    """Keyframe translation RMSE after removing the mean offset (the gauge
    alignment of tests/test_e2e_gt_loop.py)."""
    err = np.stack([kf.pose[i, :3] - gt_c2w[int(kf.tstamp[i])][:3, 3]
                    for i in range(kf.count)])
    err -= err.mean(0)
    return float(np.sqrt((err ** 2).sum(1).mean()))


def _wrap(obj, name, around):
    """Replace ``obj.name`` by around(original, *args) for this run."""
    orig = getattr(obj, name)
    setattr(obj, name, lambda *a, **k: around(orig, *a, **k))


def synced(fn, *a, **k):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **k)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def loop_closure_phase(model, G, card):
    """Phase 7 (see the module docstring). Returns the launch counts of
    its run."""
    import torch
    from cut3r_slam_tpu_torch.slam import backend as BK
    from cut3r_slam_tpu_torch.slam.keyframe import SUBMAP_SIZE
    from cut3r_slam_tpu_torch.slam.mapping import MappingBackend
    from cut3r_slam_tpu_torch.slam.sim3_pgo import PGBABuffer
    from cut3r_slam_tpu_torch.slam.system import SLAMSystem
    from cut3r_slam_tpu_torch.utils.config import DEFAULT_CONFIG
    frames, K4 = gt_plane_frames()
    gt = {t: c2w for t, (_, _, c2w) in enumerate(frames)}
    cfg = json.loads(json.dumps(DEFAULT_CONFIG))
    cfg["Tracking"]["motion_filter"]["kf_every"] = 2
    cfg["Tracking"]["backend"]["loop_iters"] = 2000
    cfg["Tracking"]["pgba"] = {"active": True}
    cfg["Mapping"].update(SLICE_MAPPING_CUTS)
    cfg["keep_all_frames"] = False
    slam = SLAMSystem(model, cfg, buffer=64, img_hw=(LC_H, LC_W),
                      output_dir=os.path.join(ROOT, "build", "chip_smoke_lc"),
                      device="cuda")
    kf = slam.keyframes
    rec = {"lc_track": [], "pgo_align": [], "pgo_align_multi": [],
           "closure": [], "gaussian_update": [], "pgba": []}

    def seam(B):
        p = kf.submap_pts[:B]
        return float((p[:B - 1, -1] - p[1:B, 0]).abs().mean())

    def timed(key):
        def around(orig, *a, **k):
            out, sec = synced(orig, *a, **k)
            rec[key].append(sec)
            return out
        return around

    def closure(orig, matched, current):
        b, sl = divmod(current, SUBMAP_SIZE)
        cur0 = kf.submap_pts[b, sl].clone()
        seam0, ate0 = seam(b + 1), kf_ate(kf, gt)
        out, sec = synced(orig, matched, current)
        lc = slam.backend.closed_loop["lc_fl"][-1][1]
        rec["closure"].append({
            "matched": matched, "current": current, "s": sec,
            "seam": (seam0, seam(b + 1)),
            "loop": (float((cur0 - lc).abs().mean()),
                     float((kf.submap_pts[b, sl] - lc).abs().mean())),
            "ate": (ate0, kf_ate(kf, gt))})
        return out

    def gaussian_update(orig, mapper, submap_ids, pose_updates, *a):
        ar = mapper.arena
        ids = torch.as_tensor(np.asarray(submap_ids)[1:], device=ar.xyz.device)
        rows = ar.alive & (ar.kf_id[:, None] == ids[None]).any(-1)
        xyz0 = ar.xyz[rows].clone()
        l0 = dict(G.LAUNCHES)
        _, sec = synced(orig, mapper, submap_ids, pose_updates, *a)
        rec["gaussian_update"].append({
            "s": sec, "moved": int(rows.sum()),
            "max_move": float((ar.xyz[rows] - xyz0).abs().max())
            if int(rows.sum()) else 0.0,
            "launches": {k: G.LAUNCHES[k] - l0[k] for k in l0}})

    _wrap(slam.backend, "lc_track", timed("lc_track"))
    _wrap(slam.backend, "loop_closure", closure)
    saved = [(BK, "pgo_align"), (BK, "pgo_align_multi"),
             (MappingBackend, "gaussian_update"),
             (PGBABuffer, "solve_and_writeback")]
    saved = [(o, n, getattr(o, n)) for o, n in saved]
    _wrap(BK, "pgo_align", timed("pgo_align"))
    _wrap(BK, "pgo_align_multi", timed("pgo_align_multi"))
    orig_gu, orig_pgba = saved[2][2], saved[3][2]
    MappingBackend.gaussian_update = \
        lambda self, *a: gaussian_update(orig_gu, self, *a)
    PGBABuffer.solve_and_writeback = lambda self, k: rec["pgba"].append(
        synced(orig_pgba, self, k)) or rec["pgba"][-1][0]
    try:
        for k in G.LAUNCHES:
            G.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for t, (img, depth, c2w) in enumerate(frames):
            slam.run_test(t, img, K4, depth, c2w, img_map=img, K4_map=K4,
                          second_last=(t == len(frames) - 2),
                          last=(t == len(frames) - 1), sigma_t=0.02,
                          sigma_r=0.004)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(G.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        if not rec["closure"]:
            fail("phase 7: no loop closure fired")
        # a repeat closure at full width: the multi-loop PGO
        last = rec["closure"][-1]
        slam.backend.loop_closure(last["matched"], slam.frontend.t1 - 2)
    finally:
        for o, n, f in saved:
            setattr(o, n, f)

    for c in rec["closure"]:
        s0, s1 = c["seam"]
        l0, l1 = c["loop"]
        log(f"[loop] closure {c['matched']} <- {c['current']}: seam error "
            f"{s0:.5f} -> {s1:.5f}, loop error {l0:.5f} -> {l1:.5f}, "
            f"keyframe ATE {c['ate'][0]:.5f} -> {c['ate'][1]:.5f} m, "
            f"{c['s']:.2f} s | {card}")
    for c in rec["closure"][:-1]:        # closures of the run_test drive
        (s0, s1), (l0, l1) = c["seam"], c["loop"]
        if not (s1 < s0 and l1 < l0):
            fail(f"phase 7: the seam or the loop error did not fall across "
                 f"the closure: seam {s0} -> {s1}, loop {l0} -> {l1}")
    if not rec["pgo_align_multi"]:
        fail("phase 7: the repeat closure did not run pgo_align_multi")
    if not rec["gaussian_update"]:
        fail("phase 7: gaussian_update never ran")
    for gu in rec["gaussian_update"]:
        if gu["moved"] <= 0 or not gu["max_move"] > 0:
            fail(f"phase 7: no Gaussian of a corrected submap moved: {gu}")
        if min(gu["launches"].values()) <= 0:
            fail(f"phase 7: a kernel did not launch inside gaussian_update: "
                 f"{gu['launches']}")
    if not rec["pgba"]:
        fail("phase 7: the PGBA never solved")
    for g, _ in rec["pgba"]:
        if not (np.isfinite(g).all() and (g[:, 7] > 0).all()):
            fail("phase 7: non-finite PGBA poses or scales")
    m = slam.mapper
    live = m.arena.alive
    if not (np.isfinite(kf.pose[:kf.count]).all()
            and np.isfinite(kf.depth[:kf.count]).all()
            and torch.isfinite(kf.submap_pts).all()
            and torch.isfinite(m.cams.w2c).all()
            and all(torch.isfinite(getattr(m.arena, k)[live]).all()
                    for k in ("xyz", "f_dc", "opacity_logit", "log_scales",
                              "quat"))):
        fail("phase 7: non-finite poses, depths, pointmaps or Gaussians")
    if min(launches.values()) <= 0:
        fail(f"phase 7: a kernel was never launched: {launches}")
    gu = rec["gaussian_update"]
    log(f"[loop] {len(frames)} frames, {kf.count} keyframes, "
        f"{len(rec['closure']) - 1} closure(s) in run_test + 1 direct; "
        f"final keyframe ATE {kf_ate(kf, gt):.5f} m; "
        f"{LC_FRAMES / run_s:.3f} frames/s over run_test ({run_s:.1f} s), "
        f"peak memory {peak_gb:.2f} GiB | {card}")
    log(f"[loop] seconds: lc_track {rec['lc_track']}, pgo_align "
        f"{rec['pgo_align']}, pgo_align_multi {rec['pgo_align_multi']}, "
        f"gaussian_update {[g['s'] for g in gu]}, PGBA solve "
        f"{[s for _, s in rec['pgba']]} | {card}")
    log(f"[loop] gaussian_update: {[g['moved'] for g in gu]} Gaussians "
        f"moved (max {[round(g['max_move'], 5) for g in gu]} m), launches "
        f"inside {[g['launches'] for g in gu]}; PGBA scales "
        f"{[(float(g[:, 7].min()), float(g[:, 7].max())) for g, _ in rec['pgba']]}")
    log(f"[loop] main-path launches: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 8: the demo driver at the production mapping schedule
# ---------------------------------------------------------------------------

# bench.py's TPU mapping schedule (its lines 230-234)
PRODUCTION_SCHEDULE = {"parallel_kf_refine": True, "gba_views_per_iter": 4,
                       "gba_resample_every": 4, "interleave": 3,
                       "opt_early_stop": 0.01}


def demo_phase(model, frames, K4, G, card):
    """Phase 8 (see the module docstring). Returns (launches of the run,
    largest frame seconds)."""
    import cv2
    import torch
    import yaml
    from cut3r_slam_tpu_torch import demo
    from cut3r_slam_tpu_torch.slam.mapping import MappingBackend
    from cut3r_slam_tpu_torch.slam.system import SLAMSystem
    from cut3r_slam_tpu_torch.utils.profiling import StageTimer
    root = tempfile.mkdtemp(prefix="chip_smoke_demo_",
                            dir=os.path.join(ROOT, "build"))
    os.makedirs(os.path.join(root, "img"))
    for t, img in enumerate(frames):
        cv2.imwrite(os.path.join(root, "img", f"frame{t:04d}.png"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(" ".join(str(float(x)) for x in K4) + "\n")
    mapping = {k: v for k, v in SLICE_MAPPING_CUTS.items()
               if k != "arena_capacity"}
    mapping.update(PRODUCTION_SCHEDULE)
    with open(os.path.join(root, "config.yaml"), "w") as f:
        yaml.safe_dump({"Mapping": mapping}, f)
    out = os.path.join(root, "out")
    rec = {"frames": [], "refine": [], "gba": []}

    # the driver's own model construction, once: a missing --ckpt takes
    # the random init from seed 0, which is phase 6's model before
    # plausible_random_cut3r rescales its two head layers
    t0 = time.perf_counter()
    built = demo.build_model(demo.parse_args([
        "--imagedir", root, "--calib", root, "--ckpt",
        os.path.join(root, "absent.pth")]), "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ref, got = model.state_dict(), built.state_dict()
    rescaled = ("downstream_head.dpt_self.head.4.",
                "downstream_head.pose_head.mlp.fc2.")
    if set(got) != set(ref) or built.device.type != "cuda":
        fail("phase 8: build_model's CUT3R differs from phase 6's in its "
             "parameters or device")
    for k, v in got.items():
        if v.shape != ref[k].shape or v.dtype != ref[k].dtype \
                or not torch.isfinite(v).all() or not (
                    k.startswith(rescaled) or torch.equal(v, ref[k])):
            fail(f"phase 8: build_model's {k} differs from phase 6's model")
    del built, got
    torch.cuda.empty_cache()
    log(f"[demo] build_model (random init, seed 0) in {build_s:.1f} s: "
        f"the same tensors as phase 6's model but for its rescaled head "
        f"layers | {card}")

    # the stage timer, attached here: demo.main (as demo.py) times only
    # whole frames and terminate
    stages = StageTimer()

    def frame(orig, slam, t, *a, **k):
        slam.timer = stages
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig(slam, t, *a, **k)
        torch.cuda.synchronize()
        rec["frames"].append((t, r[1] is not None, slam.frame_map_slices,
                              time.perf_counter() - t0))
        return r

    def launches_in(key, keep=lambda *a: True):
        def around(orig, *a):
            l0 = dict(G.LAUNCHES)
            r = orig(*a)
            if keep(*a):
                rec[key].append({n: G.LAUNCHES[n] - l0[n] for n in l0})
            return r
        return around

    saved = [(SLAMSystem, "run"), (MappingBackend, "pose_refine_multi"),
             (MappingBackend, "_gba_segment"), (demo, "build_model")]
    saved = [(o, n, getattr(o, n)) for o, n in saved]
    wraps = {"run": frame,
             "pose_refine_multi": launches_in(
                 "refine", lambda self, idxs: len(idxs) > 1),
             "_gba_segment": launches_in(
                 "gba", lambda self, ab, adb, vi: vi.shape[1] > 1)}
    for o, n, f in saved[:3]:
        setattr(o, n, (lambda f, w: lambda *a, **k: w(f, *a, **k))(
            f, wraps[n]))
    demo.build_model = lambda args, device: model
    try:
        for k in G.LAUNCHES:
            G.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        slam, result = demo.main([
            "--imagedir", os.path.join(root, "img"), "--calib",
            os.path.join(root, "calib.txt"), "--config",
            os.path.join(root, "config.yaml"), "--output", out,
            "--buffer", "64", "--kf_every", "2", "--arena_capacity",
            str(2 ** 17), "--finalize_iters", "50"])
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(G.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        for o, n, f in saved:
            setattr(o, n, f)

    kf, m = slam.keyframes, slam.mapper
    valid = int(m.cams.valid.sum())
    for f in ("image_shape.txt", "timing.json", "traj_kf.txt",
              "intrinsics.npy", "result.json", "gaussians.npz",
              "3dgs_final.ply", "psnr/final/final_result_kf.json"):
        if not os.path.exists(os.path.join(out, f)):
            fail(f"phase 8: {f} was not written")
    with open(os.path.join(out, "psnr", "final", "final_result_kf.json")) as f:
        ev = json.load(f)
    if ev["n_views"] != valid or not np.isfinite(ev["mean_psnr"]):
        fail(f"phase 8: keyframe eval over {ev['n_views']} of {valid} "
             f"keyframes, PSNR {ev['mean_psnr']}")
    rk = os.listdir(os.path.join(out, "renders_kf"))
    n_color = sum(f.startswith("color_") for f in rk)
    n_depth = sum(f.startswith("depth_") and f.endswith(".png") for f in rk)
    n_img = len(os.listdir(os.path.join(out, "renders_kf", "image_final")))
    if not n_color == n_depth == n_img == valid:
        fail(f"phase 8: renders_kf holds {n_color} colour / {n_depth} depth /"
             f" {n_img} eval renders for {valid} keyframes")
    busy = [(t, n) for t, ev_, n, _ in rec["frames"] if not ev_ and n > 3]
    if busy:
        fail(f"phase 8: frames without a new submap ran > 3 slices: {busy}")
    if not rec["refine"] or not rec["gba"]:
        fail(f"phase 8: the batched refine ran {len(rec['refine'])} times, "
             f"the batched global BA {len(rec['gba'])} segments")
    for key in ("refine", "gba"):
        if min(min(r.values()) for r in rec[key]) <= 0:
            fail(f"phase 8: a kernel did not launch inside a batched {key}: "
                 f"{rec[key]}")
    live = m.arena.alive
    if not (np.isfinite(kf.pose[:kf.count]).all()
            and np.isfinite(kf.depth[:kf.count]).all()
            and torch.isfinite(m.cams.w2c).all()
            and all(torch.isfinite(getattr(m.arena, k)[live]).all()
                    for k in ("xyz", "f_dc", "opacity_logit", "log_scales",
                              "quat"))):
        fail("phase 8: non-finite poses, depths or Gaussians")
    if min(launches.values()) <= 0:
        fail(f"phase 8: a kernel was never launched: {launches}")
    with open(os.path.join(out, "timing.json")) as f:
        timing = json.load(f)
    ft = [s for _, _, _, s in rec["frames"]]
    n = len(ft)
    run_s = sum(ft)
    log(f"[demo] {n} frames, {kf.count} keyframes, {valid} mapped, "
        f"{int(live.sum())} alive Gaussians; keyframe PSNR "
        f"{ev['mean_psnr']:.3f} dB (random weights); {n / run_s:.3f} "
        f"frames/s over run() ({run_s:.1f} s), {n / total_s:.3f} frames/s "
        f"with terminate ({total_s:.1f} s), largest frame {max(ft):.2f} s, "
        f"peak memory {peak_gb:.2f} GiB | {card}")
    log(f"[demo] mapping slices per frame {[x[2] for x in rec['frames']]}; "
        f"frame seconds {[round(x, 2) for x in ft]}")
    log(f"[demo] timing.json mean ms: " + ", ".join(
        f"{k} {v['mean_ms']} (x{v['calls']})" for k, v in timing.items()))
    log(f"[demo] stage mean ms (the timer attached by this phase): " + ", ".join(
        f"{k} {v['mean_ms']} (x{v['calls']})"
        for k, v in stages.summary().items()))
    log(f"[demo] launches: {launches}; inside the batched refines "
        f"{rec['refine']}; inside the batched global-BA segments "
        f"{[r for r in rec['gba']]}")
    return launches, max(ft)


# ---------------------------------------------------------------------------
# phase 9: CUT3R training
# ---------------------------------------------------------------------------

TRAIN_HW = (384, 512)
# procedural scenes of 18 views; the sampler's span of 16 never reaches
# past a scene, so no view repeats (views that share one pose leave the
# translation loss dividing rounding by rounding)
TRAIN_SCENE_VIEWS, TRAIN_SPAN = 18, 16


def training_scenes(root, hw, n_scenes, seed):
    from cut3r_slam_tpu_torch.datasets import generate_multiview_scenes
    return generate_multiview_scenes(root, n_scenes=n_scenes,
                                     views_per_scene=TRAIN_SCENE_VIEWS,
                                     hw=hw, seed=seed)


def training_batches(dirs, hw, num_views, seed):
    """make_batch_iter over the scenes ``dirs``: one ``MultiViewDataset``
    per scene, joined with ``+``."""
    from cut3r_slam_tpu_torch.datasets import (
        MultiViewDataset, SceneFolderSource, SceneLayout, make_batch_iter)
    parts = [MultiViewDataset(
        SceneFolderSource(os.path.dirname(d), SceneLayout("synth"),
                          scenes=[os.path.basename(d)]),
        num_views=num_views, span=TRAIN_SPAN, resolution=hw, seed=seed + i)
        for i, d in enumerate(dirs)]
    ds = parts[0]
    for part in parts[1:]:
        ds = ds + part
    return make_batch_iter(ds, batch_size=1, seed=seed)


def params_agree(ref, got, lrs):
    """Every parameter element within 1e-5 absolute of ``ref`` but for at
    most 1e-4 of the model's elements, and those within two full Adam
    steps (2 * the summed learning rates): Adam divides each gradient
    element by its own magnitude, so an element whose gradient lies at
    the f32 rounding floor takes a step of either sign. Returns (max
    |diff|, elements beyond 1e-5, elements) or fails."""
    diff = [(got[k].detach().cpu() - v).abs() for k, v in ref.items()]
    far = sum(int((d > 1e-5).sum()) for d in diff)
    n = sum(d.numel() for d in diff)
    worst = max(float(d.max()) for d in diff)
    if far > 1e-4 * n or worst > 2 * sum(lrs) + 1e-6:
        fail(f"phase 9: card vs cpu parameters: {far} of {n} elements "
             f"beyond 1e-5, max {worst:.3e}")
    return worst, far, n


def grads_agree(ref, got, what):
    """Adam's first moments (name -> tensor; means of clipped gradients
    taken at the same params on both sides): the norm of each tensor's
    difference within 1e-4 of its norm in ``ref`` plus 1e-6 x the largest
    tensor's. Below that floor a gradient is zero up to rounding (a key
    bias, to which the softmax is invariant; the encoder under TBPTT),
    and a tensor whose reference lies there must lie there in ``got``
    too; just above it the card's atomics move a small bias's rounding
    from run to run. Returns the worst difference over (the tensor's
    norm + the floor) or fails."""
    rtol, floor = 1e-4, 1e-6
    top = max(float(v.norm()) for v in ref.values())
    worst = 0.0
    for k, r in ref.items():
        rn, g = float(r.norm()), got[k]
        if rn <= floor * top:
            if float(g.norm()) > floor * top:
                fail(f"phase 9: {what}: {k} has a gradient on one side "
                     f"only ({rn:.3e} vs {float(g.norm()):.3e})")
            continue
        rel = float((g - r).norm()) / (rn + floor * top)
        if not rel <= rtol:
            fail(f"phase 9: {what}: gradient of {k} differs by {rel:.3e} "
                 f"of its norm + the floor")
        worst = max(worst, rel)
    return worst


def training_card_vs_cpu(root):
    """The tiny model's train steps on the card (f32, no TF32) and on the
    CPU from the same weights and batches: three make_train_step steps
    and one truncated-BPTT step. Losses within 1e-5 relative; the
    gradient of every parameter tensor as ``grads_agree`` after each step
    taken at the starting weights (the first two make_train_step steps:
    the first update is zero by the schedule; the TBPTT step);
    parameters as ``params_agree``. Then three steps of ``train`` on the
    card from the same weights give the make_train_step losses (1e-5
    relative)."""
    import torch
    from cut3r_slam_tpu_torch import full_f32
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu_torch.train.train_step import (
        lr_at, make_optimizer, make_tbptt_train_step, make_train_step)
    from cut3r_slam_tpu_torch.train.trainer import TrainerConfig, train
    hw = (32, 48)
    dirs = training_scenes(os.path.join(root, "tiny"), hw, 1, seed=0)
    it2 = training_batches(dirs, hw, 2, seed=0)
    batches = [next(it2) for _ in range(3)]
    b4 = next(training_batches(dirs, hw, 4, seed=1))
    init = CUT3R(CUT3RConfig.tiny(), device="cpu")
    init.init_random(torch.Generator().manual_seed(1))
    init = {k: v.clone() for k, v in init.state_dict().items()}
    kw = dict(lr=1e-4, weight_decay=0.05, warmup_steps=2, total_steps=10)
    out = {}
    with full_f32():
        for dev in ("cpu", "cuda"):
            m = CUT3R(CUT3RConfig.tiny(), device=dev)
            m.load_state_dict(init)

            def mu(opt):
                return {n: opt.state[p]["mu"].cpu().clone()
                        for n, p in m.named_parameters()}

            opt = make_optimizer(m.parameters(), **kw)
            step = make_train_step(m, opt)
            losses, mus = [], []
            for b in batches:
                losses.append(float(step(b)["total"]))
                mus.append(mu(opt))
            m3 = {k: v.detach().cpu().clone()
                  for k, v in m.state_dict().items()}
            m.load_state_dict(init)
            opt = make_optimizer(m.parameters(), **dict(kw, warmup_steps=0))
            tb = make_tbptt_train_step(m, opt, chunk=2, grad_chunks=1)
            out[dev] = (losses, m3, float(tb(b4)["total"]),
                        {k: v.detach().cpu().clone()
                         for k, v in m.state_dict().items()},
                        mus[:2] + [mu(opt)])
        logs = []
        m = CUT3R(CUT3RConfig.tiny(), device="cuda")
        train(m, iter(batches), TrainerConfig(
            lr=kw["lr"], weight_decay=kw["weight_decay"], warmup_steps=2,
            total_steps=3, log_every=1, ckpt_dir=os.path.join(root, "ckpt")),
            init_params=init, log_fn=logs.append, device="cuda")
    (lc, pc, tc, qc, mc), (lg, pg, tg, qg, mg) = out["cpu"], out["cuda"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lg + [tg], lc + [tc]))
    if not rel <= 1e-5:
        fail(f"phase 9: tiny losses, card {lg + [tg]} vs cpu {lc + [tc]}")
    grads = [grads_agree(a, b, what) for a, b, what in zip(
        mc, mg, ("step 1", "step 2", "TBPTT step"))]
    worst3 = params_agree(pc, pg, [lr_at(i, kw["lr"], 2, 10)
                                   for i in range(3)])
    worst_t = params_agree(qc, qg, [kw["lr"]])
    trained = [m_["loss"] for m_ in logs if "loss" in m_]
    rel_train = max(abs(a - b) / abs(b) for a, b in zip(trained, lg))
    # the trainer logs losses rounded to 5 decimals
    if len(trained) != 3 or not all(abs(a - b) <= 1e-5 * abs(b) + 5e-6
                                    for a, b in zip(trained, lg)):
        fail(f"phase 9: train() on the card logged {trained}, "
             f"make_train_step {lg}")
    return {"tiny losses card vs cpu, max rel": rel,
            "tiny gradients (Adam first moments) of steps 1, 2 and TBPTT, "
            "worst tensor's diff / (norm + floor)": grads,
            "tiny params after 3 steps, max abs / beyond 1e-5": worst3,
            "tiny params after TBPTT, max abs / beyond 1e-5": worst_t,
            "train() vs make_train_step on the card, max rel": rel_train}


def training_phase(G, card):
    """Phase 9 (see the module docstring). Returns the kernels' launches
    in the phase (both must be 0)."""
    import torch
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu_torch.train.train_step import (
        init_train_state, init_trainable, make_optimizer,
        make_tbptt_train_step, make_train_step)
    from cut3r_slam_tpu_torch.train.trainer import TrainerConfig
    for k in G.LAUNCHES:
        G.LAUNCHES[k] = 0
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_",
                            dir=os.path.join(ROOT, "build"))
    t0 = time.perf_counter()
    for k, v in training_card_vs_cpu(root).items():
        log(f"[train] {k}: {v}")
    log(f"[train] tiny card vs cpu in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    dirs = training_scenes(os.path.join(root, "full"), TRAIN_HW, 2, seed=0)
    fixed = next(training_batches(dirs, TRAIN_HW, 4, seed=0))
    it16 = training_batches(dirs, TRAIN_HW, 16, seed=1)
    b16 = [next(it16) for _ in range(3)]
    log(f"[train] data: {len(dirs)} procedural scenes of "
        f"{TRAIN_SCENE_VIEWS} views at {TRAIN_HW[0]}x{TRAIN_HW[1]} in "
        f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # step A: make_train_step on one fixed V=4 batch, repeated, from the
    # package's training init (train()'s own when it is given no weights)
    tc = TrainerConfig(warmup_steps=2, total_steps=10)
    model = CUT3R(CUT3RConfig(), device="cuda")
    opt = init_train_state(
        model, torch.Generator(device="cuda").manual_seed(tc.seed),
        lr=tc.lr, weight_decay=tc.weight_decay,
        warmup_steps=tc.warmup_steps, total_steps=tc.total_steps)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"[train] CUT3R {n_params / 1e6:.1f} M params (all four heads, "
        f"init_train_state from seed {tc.seed}) in "
        f"{time.perf_counter() - t0:.1f} s")
    step = make_train_step(model, opt)
    V = fixed["imgs"].shape[0]
    losses, secs = [], []
    for _ in range(tc.total_steps):
        t1 = time.perf_counter()
        aux = step(fixed)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        losses.append(float(aux["total"]))
    peak_a = torch.cuda.max_memory_allocated() / 2 ** 30
    if not np.isfinite(losses).all():
        fail(f"phase 9: non-finite step A losses {losses}")
    if not losses[9] < losses[1]:
        fail(f"phase 9: the fitted batch's loss did not fall from step 2 "
             f"to step 10: {losses}")
    sa = float(np.mean(secs[1:]))
    log(f"[train] step A (make_train_step, V={V}, B=1, "
        f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, one batch repeated): losses "
        f"{[round(x, 5) for x in losses]}")
    log(f"[train] step A: {sa:.3f} s per step after the first "
        f"({secs[0]:.2f} s), {V / sa:.2f} views/s, peak "
        f"{peak_a:.2f} GiB (with {base_gb:.2f} GiB held before the phase) "
        f"| {card}")

    # step B: truncated BPTT over V=16, chunks of 4, the last with
    # gradient, from the same initial weights and schedule as step A;
    # weight decay 0, so the encoder must stay bitwise unchanged
    del opt, step
    torch.cuda.empty_cache()
    init_trainable(model,
                   torch.Generator(device="cuda").manual_seed(tc.seed))
    torch.cuda.reset_peak_memory_stats()
    enc = {k: v.clone() for k, v in model.state_dict().items()
           if k.startswith(("enc_", "patch_embed."))}
    dec = {k: v.clone() for k, v in model.state_dict().items()
           if k.startswith("dec_blocks")}
    opt = make_optimizer(model.parameters(), tc.lr, 0.0, tc.warmup_steps,
                         tc.total_steps)
    step = make_tbptt_train_step(model, opt, chunk=4, grad_chunks=1)
    tl, ts = [], []
    for b in b16:
        t1 = time.perf_counter()
        aux = step(b)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t1)
        tl.append(float(aux["total"]))
    peak_b = torch.cuda.max_memory_allocated() / 2 ** 30
    V16 = b16[0]["imgs"].shape[0]
    if not np.isfinite(tl).all():
        fail(f"phase 9: non-finite TBPTT losses {tl}")
    sd = model.state_dict()
    if not all(torch.equal(sd[k], v) for k, v in enc.items()):
        fail("phase 9: a TBPTT step changed an encoder parameter")
    if all(torch.equal(sd[k], v) for k, v in dec.items()):
        fail("phase 9: TBPTT steps left the decoder unchanged")
    sb = float(np.mean(ts[1:]))
    log(f"[train] step B (make_tbptt_train_step, V={V16}, chunk 4, "
        f"grad_chunks 1): losses {[round(x, 5) for x in tl]}; encoder "
        f"({len(enc)} tensors) bitwise unchanged, decoder moved")
    log(f"[train] step B: {sb:.3f} s per step after the first "
        f"({ts[0]:.2f} s), {V16 / sb:.2f} views/s, peak {peak_b:.2f} GiB "
        f"| {card}")
    launches = dict(G.LAUNCHES)
    if any(launches.values()):
        fail(f"phase 9: a blend kernel launched during training: {launches}")
    log(f"[train] kernel launches in phase 9: {launches}")
    shutil.rmtree(root, ignore_errors=True)
    return launches


def kernel_phases(G, card):
    """Phases 3 and 4: K1 / K2 against their plain versions on the 32x32
    scene, the staging-edge scene and at the mapping shape (V = 1 and 10,
    the median cotangent nonzero), then their times at the mapping shape.
    Returns the V = 1 rows of the kernels line: name -> (ms, plain ms,
    bound, max |err|)."""
    import torch
    from cut3r_slam_tpu_torch.ops.gs_raster import RasterizeConfig
    K4t = torch.tensor([40.0, 40.0, 16.0, 16.0], device="cuda")
    small = RasterizeConfig(height=32, width=32, max_dup=16, max_per_tile=64)
    A, ext = G.packed_entries(*small_scene(), K4t, small)
    e1, fl, (O, d, md, T, tchk), flip = k1_errors(G, A, ext)
    r2, _ = k2_errors(G, A, ext, tchk, T, cotangents(O, d, T), A.shape[0],
                      flip)
    log(f"[parity] 32x32 scene V=3: K1 max err {e1:.3e} (flip frac "
        f"{fl:.1e}), K2 max err / max |ref| per channel "
        f"{float(r2.max()):.3e} (channels 0-6: {float(r2[:7].max()):.3e})")
    A, ext = (torch.tensor(a, device="cuda") for a in staging_scene())
    e1, fl, (O, d, md, T, tchk), flip = k1_errors(G, A, ext)
    r2, _ = k2_errors(G, A, ext, tchk, T, cotangents(O, d, T), A.shape[0],
                      flip)
    log(f"[parity] staging-edge scene K={A.shape[1]} extents "
        f"{ext.tolist()}: K1 max err {e1:.3e} (flip frac {fl:.1e}), K2 max "
        f"err / max |ref| per channel {float(r2.max()):.3e} (channels 0-6: "
        f"{float(r2[:7].max()):.3e})")

    H, W, f = 384, 512, 400.0
    cfg = RasterizeConfig(height=H, width=W, max_per_tile=512)
    K4m = torch.tensor([f, f, W / 2, H / 2], device="cuda")
    rows = {}
    for V in (1, 10):
        A, ext = G.packed_entries(*frustum_scene(2 ** 17, H, W, f, V, V),
                                  K4m, cfg)
        e1, fl, (O, d, md, T, tchk), flip = k1_errors(G, A, ext)
        cots = cotangents(O, d, T)
        r2, e2 = k2_errors(G, A, ext, tchk, T, cots, cfg.n_tiles, flip)
        log(f"[parity] 512x384 P=2^17 V={V}: rows {A.shape[0]} mean extent "
            f"{float(ext.float().mean()):.1f}; K1 max err {e1:.3e} (flip frac"
            f" {fl:.1e}); K2 max err {e2:.3e}, max err / max |ref| per "
            f"channel {float(r2.max()):.3e} (channels 0-6: "
            f"{float(r2[:7].max()):.3e}; {int(flip.sum())} median-flip rows "
            f"left out of channels 13-15)")
        pairs = blend_census(A, ext)
        t_f = cuda_ms(lambda: G.blend_forward(A, ext, True))
        t_b = cuda_ms(lambda: G.blend_backward(A, ext, tchk, T, *cots))
        b_f = bound_ms("gs_blend_fwd", A, ext, tchk, pairs)
        b_b = bound_ms("gs_blend_bwd", A, ext, tchk, pairs)
        parts = " / ".join(
            f"{k} {b[2][0]:.4f}, {b[2][1]:.4f}, {b[2][2]:.4f}"
            for k, b in (("K1", b_f), ("K2", b_b)))
        log(f"[bound] V={V}: (rejected, stopping, blended) pairs {pairs}; "
            f"bytes, FP32, MUFU ms: {parts}")
        if V == 1:
            p_f = cuda_ms(lambda: G.blend_forward_plain(A, ext, True), 3)
            p_b = cuda_ms(lambda: G.blend_backward_plain(A, ext, *cots), 3)
            rows["gs_blend_fwd"] = (t_f, p_f, b_f, e1)
            rows["gs_blend_bwd"] = (t_b, p_b, b_b, e2)
            log(f"[time] V=1: K1 {t_f:.4f} ms (plain {p_f:.3f}, bound "
                f"{b_f[0]:.4f} by {b_f[1]}); K2 {t_b:.4f} ms (plain "
                f"{p_b:.3f}, bound {b_b[0]:.4f} by {b_b[1]}) | {card}")
        else:
            log(f"[time] V=10: K1 {t_f:.4f} ms (bound {b_f[0]:.4f}); K2 "
                f"{t_b:.4f} ms (bound {b_b[0]:.4f}) | {card}")
        del A, ext, O, d, md, T, tchk, cots
    return rows


def main():
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    sys.path.insert(0, ROOT)
    try:
        from cut3r_slam_tpu_torch import full_f32
        from cut3r_slam_tpu_torch.kernels import build
        from cut3r_slam_tpu_torch.ops import gs_raster_cuda as G
        from cut3r_slam_tpu_torch.slam.system import SLAMSystem
        from cut3r_slam_tpu_torch.utils.config import DEFAULT_CONFIG
    except ImportError as e:
        fail(f"the port is not importable from {ROOT}: {e}")
    card = card_line()

    # 1. environment --------------------------------------------------------
    try:
        nvcc = subprocess.run([build.nvcc_path(), "--version"],
                              capture_output=True, text=True, timeout=60
                              ).stdout.strip().splitlines()[-1]
    except RuntimeError as e:
        fail(str(e))
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | nvcc "
        f"{nvcc} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | {card}")

    # 2. build ---------------------------------------------------------------
    secs = build.build_all()
    log(f"[build] {len(build.SOURCES)} kernels in {secs:.2f} s")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # 3.-4. kernel parity and times (f32 throughout, no TF32) -----------------
    with full_f32():
        rows = kernel_phases(G, card)

    # 5. small-input agreement of a mapping event, card vs CPU --------------------
    rel = small_mapping_agreement()
    log(f"[check] 32x32 mapping event, cuda vs cpu: max rel loss diff "
        f"{rel:.2e}")
    # 5b. loop-closure solvers, card vs CPU ---------------------------------------
    for k, d in loop_solvers_card_vs_cpu().items():
        log(f"[check] {k}, cuda vs cpu: max "
            f"{'abs' if k.endswith('transforms') else 'rel'} diff {d:.2e}")
    # 5c. batched mapping paths, card vs CPU ---------------------------------
    for k, d in batched_mapping_card_vs_cpu().items():
        log(f"[check] {k}, cuda vs cpu: max "
            f"{'abs' if k.endswith('poses') and 'BA' in k else 'rel'} diff "
            f"{d:.2e}")

    # 6. the slice ----------------------------------------------------------------
    H, W, f = 384, 512, 400.0
    t0 = time.perf_counter()
    model = plausible_random_cut3r(seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[slice] CUT3R {n_params / 1e6:.1f} M params (random, seed 0) in "
        f"{time.perf_counter() - t0:.1f} s")
    slam_cfg = json.loads(json.dumps(DEFAULT_CONFIG))
    slam_cfg["Tracking"]["motion_filter"]["kf_every"] = 2
    slam_cfg["Mapping"].update(SLICE_MAPPING_CUTS)
    slam_cfg["opt_params"] = {"position_lr_max_steps": 50}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_",
                               dir=os.path.join(ROOT, "build"))
    slam = SLAMSystem(model, slam_cfg, buffer=64, img_hw=(H, W),
                      output_dir=out_dir, device="cuda")
    frames = synth_frames(24, H, W)
    K4 = np.asarray([f, f, W / 2, H / 2], np.float32)
    for k in G.LAUNCHES:
        G.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    event_s, frame_s = [], []
    for t, img in enumerate(frames):
        te = time.perf_counter()
        _, viz = slam.run(t, img, K4, img_map=img, K4_map=K4,
                          last=(t == len(frames) - 1))
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - te)
        if viz is not None:
            event_s.append(frame_s[-1])
    run_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    slam.terminate(len(frames) - 1)
    torch.cuda.synchronize()
    term_s = time.perf_counter() - t1
    launches = dict(G.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    kf = slam.keyframes
    m = slam.mapper
    alive = int(m.arena.alive.sum()) if m is not None else 0
    if len(event_s) < 2:
        fail(f"only {len(event_s)} mapping events ran")
    if min(launches.values()) <= 0:
        fail(f"a kernel was never launched on the main path: {launches}")
    if not np.isfinite(kf.pose[:kf.count]).all() \
            or not np.isfinite(kf.depth[:kf.count]).all():
        fail("non-finite keyframe poses or depths")
    if alive <= 0:
        fail("no alive Gaussians after mapping")
    live = m.arena.alive
    for name in ("xyz", "f_dc", "opacity_logit", "log_scales", "quat"):
        if not torch.isfinite(getattr(m.arena, name)[live]).all():
            fail(f"non-finite Gaussian {name}")
    if not torch.isfinite(m.cams.w2c).all():
        fail("non-finite mapping poses")
    if kf.pose.shape != (64, 7) or kf.depth.shape[1:] != (H, W):
        fail("unexpected keyframe buffer shapes")
    log(f"[slice] {len(frames)} frames, {kf.count} keyframes, "
        f"{len(event_s)} mapping events, {alive} alive Gaussians, "
        f"median depth {float(np.median(kf.depth[:kf.count])):.3f}")
    log(f"[slice] {len(frames) / run_s:.3f} frames/s over run() "
        f"({run_s:.1f} s), {np.mean(event_s):.2f} s per mapping-event frame "
        f"({', '.join(f'{s:.2f}' for s in event_s)}), terminate "
        f"{term_s:.1f} s, peak memory {peak_gb:.2f} GiB | {card}")
    log(f"[slice] main-path launches: {launches}; loop closures fired: "
        f"{len(slam.backend.closed)} (random weights: none is required)")

    # 7. the loop-closure path ------------------------------------------------------
    lc_launches = loop_closure_phase(model, G, card)

    # 8. the demo driver at the production mapping schedule ------------------
    demo_launches, demo_max = demo_phase(model, frames, K4, G, card)
    log(f"[demo] largest frame: {max(frame_s):.2f} s drained (phase 6) vs "
        f"{demo_max:.2f} s interleaved, production schedule (phase 8); not "
        f"a paired comparison | {card}")

    # 9. CUT3R training (the SLAM phases' state released first) -------------
    del slam, model, m, kf, live
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = training_phase(G, card)

    kernels = []
    for name, replaces in (("gs_blend_fwd", ":186 _blend_fwd_kernel"),
                           ("gs_blend_bwd", ":241 _blend_bwd_kernel")):
        t_k, t_p, (b_ms, b_by, _), err = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cut3r_slam_tpu_torch/csrc/{name}.cu",
            "replaces": "cut3r_slam_tpu/ops/gs_raster_pallas.py" + replaces,
            "launches": launches[name],
            "launches_by_path": {"live": launches[name],
                                 "loop_closure": lc_launches[name],
                                 "demo_production_schedule":
                                     demo_launches[name],
                                 "training": train_launches[name]},
            "max_abs_err": err, "ms": t_k,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
