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
   the pack gather's backward (K3) on the inputs of a real gradient
   render at the mapping shape, V=1 and V=10 (``rasterize_cuda_multi``,
   the gradient of ``color.mean() + 0.1 depth.mean()``; 2^16 Gaussians,
   where 2^17 fill every tile, so that about a quarter of the slots stay
   masked out, as in a mapping window): the packed
   cotangent exactly zero on every masked-out entry, and K3's dRaw
   ``torch.equal`` to ``pack_backward_plain`` and to torch's
   ``index_put_`` accumulation over every entry (what the render ran
   before K3);
4. kernel times at the mapping shape (CUDA events), beside the plain
   versions, the bound the card could reach and, for K3, the library
   call that computes the same function (``index_put_``);
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
   events, then terminate; all three kernels' launch counters must rise;
7. the loop-closure path at full width: SLAMSystem.run_test (ground-truth
   depth and poses injected in place of the submap decode, relative
   poses perturbed) on an out-and-back trajectory over a textured plane
   at 384x512 with the full-width CUT3R in the motion filter, mapping on,
   the Sim(3) PGBA on and 2000-step PGOs; then one more closure called
   directly, so the repeat-closure PGO (pgo_align_multi) runs at full
   width. It fails unless a closure fired, the seam error and the loop
   error fell across it (mapping moves the keyframe poses that anchor
   the next submap, so the seams are open before the closure), the corrected
   submaps' Gaussians moved, K1, K2 and K3 launched inside
   gaussian_update,
   and the PGBA scales, poses, depths and Gaussians are finite;
8. the demo driver at the JAX package's production mapping schedule:
   ``cut3r_slam_tpu_torch.demo.main`` over phase 6's 16 frames (cut from
   24 for the time limit) written as 512x384 PNGs, full-width CUT3R (phase
   6's random weights), loop closure on, with parallel keyframe
   refinement, 4-view global-BA steps in 4-step blocks, interleave 3 and
   early stop 0.01 (bench.py's TPU schedule) at phase 6's iteration cuts,
   then terminate with its eval. The driver's own ``build_model`` runs
   once first (no checkpoint: random init from seed 0) and must give phase
   6's tensors but for the two head layers phase 6 rescales; the run then
   uses phase 6's model. The phase attaches a stage timer to the system
   (the driver, as demo.py, times only frames and terminate), so its frame
   times include one synchronization per stage. It fails unless every
   output file exists, the keyframe eval holds a finite PSNR over every
   valid keyframe, renders_kf holds a colour and a depth per keyframe, no
   frame without a new submap ran more than 3 mapping slices, K1, K2 and
   K3 launched inside the batched refine and the batched global BA, and all
   state is finite;
9. CUT3R training at full width (``CUT3RConfig()`` with the self, cross,
   rgb and pose heads, random weights from seed 0, bf16 compute over f32
   master weights, f32 gradients and AdamW state) on procedural scenes
   written at 384x512 (``generate_multiview_scenes`` ->
   ``SceneFolderSource`` -> ``MultiViewDataset`` -> ``make_batch_iter``):
   first the tiny model card vs CPU (f32, no TF32): three
   ``make_train_step`` steps and one truncated-BPTT step from the same
   weights and batches, the card following the CPU run's branch at every
   head ReLU (``heads.ReluBranches``: a pre-activation within rounding of
   zero cannot flip one side's gradient path), losses within 1e-5
   relative, the gradient of
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
   must be finite, and K1, K2 and K3 must not launch;
10. the offline evaluation chain: (a) ``integrate_points`` at 2^17
   Gaussians and 65,536 query points, 384x512, max_per_tile 512, card
   against CPU (visibility equal, every output within 1e-4); (b)
   ``python -m cut3r_slam_tpu_torch.tsdf_integrate`` over phase 8's
   ``renders_kf/`` on the card and on the CPU (the same blocks, SDF and
   weight within 1e-5, the same triangle count); (c) ``demo_gba`` resumed
   from phase 8's ``gaussians.npz`` for 100 global-BA iterations (its
   files written, keyframe PSNR after no more than 0.02 dB below before,
   K1, K2 and K3 launched); (d) ``demo_test`` on a 24-frame ``synth_replica``
   sequence at the native 680x1200, mapped at 512 wide (``result.json``
   with an ATE against the ground truth below half that of the perturbed
   poses it starts from, a finite PSNR, K1, K2 and K3 launched); (e)
   ``run_eval --dataset replica`` over 12 frames of that sequence with the
   full-width CUT3R (phase 6's plausible random weights saved as a
   checkpoint and passed as ``--ckpt``, in the driver's own processes) at
   phase 6's mapping cuts: trajectory,
   ``result.json``, the keyframe eval, ``summary.json`` with a finite ATE
   and a ``mesh.ply`` must be written;
11. the mono prior and the other model families, at their published
   widths with random weights from seeds: (a) ``SLAMSystem.run`` then
   ``terminate`` over phase 6's first 14 frames with full-width CUT3R and
   ``motion_filter.use_prior`` (the default ``PriorNet``: 384 wide, 12
   blocks, 6 heads, depth and normal); a mapping event must run, K1 and
   K2 must launch inside ``run`` (``launches_by_path["mono_prior"]``),
   every keyframe's prior depth must be finite and > 0 and every normal a
   unit vector to 1e-4, and one ``PriorNet`` call must agree card vs CPU
   in f32 within 1e-4 of the map's max; (b) Omnidata DPT-hybrid
   checkpoints written in the public ``omnidata_dpt_{depth,normal}_v2``
   layout, loaded strictly through the system's ``omnidata_ckpt_*`` branch
   and run at 384x512, card vs CPU in f32 within 5e-4 of the map's max;
   (c) CUT3R with the linear head: the tiny model card vs CPU (f32, every
   head, within 1e-4 of each output's max), one full-width forward at
   224x224; (d) full ``CroCoConfig()`` (ViT-B/16 encoder, 512 x 8 decoder,
   224x224, mask 0.9): 6 pretraining steps on ``make_pair_iter`` pairs, 6
   ``train_stereoflow`` steps, ``tiled_predict`` over 352x480 and
   ``evaluate_stereoflow``, every loss finite; (e)
   ``AsymmetricCroCo3DStereo`` at the DUSt3R_ViTLarge_BaseDecoder_512
   widths on one 512x384 pair with either head, full ``Spann3RConfig()``
   over 28 frames at 224x224 (the 5-frame ring and the 4000-token arena
   both evict), and an upstream-layout Spann3R checkpoint loaded
   strictly;
12. the DROID stack, the shared math and the live viewer: (a)
   ``DroidNet`` at its full widths (fnet 128, cnet 256, 128-plane GRU;
   random weights from a seed) on 7 of phase 6's frames at 384x512 (1/8
   grid 48x64), the 22 edges |i - j| <= 2, fixedp 2, 12 GRU steps x 2 BA
   iterations: a forward's CUDA-event time and peak memory, one
   value-and-grad step of mean |residual| at num_steps 2 (finite loss,
   nonzero gradient), the oracle-target ``bundle_adjust`` on the same
   clip (a perturbed pose's error down >= 10x, as
   tests/test_droid_convergence.py), and card vs CPU in f32 at a small
   shape: ``projective_transform`` with its Jacobians and ``corr_lookup``
   (1e-5 + 1e-5 relative), ``bundle_adjust``, ``moba`` and ``jdsa`` (1e-5
   + 1e-4 relative), one ``DroidNet`` forward at num_steps 2 (1e-4 + 1e-4
   relative); K1, K2 and K3 must not launch; (d) the dense BA's step
   (``csrc/droid_ba.cu``) at ``droid_track``'s shapes and a small case,
   kernel path against the plain path: two steps within 1e-4 of the
   plain float32 path's largest entry on the CPU (the card's plain path
   read beside it), at most 3x its distance from the float64 steps; ms a
   call of each path, the host's enqueue time (and the buffers' part of
   the kernel path's), device
   operations a step, each kernel's time beside its bound (bytes at 3.35
   TB/s, FP32 at 67 TFLOP/s); (b) ``tv_loss``, ``sobel_edges``,
   ``gaussian_blur`` (1e-6) and the robust Sim(3) of a 384x512 point-map
   pair (1e-5 on the scale, 1e-4 on R and t) card vs CPU; (c)
   ``SLAMSystem`` with ``GUI: {active: true, port: 0}`` over phase 6's
   first 8 frames, a keyframe each (full-width CUT3R, phase 6's mapping
   cuts): a client
   thread requests /api/state, /api/splats and /api/render while run()
   maps and again after it; every response must be 200, the splat count
   the arena's alive count, the render PNG equal to ``render_view`` of
   the same pose within one 8-bit level, and K1 (not K2 or K3) must
   launch
   inside the render requests (``launches_by_path["viewer"]``);
13. ``parallel/`` over ``torch.distributed``: two ranks spawned on the one
   card over gloo (NCCL refuses two ranks on one card), each loading the
   full-width random CUT3R from a checkpoint the phase saves once; a
   failed rank or check fails the run. (a) from phase 6's mapper state
   (384x512, arena 2^17, window 10): 10 window iterations with pose, one
   global-BA segment of three 4-view steps and ``pose_refine_multi`` over
   5 views, each with its views split over the ranks, against the
   one-rank run on the card at the JAX suite's tolerances (loss rtol 2e-4
   / atol 2e-5, w2c rtol 1e-4 / atol 1e-5, arena rtol 2e-3 / atol 2e-5 on
   all but 1e-4 of each parameter's elements, those within two Adam
   steps, as phase 9 holds parameters), the ranks' arenas bitwise equal;
   K1 / K2 launches and ms an iteration per rank and one-rank are
   printed; (b) ``SLAMSystem.run`` with ``view_parallel: 2`` over phase
   6's first 8 frames, a keyframe each, at the mapping counts of
   tests/test_torch_parallel_slam.py, then ``terminate``: the one-rank
   run's keyframes and mapping events on both ranks, bitwise-equal
   keyframe poses and arenas, poses within VP_POSE_BOUND of the one-rank
   run, K1, K2 and K3 launched inside ``run`` on every rank (rank 0's:
   ``launches_by_path["view_parallel"]``); (c) one ``train`` step of the
   tiny CUT3R (linear head) at dp 2 and at fsdp 2, card against CPU (f32;
   losses, Adam first moments and parameters as phase 9 holds them), then
   one full-width ``make_train_step`` at V=4, 224x224, under fsdp 2 (a
   finite loss; seconds and peak memory printed; both ranks' activations
   share the card); (d) the batch-sharded (B=2 over dp 2) and
   tensor-parallel (tp 2) full-width f32 forwards against the single
   forward, each output's max |err| within 5e-4 of its max (phase 11(b)'s
   bound for a full-width f32 network); (e) NCCL at world size 1: one
   all_reduce of a mapping-gradient buffer through the view-parallel
   reducer;
14. the benchmark driver: ``cut3r_slam_tpu_torch.bench.run_bench`` in its
   card mode (full-width bf16 CUT3R with random weights, 384x512, arena
   2^17, the production mapping schedule at the reference iteration
   counts), the frame count cut to BENCH_FRAMES. Its last line must have
   ``warm_pass``, ``steady_state`` and ``mapping_included`` true, a
   mapping event, every frame run and ``value`` = frames / the timed
   frames' seconds; the timed pass must repeat the warm pass (the same
   keyframe count, new-keyframe ranges and mapping slices frame by frame,
   loop closures, keyframe poses within 1e-6); K1, K2 and K3 must launch
   inside the timed pass (``launches_by_path["bench"]``: the counts are
   zeroed at ``reset_state`` and read when the micro-bench starts); the
   four micro-bench times must be finite and positive; and on the
   micro-bench's 2^17-Gaussian arena the colour must agree with the plain
   blend's as K1 does in phase 3 and, in the gradient of ``color.mean()``
   with cached bins, K2's packed cotangent with the plain VJP's on the
   same inputs channel by channel (below 5e-4 of the channel's max);
15. the cached bin plan: on phase 14's micro-bench arena (2^17 Gaussians,
   384x512) the render and the gradient of ``color.mean() +
   0.1 depth.mean()`` through a ``compute_bin_plan`` (the plan's tile
   order) on the card, against fresh bins and cached bins without a plan
   on the card (maps within 1e-5; gradients within 5e-4 of the
   parameter's max |grad|, the micro-bench's K2 bound; the quaternions',
   zero up to rounding for the isotropic arena, within 5e-4 of the
   largest gradient of any parameter) and against the planned render on
   the CPU (the colour as K1 against the plain blend above; gradients
   within 5e-3 of their max, as K1 / K2 against the plain versions feed
   them); K1, K2 and K3 must launch; the planned and cached-bins gradient
   times are printed. Then the full-width CUT3R loads its state_dict through
   ``cast_params_bf16`` and runs its bf16 forward over two frames:
   finite, the same shapes, within 5e-2 of max |output| of the f32-stored
   weights' forward;
16. the mapping window's gradient renders as CUDA graphs
   (``slam/render_graph.py``) at ``slam_map``'s shapes (384x512, an arena
   of 2^18 slots, ~98k Gaussians seeded from two keyframes, a window of 6
   keyframes): three calls of a 20-iteration window optimization (no
   early stop) each way from the same state, eagerly (``render_graph.run`` calling the body) and
   graphed; the final Gaussians, poses and exposures must be
   ``torch.equal``, the graphed run must capture and replay, and the
   second and third calls (every structure warm) must replay every
   render. Printed: ms an iteration each way (first and third call),
   kernel launches and host waits an iteration (``torch.profiler``'s
   runtime calls over the second call), ms a capture, the memory the
   graphs hold and each way's peak;
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

import contextlib
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


def k3_parity(G, scene, K4, cfg):
    """K3 on the inputs of one gradient render of ``scene``
    (frustum_scene's outputs) through ``rasterize_cuda_multi``: fails
    unless the packed cotangent is exactly zero on every masked-out entry
    and ``pack_backward`` is ``torch.equal`` to ``pack_backward_plain`` and
    to torch's ``index_put_`` accumulation over every entry (the backward
    the render ran before K3). Returns (ms, plain ms, library ms, bound
    (ms, "bytes", (bytes ms,)), max |err|, masked-in entries, rows)."""
    import torch
    means, quats, scales, opac, colors = scene
    seen, k3 = [], G.pack_backward

    def spy(*a):
        seen.append(a)
        return k3(*a)
    G.pack_backward = spy
    try:
        m = means.detach().clone().requires_grad_(True)
        out = G.rasterize_cuda_multi(m, quats, scales, opac, colors, K4, cfg)
        torch.autograd.grad(out["color"].mean() + 0.1 * out["depth"].mean(),
                            m)
    finally:
        G.pack_backward = k3
    if len(seen) != 1:
        fail(f"phase 3: {len(seen)} K3 calls in one gradient render")
    dG, eg, em, n_rows, cap = seen[0]
    if not 0 < int(em.sum()) < em.numel():
        fail(f"phase 3: {int(em.sum())} of {em.numel()} slots masked in: "
             f"the scene does not test K3's masking")
    if bool(dG[~em].any()):
        fail("phase 3: a masked-out entry carries a packed cotangent")
    got = k3(dG, eg, em, n_rows, cap)
    plain = G.pack_backward_plain(dG, eg, em, n_rows)

    def library():
        return torch.zeros_like(got).index_put_((eg,), dG, accumulate=True)
    if not torch.equal(got, plain) or not torch.equal(got, library()):
        fail(f"phase 3: K3 differs from its plain version by "
             f"{float((got - plain).abs().max()):.3e}, from index_put_ by "
             f"{float((got - library()).abs().max()):.3e}")
    err = float((got - plain).abs().max())
    t = cuda_ms(lambda: k3(dG, eg, em, n_rows, cap))
    t_p = cuda_ms(lambda: G.pack_backward_plain(dG, eg, em, n_rows), 3)
    t_l = cuda_ms(library, 3)
    n_in = int(em.sum())
    # the ids and the mask of every entry, the masked-in cotangent rows,
    # every row of dRaw
    b_ms = (eg.numel() * (8 + 1) + n_in * 64 + n_rows * 64) / PEAK_BYTES * 1e3
    return t, t_p, t_l, (b_ms, "bytes", (b_ms,)), err, n_in, n_rows


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

# iteration counts of the slice runs (phases 6 and 7), cut to fit the time
# limit; widths are not cut
SLICE_FRAMES = 16   # phase 6 (cut from 24): 9 keyframes, 2 mapping events
SLICE_MAPPING_CUTS = {
    "arena_capacity": 2 ** 17, "iterations": 20, "pose_refine_iters": 10,
    "window_opt_iters": 10, "new_view_opt_iters": 10, "gba_per_view": 2}


def plausible_random_cut3r(seed, config=None, device="cuda"):
    """CUT3R (full width unless ``config`` says otherwise) with random
    weights from a seeded generator. The self-pointmap head's last conv is
    scaled down and biased to (0, 0, 1) and the pose head to the identity
    quaternion, so the random model predicts a textured plane in front of a
    near-static camera (positive depths the mapping stage can fit) instead
    of noise around zero. tests/test_torch_run_eval.py saves the tiny one
    as the demo's checkpoint."""
    import torch
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    model = CUT3R(config or CUT3RConfig(), device=device)
    model.init_random(torch.Generator(device=device).manual_seed(seed))
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
DEMO_FRAMES = 16    # cut from 24 for the time limit: two mapping events


def demo_phase(model, frames, K4, G, card):
    """Phase 8 (see the module docstring). Returns (launches of the run,
    largest frame seconds, the run's output directory)."""
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
    return launches, max(ft), out


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


def params_agree(ref, got, lrs, what="phase 9"):
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
        fail(f"{what}: card vs cpu parameters: {far} of {n} elements "
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
                fail(f"{what}: {k} has a gradient on one side "
                     f"only ({rn:.3e} vs {float(g.norm()):.3e})")
            continue
        rel = float((g - r).norm()) / (rn + floor * top)
        if not rel <= rtol:
            fail(f"{what}: gradient of {k} differs by {rel:.3e} "
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
    from cut3r_slam_tpu_torch.models.heads import ReluBranches
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

    def steps(dev):
        """Three train steps, then a TBPTT step from the same weights."""
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
        m3 = {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
        m.load_state_dict(init)
        opt = make_optimizer(m.parameters(), **dict(kw, warmup_steps=0))
        tb = make_tbptt_train_step(m, opt, chunk=2, grad_chunks=1)
        return (losses, m3, float(tb(b4)["total"]),
                {k: v.detach().cpu().clone()
                 for k, v in m.state_dict().items()},
                mus[:2] + [mu(opt)])

    # the card follows the CPU run's branch at every head ReLU, so that a
    # pre-activation within rounding of zero cannot flip one side's
    # gradient path: the comparison measures rounding only
    cpu_branches = ReluBranches()
    with full_f32():
        with cpu_branches:
            out["cpu"] = steps("cpu")
        with ReluBranches(cpu_branches.masks) as branches:
            out["cuda"] = steps("cuda")
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
        mc, mg, ("phase 9: step 1", "phase 9: step 2",
                 "phase 9: TBPTT step"))]
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
    return {"head ReLUs replayed on the card from the CPU run, elements "
            "against their own sign / smallest |x| / max|x|":
            (branches.flips, cpu_branches.margin),
            "tiny losses card vs cpu, max rel": rel,
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


# ---------------------------------------------------------------------------
# phase 10: the offline evaluation chain
# ---------------------------------------------------------------------------

OFFLINE_HW = (384, 512)
OFFLINE_POINTS = 65536
OFFLINE_FRAMES = 24
GBA_ITERS = 100     # two 50-step global-BA segments (cut from 200)
GBA_SLACK_DB = 0.02


def synced_s(fn):
    """(result, seconds) of fn() ended by a device synchronization."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def integrate_points_card_vs_cpu(card):
    """(a): integrate_points at 2^17 Gaussians and 65,536 query points,
    384x512, max_per_tile 512, card against CPU."""
    import torch
    from cut3r_slam_tpu_torch.ops.gs_integrate import integrate_points
    from cut3r_slam_tpu_torch.ops.gs_raster import RasterizeConfig
    H, W = OFFLINE_HW
    f = 400.0
    cfg = RasterizeConfig(height=H, width=W, max_per_tile=512)
    means, quats, s, o, c = frustum_scene(2 ** 17, H, W, f, 1, 10)
    g = torch.Generator(device="cuda").manual_seed(11)
    z = torch.rand(OFFLINE_POINTS, generator=g, device="cuda") * 3.5 + 1.0
    xy = (torch.rand(OFFLINE_POINTS, 2, generator=g, device="cuda") - 0.5) \
        * torch.tensor([W / f, H / f], device="cuda") * z[:, None] * 1.05
    pts = torch.cat([xy, z[:, None]], 1)
    K4 = torch.tensor([f, f, W / 2, H / 2], device="cuda")
    args = (pts, means[0], quats[0], s, o, c, K4)
    out, t_card = synced_s(lambda: integrate_points(*args, cfg))
    t0 = time.perf_counter()
    ref = integrate_points(*(a.cpu() for a in args), cfg)
    t_cpu = time.perf_counter() - t0
    if not torch.equal(out["visible"].cpu(), ref["visible"]):
        fail("phase 10: integrate_points visibility differs card vs CPU")
    err = max(float((out[k].cpu() - ref[k]).abs().max())
              for k in ("alpha_integrated", "color_integrated",
                        "point_coordinate", "point_sdf"))
    hit = int((ref["alpha_integrated"] > 0.1).sum())
    if not err <= 1e-4 or hit < OFFLINE_POINTS // 100:
        fail(f"phase 10: integrate_points card vs CPU max |err| {err:.3e} "
             f"(bound 1e-4), {hit} points with alpha > 0.1")
    log(f"[offline] integrate_points 2^17 Gaussians x {OFFLINE_POINTS} "
        f"points, {H}x{W}, max_per_tile 512: card vs CPU max |err| "
        f"{err:.3e}, {hit} points with alpha > 0.1; {t_card * 1e3:.1f} ms on"
        f" the card, {t_cpu * 1e3:.1f} ms on the CPU | {card}")
    return err


def tsdf_card_vs_cpu(rundir, card):
    """(b): ``python -m cut3r_slam_tpu_torch.tsdf_integrate`` over phase
    8's renders_kf on the card, then the same fusion and meshing on the
    card and on the CPU, timed apart: the same blocks, SDF and weight, the
    same triangle count."""
    from cut3r_slam_tpu_torch import tsdf_integrate
    from cut3r_slam_tpu_torch.utils.tsdf import TSDFVolume
    _, t_main = synced_s(lambda: tsdf_integrate.main(["--rundir", rundir]))
    frames, K4 = tsdf_integrate.run_frames(rundir)
    n = len(frames)
    vols, t_fuse, t_mesh, tris = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        vol = TSDFVolume(voxel_size=0.02, trunc=0.08, device=dev)

        def fuse():
            for depth, color, c2w in frames:
                vol.integrate(depth, color, K4, c2w)
        _, t_fuse[dev] = synced_s(fuse)
        (_, faces, _), t_mesh[dev] = synced_s(vol.extract_mesh)
        vols[dev], tris[dev] = vol, len(faces) if faces is not None else 0
    a, b = vols["cuda"].block_arrays(), vols["cpu"].block_arrays()
    if set(a) != set(b) or not a:
        fail(f"phase 10: TSDF block sets differ card vs CPU ({len(a)} / "
             f"{len(b)} blocks)")
    e_sdf = max(float(np.abs(a[k][0] - b[k][0]).max()) for k in a)
    e_w = max(float(np.abs(a[k][1] - b[k][1]).max()) for k in a)
    if not (e_sdf <= 1e-5 and e_w <= 1e-5) or tris["cuda"] != tris["cpu"] \
            or tris["cuda"] == 0 \
            or not os.path.getsize(os.path.join(rundir, "mesh.ply")) > 1000:
        fail(f"phase 10: TSDF card vs CPU: SDF {e_sdf:.3e}, weight "
             f"{e_w:.3e} (bound 1e-5), triangles {tris}")
    log(f"[offline] TSDF of {n} rendered keyframes ({len(a)} blocks, voxel "
        f"0.02): card vs CPU SDF max |err| {e_sdf:.3e}, weight {e_w:.3e}, "
        f"{tris['cuda']} triangles on both; fusion "
        f"{t_fuse['cuda'] / n * 1e3:.2f} ms a frame on the card, {t_fuse['cpu'] / n * 1e3:.2f} on the CPU; "
        f"meshing {t_mesh['cuda'] * 1e3:.1f} / {t_mesh['cpu'] * 1e3:.1f} ms; "
        f"the driver (read, fuse, mesh, ply) {t_main:.2f} s | {card}")
    return e_sdf, e_w


def perturbed_keyframe_ate(seq, kf_every=5):
    """The ATE of the keyframe positions that demo_test starts from: its
    ground-truth poses perturbed by the same ``default_rng(0)`` draws."""
    import torch
    from cut3r_slam_tpu_torch.datasets.rgbd import get_dataset
    from cut3r_slam_tpu_torch.demo_test import perturb_pose
    from cut3r_slam_tpu_torch.geometry.pointmap import pose_vec_to_matrix
    from cut3r_slam_tpu_torch.utils.eval import ate_rmse
    ds = get_dataset("replica", seq)
    rng = np.random.default_rng(0)
    est, gt = [], []
    for n in range(min(len(ds), OFFLINE_FRAMES)):
        c2w = pose_vec_to_matrix(torch.as_tensor(ds[n]["pose"])).numpy()
        start = c2w if n == 0 else perturb_pose(rng, c2w)
        if n % kf_every == 0:
            est.append(start[:3, 3])
            gt.append(c2w[:3, 3])
    return ate_rmse(np.stack(est), np.stack(gt))


def offline_phase(rundir, G, card):
    """Phase 10 (see the module docstring). Returns the K1 / K2 launches of
    the phase and of its two mapping drivers."""
    import torch
    from cut3r_slam_tpu_torch import demo_gba, demo_test, run_eval
    from cut3r_slam_tpu_torch.datasets.synth_replica import \
        write_replica_sequence
    from cut3r_slam_tpu_torch import full_f32
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_offline_",
                            dir=os.path.join(ROOT, "build"))
    for k in G.LAUNCHES:
        G.LAUNCHES[k] = 0
    with full_f32():
        integrate_points_card_vs_cpu(card)
    tsdf_card_vs_cpu(rundir, card)

    # (c) offline global-BA resume from phase 8's checkpoint
    ckpt = os.path.join(rundir, "gaussians.npz")
    m0 = demo_gba.load_mapper(ckpt, "cuda")
    valid = m0.cams.valid.cpu().numpy()
    before = float(np.mean([m0.eval_view(i) for i in range(len(valid))
                            if valid[i]]))
    del m0
    l0 = dict(G.LAUNCHES)
    (_, res), t_gba = synced_s(lambda: demo_gba.main([
        "--ckpt", ckpt, "--iters", str(GBA_ITERS), "--out",
        os.path.join(root, "gba")]))
    gba_launches = {k: G.LAUNCHES[k] - l0[k] for k in l0}
    for f in ("gaussians_gba.npz", "3dgs_final.ply", "gba_result.json"):
        if not os.path.exists(os.path.join(root, "gba", f)):
            fail(f"phase 10: demo_gba did not write {f}")
    # the resume may not make the map worse (the JSON rounds to 0.01 dB)
    if not (np.isfinite(before) and res["psnr_kf"] >= before - GBA_SLACK_DB) \
            or min(gba_launches.values()) <= 0:
        fail(f"phase 10: demo_gba PSNR {before} -> {res['psnr_kf']} (may "
             f"fall by {GBA_SLACK_DB} dB at most), launches {gba_launches}")
    log(f"[offline] demo_gba from phase 8's gaussians.npz, {GBA_ITERS} "
        f"iterations: "
        f"keyframe PSNR {before:.3f} -> {res['psnr_kf']:.3f} dB, "
        f"{res['gaussians']} Gaussians, {t_gba:.1f} s, launches "
        f"{gba_launches} | {card}")

    # (d) ground-truth injection on a synthetic Replica sequence
    data = os.path.join(root, "replica")
    t0 = time.perf_counter()
    seq = write_replica_sequence(data, seq="synth0",
                                 n_frames=OFFLINE_FRAMES, seed=0)
    t_write = time.perf_counter() - t0
    ate_in = perturbed_keyframe_ate(seq)
    l0 = dict(G.LAUNCHES)
    (_, res), t_dt = synced_s(lambda: demo_test.main([
        "--dataset", "replica", "--folder", seq, "--output",
        os.path.join(root, "demo_test"), "--length", str(OFFLINE_FRAMES),
        "--target_width", "512", "--arena_capacity", str(2 ** 17)]))
    dt_launches = {k: G.LAUNCHES[k] - l0[k] for k in l0}
    # mapping must remove at least half of the injected pose error
    if not os.path.exists(os.path.join(root, "demo_test", "result.json")) \
            or not (res["ate_rmse_m"] < 0.5 * ate_in
                    and np.isfinite(res["psnr_kf"])) \
            or min(dt_launches.values()) <= 0:
        fail(f"phase 10: demo_test {res} (ATE bound {0.5 * ate_in:.4f} m), "
             f"launches {dt_launches}")
    log(f"[offline] demo_test on {OFFLINE_FRAMES} synth_replica frames "
        f"(680x1200 written in {t_write:.1f} s, mapped at 512 wide): ATE "
        f"{res['ate_rmse_m']} m against GT (the perturbed keyframe poses "
        f"{ate_in:.4f} m), psnr_kf {res['psnr_kf']} dB, "
        f"{res['keyframes']} keyframes, {t_dt:.1f} s, launches {dt_launches}"
        f" | {card}")
    launches = dict(G.LAUNCHES)

    # (e) the eval driver over 12 frames, full-width random CUT3R (phase
    # 6's plausible weights, loaded from a checkpoint), in its own
    # processes (their launches are not counted here)
    weights = os.path.join(root, "cut3r_plausible.pth")
    model = plausible_random_cut3r(seed=0)
    torch.save({"model": model.state_dict()}, weights)
    del model
    cut = os.path.join(root, "cut.yaml")
    with open(cut, "w") as f:
        json.dump({"inherit_from": os.path.join(ROOT, "config",
                                                "replica_config.yaml"),
                   "Mapping": {k: v for k, v in SLICE_MAPPING_CUTS.items()
                               if k != "arena_capacity"}}, f)
    torch.cuda.empty_cache()
    outdir = os.path.join(root, "eval")
    t0 = time.perf_counter()
    summary = run_eval.main([
        "--dataset", "replica", "--datadir", data, "--output", outdir,
        "--sequences", "synth0", "--ckpt", weights, "--extra",
        f"--length 12 --target_width 512 --kf_every 1 "
        f"--buffer 64 --arena_capacity {2 ** 17} --finalize_iters 50 "
        f"--config {cut}"])
    t_eval = time.perf_counter() - t0
    seq_out = os.path.join(outdir, "synth0")
    traj = np.loadtxt(os.path.join(seq_out, "traj_kf.txt"), ndmin=2)
    with open(os.path.join(seq_out, "psnr", "final",
                           "final_result_kf.json")) as f:
        kf_res = json.load(f)
    res = summary["synth0"]
    mesh = os.path.join(seq_out, "mesh.ply")
    ok = (traj.shape[1] == 8 and len(traj) >= 5 and np.isfinite(traj).all()
          and res["keyframes"] >= 5 and np.isfinite(res["psnr_kf"])
          and kf_res["n_views"] >= 5 and np.isfinite(kf_res["mean_psnr"])
          and np.isfinite(res.get("ate_rmse_m", np.nan))
          and res.get("mesh_ply") == mesh and os.path.getsize(mesh) > 1000)
    if not ok:
        fail(f"phase 10: run_eval artifacts incomplete: {res}")
    log(f"[offline] run_eval --dataset replica, 12 frames, full-width "
        f"random CUT3R: traj_kf.txt {traj.shape}, result.json, "
        f"final_result_kf.json ({kf_res['n_views']} views), summary.json, "
        f"mesh.ply {os.path.getsize(mesh)} bytes: all written; ATE "
        f"{res['ate_rmse_m']:.5f} m, psnr_kf {res['psnr_kf']:.3f} dB, "
        f"{t_eval:.1f} s | {card}")
    shutil.rmtree(root, ignore_errors=True)
    log(f"[offline] phase 10 in {time.perf_counter() - t_phase:.1f} s; "
        f"launches {launches}")
    return launches, gba_launches, dt_launches


# ---------------------------------------------------------------------------
# phase 11: the mono prior on the live loop, Omnidata DPT-hybrid, CUT3R's
# linear head, CroCo and the stereo / flow harness, DUSt3R-pair, Spann3R
# ---------------------------------------------------------------------------

PRIOR_FRAMES = 14   # phase 6's first frames: 8 keyframes, a mapping event
SPANN3R_FRAMES = 28  # 23 displaced frames x 196 tokens overflow 4000 slots


def _scratch(prefix):
    """A fresh directory under the checkout's ``build/``."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=os.path.join(ROOT, "build"))


def _close(got, ref, rtol):
    """max |got - ref| over max |ref| (both moved to the CPU), or fails
    above ``rtol``."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    err = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-12)
    return err if err <= rtol else None


def prior_live_loop(G, card, frames, K4):
    """(a) SLAMSystem.run then terminate over phase 6's first frames with
    full-width CUT3R and the default PriorNet prior (384 wide, 12 blocks,
    6 heads; depth and normal, random weights). Returns the kernels'
    launches inside run()."""
    import torch
    from cut3r_slam_tpu_torch import full_f32
    from cut3r_slam_tpu_torch.models.blocks import init_random
    from cut3r_slam_tpu_torch.models.priors import (PriorNet,
                                                     normalize_imagenet)
    from cut3r_slam_tpu_torch.slam.system import SLAMSystem
    from cut3r_slam_tpu_torch.utils.config import DEFAULT_CONFIG
    H, W = frames[0].shape[:2]
    model = plausible_random_cut3r(seed=0)
    cfg = json.loads(json.dumps(DEFAULT_CONFIG))
    cfg["Tracking"]["motion_filter"].update(kf_every=2, use_prior=True)
    cfg["Mapping"].update(SLICE_MAPPING_CUTS)
    cfg["opt_params"] = {"position_lr_max_steps": 50}
    out_dir = _scratch("chip_smoke_prior_")
    slam = SLAMSystem(model, cfg, buffer=64, img_hw=(H, W),
                      output_dir=out_dir, device="cuda")
    prior_s = []

    def timed(fn):
        def run(img):
            out, s = synced(fn, img)
            prior_s.append(s)
            return out
        return run
    slam.filter.prior = tuple(timed(fn) for fn in slam.filter.prior)
    for k in G.LAUNCHES:
        G.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    events = 0
    for t, img in enumerate(frames[:PRIOR_FRAMES]):
        _, viz = slam.run(t, img, K4, img_map=img, K4_map=K4,
                          last=(t == PRIOR_FRAMES - 1))
        events += viz is not None
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(G.LAUNCHES)
    slam.terminate(PRIOR_FRAMES - 1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    kf = slam.keyframes
    n = kf.count
    depth = kf.prior_depth[:n].cpu().numpy()
    normal = kf.prior_normal[:n].cpu().numpy()
    if events < 1:
        fail("phase 11: no mapping event ran with the prior on")
    if min(launches.values()) <= 0:
        fail(f"phase 11: a kernel did not launch inside run(): {launches}")
    if not (np.isfinite(depth).all() and (depth > 0).all()):
        fail("phase 11: a keyframe's prior depth is not finite and > 0")
    unit = float(np.abs(np.linalg.norm(normal, axis=-1) - 1).max())
    if not unit <= 1e-4:
        fail(f"phase 11: prior normals off unit length by {unit:.2e}")
    if not np.isfinite(kf.pose[:n]).all():
        fail("phase 11: non-finite keyframe poses")
    # one PriorNet call card vs CPU, f32 (the system's depth net: seed 0)
    net = PriorNet(device="cuda")
    init_random(net, torch.Generator(device="cuda").manual_seed(0))
    ref = PriorNet(device="cpu")
    ref.load_state_dict(net.state_dict())
    x = normalize_imagenet(torch.as_tensor(frames[0]))[None]
    with torch.no_grad(), full_f32():
        d_card, d_cpu = net(x.cuda()), ref(x)
    rel = _close(d_card, d_cpu, 1e-4)
    if rel is None:
        fail("phase 11: PriorNet card vs CPU beyond 1e-4 of max |depth|")
    log(f"[prior] {PRIOR_FRAMES} frames, {n} keyframes, {events} mapping "
        f"events; {PRIOR_FRAMES / run_s:.3f} frames/s over run() "
        f"({run_s:.1f} s); prior {1e3 * sum(prior_s) / n:.1f} ms per "
        f"keyframe (depth + normal PriorNet, 384 x 12 blocks, synchronized); "
        f"peak {peak:.2f} GiB | {card}")
    log(f"[prior] launches inside run(): {launches}; prior depth "
        f"{float(depth.min()):.3f}-{float(depth.max()):.3f}, normals unit to "
        f"{unit:.1e}; PriorNet card vs CPU (f32) max err / max |depth| "
        f"{rel:.2e}")
    del slam, model
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches


def omnidata_state_dict(task, seed):
    """A random Omnidata DPT-hybrid state dict in the public
    ``omnidata_dpt_{task}_v2`` names and shapes (the model's, drawn by
    ``init_random`` from ``seed``), with the keys of the public checkpoint
    that the model does not read."""
    import torch
    from cut3r_slam_tpu_torch.models.blocks import init_random
    from cut3r_slam_tpu_torch.models.omnidata import OmnidataDPT
    m = init_random(OmnidataDPT(task, device="cpu"),
                    torch.Generator().manual_seed(seed))
    sd = dict(m.state_dict())
    g = torch.Generator().manual_seed(seed + 100)
    for k, shape in (("pretrained.model.norm.weight", (768,)),
                     ("pretrained.model.norm.bias", (768,)),
                     ("pretrained.model.head.weight", (1000, 768)),
                     ("pretrained.model.head.bias", (1000,))):
        sd[k] = torch.randn(shape, generator=g)
    for c in (1, 2):
        pre = "scratch.refinenet4.resConfUnit1."
        sd[pre + f"conv{c}.weight"] = torch.randn(256, 256, 3, 3, generator=g)
        sd[pre + f"conv{c}.bias"] = torch.zeros(256)
    return sd


def omnidata_prior(card, frames):
    """(b) Omnidata checkpoints in the public layout through the system's
    ``omnidata_ckpt_*`` branch at 384x512: card vs CPU (f32), ms a call,
    peak memory."""
    import torch
    from cut3r_slam_tpu_torch import full_f32
    from cut3r_slam_tpu_torch.slam.system import build_prior_fns
    H, W = frames[0].shape[:2]
    root = _scratch("chip_smoke_omni_")
    cfg = {}
    for seed, task in enumerate(("depth", "normal")):
        path = os.path.join(root, f"omnidata_dpt_{task}_v2.ckpt")
        torch.save({"state_dict": {"model." + k: v for k, v in
                                   omnidata_state_dict(task, seed).items()}},
                   path)
        cfg[f"omnidata_ckpt_{task}"] = path
    card_fns = build_prior_fns(cfg, (H, W), "cuda")
    cpu_fns = build_prior_fns(cfg, (H, W), "cpu")
    img = frames[0]
    errs = []
    with torch.no_grad():
        with full_f32():
            for fc, fp in zip(card_fns, cpu_fns):
                # f32 through 16 bottlenecks, 12 ViT blocks and the
                # decoder, summed in other orders on the two devices
                err = _close(fc(img), fp(img), 5e-4)
                if err is None:
                    fail("phase 11: Omnidata prior card vs CPU beyond 5e-4 "
                         "of the map's max")
                errs.append(err)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2 ** 30
        ms = [cuda_ms(lambda: fn(img), 5) for fn in card_fns]
        d, nrm = (fn(img) for fn in card_fns)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (torch.isfinite(d).all() and torch.isfinite(nrm).all()) \
            or d.shape != (H, W) or nrm.shape != (H, W, 3):
        fail("phase 11: Omnidata priors not finite maps of the image size")
    shutil.rmtree(root, ignore_errors=True)
    log(f"[omnidata] DPT-hybrid (ViT-B/16 + ResNet-50 stem, random weights "
        f"loaded strictly from the public ckpt layout) at {H}x{W}: depth "
        f"{ms[0]:.2f} ms, normal {ms[1]:.2f} ms a call (TF32 convolutions "
        f"through cuDNN, the default); card vs CPU (f32) max err / max "
        f"{errs[0]:.2e} / {errs[1]:.2e}; peak {peak:.2f} GiB with "
        f"{base:.2f} GiB of weights held | {card}")


def linear_head_check(card):
    """(c) CUT3R with the linear head: the tiny model card vs CPU (f32,
    every head), then one full-width inference forward at 224x224."""
    import dataclasses
    import torch
    from cut3r_slam_tpu_torch import full_f32
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    tiny = dataclasses.replace(CUT3RConfig.tiny(), head_type="linear")
    a = CUT3R(tiny, device="cpu")
    a.init_random(torch.Generator().manual_seed(3))
    b = CUT3R(tiny, device="cuda")
    b.load_state_dict(a.state_dict())
    x = torch.rand(2, 1, 32, 48, 3, generator=torch.Generator().manual_seed(4)
                   ) * 2 - 1
    with torch.no_grad(), full_f32():
        oa, ob = a(x), b(x.cuda())
    worst = 0.0
    for k in oa:
        err = _close(ob[k], oa[k], 1e-4)
        if err is None:
            fail(f"phase 11: linear-head {k} card vs CPU beyond 1e-4")
        worst = max(worst, err)
    full = CUT3R(dataclasses.replace(CUT3RConfig(), head_type="linear"),
                 device="cuda")
    full.init_random(torch.Generator(device="cuda").manual_seed(0))
    imgs = torch.rand(2, 1, 224, 224, 3, device="cuda") * 2 - 1
    with torch.no_grad():
        out, s = synced(full, imgs)
        _, s = synced(full, imgs)
    if not all(torch.isfinite(v).all() for v in out.values()) \
            or out["pts3d_in_self_view"].shape != (2, 1, 224, 224, 3):
        fail("phase 11: the full-width linear head gave non-finite outputs")
    log(f"[linear] CUT3R with LinearPts3dPose: tiny card vs CPU (f32) max "
        f"err / max {worst:.2e}; full width (bf16), 2 views at 224x224, "
        f"every head: {1e3 * s:.1f} ms a forward | {card}")
    del full


def _flow_batches(frames, batch, seed, hw=(224, 224), shift=(3, 1)):
    """{img1, img2, gt} batches: crops of the synthetic frames in [-1, 1]
    and the same crops moved by ``shift`` (a constant flow)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    dx, dy = shift
    while True:
        i1, i2 = [], []
        for _ in range(batch):
            f = frames[rng.integers(len(frames))].astype(np.float32)
            y = int(rng.integers(0, f.shape[0] - h - dy))
            x = int(rng.integers(0, f.shape[1] - w - dx))
            i1.append(f[y + dy:y + dy + h, x + dx:x + dx + w])
            i2.append(f[y:y + h, x:x + w])
        norm = lambda a: np.stack(a) / 127.5 - 1.0
        gt = np.broadcast_to(np.float32([dx, dy]), (batch, h, w, 2))
        yield {"img1": norm(i1), "img2": norm(i2), "gt": gt.copy()}


def croco_phase(card, frames):
    """(d) full CroCoConfig(): pretraining steps on make_pair_iter pairs,
    train_stereoflow steps, tiled_predict and evaluate_stereoflow."""
    import torch
    from cut3r_slam_tpu_torch.datasets import PairDataset, make_pair_iter
    from cut3r_slam_tpu_torch.models.blocks import init_random
    from cut3r_slam_tpu_torch.models.croco_pretrain import (
        CroCoConfig, CroCoPretrain, croco_pretrain_loss)
    from cut3r_slam_tpu_torch.train.stereoflow import (
        StereoFlowConfig, evaluate_stereoflow, tiled_predict,
        train_stereoflow)
    from cut3r_slam_tpu_torch.train.train_step import AdamW
    cfg = CroCoConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_random(CroCoPretrain(cfg, device="cuda"), gen)
    opt = AdamW(model.parameters(), lr=1.5e-4, weight_decay=0.05,
                warmup_steps=1, total_steps=6)
    pairs = make_pair_iter(PairDataset([{"image": f} for f in frames],
                                       synth=True, seed=0),
                           batch_size=8, seed=0, resolution=(224, 224))
    losses, secs = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(6):
        b = next(pairs)
        t0 = time.perf_counter()
        pred, mask, target = model(torch.as_tensor(b["img1"], device="cuda"),
                                   torch.as_tensor(b["img2"], device="cuda"),
                                   generator=gen)
        loss = croco_pretrain_loss(pred, mask, target)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        secs.append(time.perf_counter() - t0)
    peak_p = torch.cuda.max_memory_allocated() / 2 ** 30
    n_vis = int((~mask).sum(1)[0])
    if not np.isfinite(losses).all() or n_vis != 20:
        fail(f"phase 11: CroCo pretraining losses {losses}, {n_vis} visible")
    del model, opt
    tcfg = StereoFlowConfig(task="flow", lr=3e-5, total_steps=6,
                            warmup_steps=1, log_every=1)
    logs, t0 = [], time.perf_counter()
    flow, flosses = train_stereoflow(cfg, _flow_batches(frames, 4, 1), tcfg,
                                     log_fn=logs.append, generator=gen,
                                     device="cuda")
    torch.cuda.synchronize()
    flow_s = (time.perf_counter() - t0) / tcfg.total_steps
    if not np.isfinite(flosses).all() or len(flosses) != 6:
        fail(f"phase 11: stereo / flow losses {flosses}")
    big = next(_flow_batches(frames, 1, 2, hw=(352, 480)))
    pred = tiled_predict(flow, big["img1"][0], big["img2"][0])
    evals = evaluate_stereoflow(flow, [{k: v[0] for k, v in next(
        _flow_batches(frames, 1, 3 + i, hw=(352, 480))).items()}
        for i in range(2)])
    if pred.shape != (352, 480, 2) or not np.isfinite(pred).all() \
            or not np.isfinite(list(evals.values())).all():
        fail("phase 11: tiled stereo / flow prediction not finite")
    log(f"[croco] CroCoPretrain ViT-B/16 768x12 + 512x8 decoder at 224x224, "
        f"mask 0.9 ({n_vis} of 196 visible), batch 8: losses "
        f"{[round(x, 4) for x in losses]}, {np.mean(secs[1:]):.3f} s a step "
        f"after the first ({secs[0]:.2f} s), peak {peak_p:.2f} GiB | {card}")
    log(f"[croco] train_stereoflow (flow, batch 4, 224x224): losses "
        f"{[round(x, 4) for x in flosses]}, {flow_s:.3f} s a step; "
        f"tiled_predict at 352x480 (6 tiles); evaluate_stereoflow EPE "
        f"{evals['epe']:.3f} px on random-start weights | {card}")


def dust3r_spann3r_phase(card, frames):
    """(e) AsymmetricCroCo3DStereo at the DUSt3R_ViTLarge_BaseDecoder_512
    widths on one 512x384 pair (linear and DPT heads), Spann3R over
    enough 224x224 frames to evict from its ring and its arena, and an
    upstream-layout Spann3R checkpoint loaded strictly."""
    import dataclasses
    import torch
    from cut3r_slam_tpu_torch.models.blocks import init_random
    from cut3r_slam_tpu_torch.models.convert import (SPANN3R_SKIP,
                                                     load_spann3r_checkpoint)
    from cut3r_slam_tpu_torch.models.dust3r_pair import (
        AsymmetricCroCo3DStereo, Dust3rPairConfig)
    from cut3r_slam_tpu_torch.models.spann3r import Spann3R, Spann3RConfig
    H, W = frames[0].shape[:2]
    norm = lambda f: torch.as_tensor(f, device="cuda").float()[None] \
        / 127.5 - 1.0
    for head in ("linear", "dpt"):
        m = AsymmetricCroCo3DStereo(Dust3rPairConfig(head=head), "cuda")
        init_random(m, torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            synced(m, norm(frames[0]), norm(frames[1]))
            (p1, p2), s = synced(m, norm(frames[0]), norm(frames[1]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(torch.isfinite(p[k]).all() for p in (p1, p2) for k in p) \
                or p2["pts3d"].shape != (1, H, W, 3):
            fail(f"phase 11: DUSt3R-pair ({head}) outputs not finite")
        log(f"[dust3r] AsymmetricCroCo3DStereo 1024x24 + 2 x 768x12, "
            f"{head} head, one {W}x{H} pair: {1e3 * s:.1f} ms (f32), peak "
            f"{peak:.2f} GiB | {card}")
        del m
    cfg = Spann3RConfig()
    model = init_random(Spann3R(cfg, device="cuda"),
                        torch.Generator(device="cuda").manual_seed(2))
    clips = [np.ascontiguousarray(f[80:304, 144:368]) for f in frames]
    torch.cuda.reset_peak_memory_stats()
    carry, secs = None, []
    with torch.no_grad():
        for v in range(SPANN3R_FRAMES):
            (carry, (p0, _)), s = synced(model.step, carry,
                                         norm(clips[v % len(clips)]))
            secs.append(s)
            if not torch.isfinite(p0["pts3d"]).all():
                fail(f"phase 11: Spann3R frame {v} not finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mem = carry[3]
    P = (224 // 16) ** 2
    overflow = (SPANN3R_FRAMES - cfg.work_mem_frames) * P \
        - cfg.long_mem_tokens
    if int(mem.work_head[0]) != SPANN3R_FRAMES or overflow <= 0 \
            or not bool(mem.long_valid.all()):
        fail("phase 11: Spann3R's memories did not both evict")
    root = _scratch("chip_smoke_spann3r_")
    path = os.path.join(root, "spann3r.pth")
    extra = {"dust3r.mask_token": torch.zeros(1, 1, 1024),
             "dust3r.enc_pos_embed": torch.zeros(1, 1024, 1024)}
    assert all(k.startswith(tuple(SPANN3R_SKIP)) for k in extra)
    torch.save({"model": {**{"module." + k: v.cpu() for k, v in
                             model.state_dict().items()}, **extra}}, path)
    fresh = Spann3R(cfg, device="cuda")
    fresh.load_state_dict(load_spann3r_checkpoint(path), strict=True)
    same = all(torch.equal(a, b) for a, b in zip(
        fresh.state_dict().values(), model.state_dict().values()))
    shutil.rmtree(root, ignore_errors=True)
    if not same:
        fail("phase 11: the Spann3R checkpoint did not load its tensors")
    log(f"[spann3r] Spann3R (ViT-L DUSt3R, 6 value blocks, ring 5 frames, "
        f"arena 4000 tokens) over {SPANN3R_FRAMES} frames at 224x224: "
        f"{1e3 * np.mean(secs[1:]):.1f} ms a frame after the first "
        f"({1e3 * secs[0]:.0f} ms), the arena overflowed by {overflow} "
        f"tokens, peak {peak:.2f} GiB; an upstream-layout checkpoint "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"params) loaded strictly | {card}")


def model_families_phase(G, card, frames, K4):
    """Phase 11 (see the module docstring). Returns the kernels' launches
    inside the prior run's ``SLAMSystem.run``."""
    import torch
    t0 = time.perf_counter()
    launches = prior_live_loop(G, card, frames, K4)
    for part in (omnidata_prior, linear_head_check, croco_phase,
                 dust3r_spann3r_phase):
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        if part is linear_head_check:
            part(card)
        else:
            part(card, frames)
        log(f"[phase 11] {part.__name__} in {time.perf_counter() - t1:.1f} s")
    log(f"[phase 11] in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the DROID stack, the shared math and the live viewer
# ---------------------------------------------------------------------------
DROID_FRAMES, DROID_STEPS = 7, 12   # DROID-SLAM's training clip, GRU steps
VIEWER_FRAMES = 8                   # phase 6's first frames


def droid_edges(n, span=2):
    """Every ordered pair with 0 < |i - j| <= span (22 edges for 7)."""
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    m = (np.abs(ii - jj) <= span) & (ii != jj)
    return ii[m], jj[m]


def droid_clip(n, h8, w8, f8, seed):
    """Poses of ``n`` frames (a slow forward drift), 1/8 disparities and
    intrinsics (numpy, f32)."""
    import torch
    from cut3r_slam_tpu_torch.geometry.lie import se3_exp
    rng = np.random.default_rng(seed)
    xi = np.zeros((n, 6), np.float32)
    xi[:, 0] = np.arange(n) * 0.02
    xi[:, 2] = np.arange(n) * -0.01
    xi[:, 4] = np.arange(n) * 0.005
    poses = se3_exp(torch.tensor(xi)).numpy()
    disps = (0.5 + 0.1 * np.sin(np.arange(w8) / 5.0)[None, None]
             + 0.02 * rng.standard_normal((n, h8, w8))).astype(np.float32)
    intr = np.tile([f8, f8, w8 / 2, h8 / 2], (n, 1)).astype(np.float32)
    return poses, disps, intr


def droid_ba_case(n=21, fixedp=4, h8=48, w8=64, n_edges=290, seed=0,
                  device="cuda"):
    """A dense-BA input shaped as ``droid_track``'s (``DroidGraph.update``:
    ~290 edges over a ~21-frame window, 3-4 frames fixed, the 48x64 grid):
    every ordered pair with 0 < |i - j| <= 3, then retired copies of the
    older frames' pairs (repeated (i, j), edges into fixed frames) up to
    ``n_edges``; targets from the true geometry plus 0.5 px of noise,
    confidences in (0, 1), the free poses and every disparity perturbed,
    eta as the tracker's 0.2 x damping + 1e-7. Returns bundle_adjust's
    positional inputs (target, weight, eta, poses, disps, intr, ii, jj, ev)
    on ``device``."""
    import torch
    from cut3r_slam_tpu_torch.geometry.lie import se3_exp, se3_mul
    from cut3r_slam_tpu_torch.geometry.projective import \
        projective_transform
    rng = np.random.default_rng(seed)
    poses, disps, intr = droid_clip(n, h8, w8, w8 * 0.9, seed)
    pairs = [(i, j) for i in range(n) for j in range(n)
             if 0 < abs(i - j) <= 3]
    old = [(i, j) for i, j in pairs if min(i, j) < max(n - 8, 2)]
    while len(pairs) < n_edges:
        pairs.append(old[len(pairs) % len(old)])
    ii, jj = (np.asarray(x, np.int64) for x in zip(*pairs[:n_edges]))
    t = [torch.tensor(a) for a in (poses, disps, intr, ii, jj)]
    target = projective_transform(*t)[0].numpy()
    target = target + 0.5 * rng.standard_normal(target.shape)
    weight = rng.uniform(0.0, 1.0, target.shape)
    xi = 1e-3 * rng.standard_normal((n, 6))
    xi[:fixedp] = 0
    poses = se3_mul(se3_exp(torch.tensor(xi, dtype=torch.float32)),
                    t[0]).numpy()
    disps = disps * (1 + 0.05 * rng.standard_normal(disps.shape))
    eta = 0.2 * rng.uniform(1e-3, 1e-1, disps.shape) + 1e-7
    arrays = [target, weight, eta, poses, disps, intr]
    out = [torch.tensor(a, dtype=torch.float32, device=device)
           for a in arrays]
    return out + [torch.tensor(ii, device=device),
                  torch.tensor(jj, device=device),
                  torch.ones(len(ii), device=device)]


def _within(name, got, ref, atol, rtol):
    """Fails unless |got - ref| <= atol + rtol |ref| everywhere (both on
    the CPU); returns max |got - ref| / max |ref|."""
    import torch
    got = got.detach().float().cpu()
    ref = ref.detach().float().cpu()
    bad = ~((got - ref).abs() <= atol + rtol * ref.abs())
    if bad.any() or not torch.isfinite(got).all():
        fail(f"phase 12: {name} card vs CPU beyond {atol:g} + {rtol:g} "
             f"relative ({int(bad.sum())} elements)")
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-12)


def droid_card_vs_cpu():
    """The DROID stack on the card against the CPU at a small shape, all
    in f32 (``full_f32``), each within the tolerance its CPU test states:
    projective_transform with Jacobians and corr_lookup 1e-5 + 1e-5
    relative; bundle_adjust, moba and jdsa 1e-5 + 1e-4 relative; one
    DroidNet forward (3 frames of 64x64, 4 edges, num_steps 2) 1e-4 +
    1e-4 relative."""
    import torch
    from cut3r_slam_tpu_torch import full_f32
    from cut3r_slam_tpu_torch.geometry.projective import \
        projective_transform
    from cut3r_slam_tpu_torch.models.blocks import init_random
    from cut3r_slam_tpu_torch.models.droid_net import DroidNet
    from cut3r_slam_tpu_torch.ops.ba import bundle_adjust, jdsa, moba
    from cut3r_slam_tpu_torch.ops.corr import build_corr_pyramid, \
        corr_lookup
    rng = np.random.default_rng(12)
    n, h, w = 4, 12, 16
    poses, disps, intr = droid_clip(n, h, w, 20.0, 12)
    ii, jj = droid_edges(n, 1)
    gt = droid_clip(n, h, w, 20.0, 13)[1]
    errs = {}

    def both(fn, *arrays):
        cpu = fn(*(torch.tensor(a) for a in arrays))
        card = fn(*(torch.tensor(a, device="cuda") for a in arrays))
        return card, cpu

    with full_f32():
        card, cpu = both(lambda p, d, k, a, b: projective_transform(
            p, d, k, a, b, jacobian=True), poses, disps, intr, ii, jj)
        for name, g, r in zip(("coords", "valid", "Ji", "Jj", "Jz"),
                              card[:2] + card[2], cpu[:2] + cpu[2]):
            errs[f"projective {name}"] = _within(
                f"projective_transform {name}", g, r, 1e-5, 1e-5)
        f1 = rng.normal(size=(2, h, w, 32)).astype(np.float32)
        f2 = rng.normal(size=(2, h, w, 32)).astype(np.float32)
        coords = np.stack([rng.uniform(-4, w + 4, (2, h, w)),
                           rng.uniform(-4, h + 4, (2, h, w))],
                          -1).astype(np.float32)
        card, cpu = both(lambda a, b, c: corr_lookup(
            build_corr_pyramid(a, b), c), f1, f2, coords)
        errs["corr_lookup"] = _within("corr_lookup", card, cpu, 1e-5, 1e-5)
        target = both(lambda p, d, k, a, b: projective_transform(
            p, d, k, a, b)[0], poses, gt, intr, ii, jj)[1].numpy()
        weight = rng.uniform(0.2, 1.0, target.shape).astype(np.float32)
        eta = np.full((n, h, w), 1e-2, np.float32)
        ev = np.ones(len(ii), np.float32)
        card, cpu = both(lambda *a: bundle_adjust(*a, fixedp=2, steps=2),
                         target, weight, eta, poses, disps, intr, ii, jj, ev)
        for name, g, r in zip(("poses", "disps", "dzcov"), card, cpu):
            errs[f"bundle_adjust {name}"] = _within(
                f"bundle_adjust {name}", g, r, 1e-5, 1e-4)
        card, cpu = both(lambda *a: moba(*a, fixedp=1, steps=3), target,
                         weight, poses, disps, intr, ii, jj, ev)
        errs["moba poses"] = _within("moba", card, cpu, 1e-5, 1e-4)
        prior = (gt / 1.25).astype(np.float32)
        dsc = (1 + 0.1 * rng.normal(size=(n, 3, 4))).astype(np.float32)
        card, cpu = both(lambda *a: jdsa(*a, alpha=0.05), target, weight,
                         eta, poses, disps, intr, prior, dsc, ii, jj, ev)
        for name, g, r in zip(("disps", "dscales", "dzcov"), card, cpu):
            errs[f"jdsa {name}"] = _within(f"jdsa {name}", g, r, 1e-5, 1e-4)

        net = init_random(DroidNet(device="cuda"),
                          torch.Generator(device="cuda").manual_seed(1))
        ref = DroidNet(device="cpu")
        ref.load_state_dict(net.state_dict())
        imgs = np.stack(synth_frames(3, 64, 64, seed=3)).astype(np.float32)
        p3, d3, k3 = droid_clip(3, 8, 8, 9.6, 14)
        e3 = np.asarray([0, 1, 1, 2]), np.asarray([1, 0, 2, 1])
        with torch.no_grad():
            outs = [m(*(torch.tensor(a, device=dev) for a in (
                p3, imgs, d3, k3, e3[0], e3[1], np.ones(4, np.float32))),
                num_steps=2, fixedp=1) for m, dev in ((net, "cuda"),
                                                      (ref, "cpu"))]
        for name, g, r in zip(("poses", "disps", "residual"), *outs):
            errs[f"DroidNet {name}"] = _within(f"DroidNet forward {name}",
                                               g, r, 1e-4, 1e-4)
    return errs


def oracle_ba(h8, w8, f8):
    """As tests/test_droid_convergence.py, at the phase's clip: targets from
    the true geometry of 7 frames (22 edges, 1/8 grid), frames 2-6
    perturbed, 8 x 2 BA steps with frames 0-1 fixed. Returns (error
    before, after) of the worst pose and the ms of one 2-step call."""
    import torch
    from cut3r_slam_tpu_torch.geometry.lie import se3_exp, se3_mul
    from cut3r_slam_tpu_torch.geometry.projective import \
        projective_transform
    from cut3r_slam_tpu_torch.ops.ba import bundle_adjust
    n = DROID_FRAMES
    poses, disps, intr = (torch.tensor(a, device="cuda") for a in
                          droid_clip(n, h8, w8, f8, 21))
    ii, jj = (torch.tensor(a, device="cuda") for a in droid_edges(n))
    target, _ = projective_transform(poses, disps, intr, ii, jj)
    rng = np.random.default_rng(22)
    bad = torch.tensor(rng.normal(size=(n, 6)) * 0.01, dtype=torch.float32,
                       device="cuda")
    bad[:2] = 0
    cur = se3_mul(se3_exp(bad), poses)

    def err(p):
        return float((p - poses).norm(dim=-1).max())

    e0 = err(cur)
    weight = torch.ones_like(target)
    eta = torch.full((n, h8, w8), 1e-4, device="cuda")
    ev = torch.ones(len(ii), device="cuda")
    d = disps.clone()
    for _ in range(8):
        cur, d, _ = bundle_adjust(target, weight, eta, cur, d, intr, ii, jj,
                                  ev, fixedp=2, n_frames=n, steps=2)
    ms = cuda_ms(lambda: bundle_adjust(target, weight, eta, poses, disps,
                                       intr, ii, jj, ev, fixedp=2,
                                       n_frames=n, steps=2), 10)
    return e0, err(cur), ms


# the BA step's kernels (csrc/droid_ba.cu) against the card's peaks: FP32
# outside the tensor cores and HBM3 (the hopper-kernels guide)
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations of one edge pixel in ba_edge_kernel: the projection ~30,
# Jj 15, Ji 108, the weighted rows 24, the H blocks 312, v 48, Ei / Ej 36,
# Ck / wk 8 (counted from the source)
EDGE_FLOPS_PER_PIXEL = 580


def ba_kernel_bounds(ii, jj, fixedp, P0, HW):
    """Least time (s) of each kernel of one BA step at these shapes: the
    larger of its FP32 operations at 67 TFLOP/s and its bytes (each input
    read once, each output written once) at 3.35 TB/s; ba_plan and ba_cov
    once a call. From the plan (``ba_plan``), as the kernels see it:
    {kernel: (seconds, "bytes" | "operations")}."""
    import torch
    from cut3r_slam_tpu_torch.ops.ba import ba_plan
    E, P = len(ii), P0 - fixedp
    n = 6 * P
    cells = ba_plan(torch.as_tensor(ii).cpu(), torch.as_tensor(jj).cpu(),
                    fixedp, P0).long()
    cE = cells[6 * E:8 * E]
    nz = torch.zeros(P * P0, dtype=torch.int64)
    nz.index_add_(0, cE[cE >= 0], torch.ones_like(cE[cE >= 0]))
    pres = (nz > 0).reshape(P, P0)
    blocks = int(pres.sum())                  # nonzero E blocks
    both = pres.int() @ pres.int().T          # (a, b): shared depth frames
    pair_k = int(torch.tril(both).sum())      # (a, b <= a, k) products
    f4 = 4
    out = {}
    eb = E * HW * (2 * 2 * f4 + 12 * f4 + 2 * f4) + P0 * HW * f4 \
        + E * (4 * 36 + 2 * 6) * f4
    out["ba_edge"] = (eb, E * HW * EDGE_FLOPS_PER_PIXEL)
    landed = int((cells[:4 * E] >= 0).sum()) * 36 \
        + int((cells[4 * E:6 * E] >= 0).sum()) * 6 \
        + int((cE >= 0).sum()) * 6 * HW + int((cells[8 * E:] >= 0).sum()) \
        * 2 * HW
    gb = (landed + P * P * 36 + P * 6 + P * P0 * 6 * HW + 3 * P0 * HW) * f4
    out["ba_gather"] = (gb, landed)
    out["ba_schur"] = ((blocks * 6 * HW + 2 * P0 * HW + P * P * 36
                        + n * n) * f4,
                       pair_k * HW * (6 + 72) + blocks * HW * (6 + 12))
    out["ba_solve"] = ((n * n + n + 2 * P0 * 7) * f4 + n * (n + 1) // 2
                       * f4, n ** 3 // 3 + 2 * n * n)
    out["ba_update"] = ((blocks * 6 * HW + 4 * P0 * HW) * f4,
                        blocks * HW * 12 + 3 * P0 * HW)
    out["ba_cov"] = ((blocks * 6 * HW + 2 * P0 * HW + n * (n + 1) // 2)
                     * f4, P0 * HW * (n * n + n))
    out["ba_plan"] = (2 * E * 8 + 9 * E * f4, 9 * E)
    return {k: (max(b / PEAK_BYTES, f / PEAK_FP32),
                "bytes" if b / PEAK_BYTES >= f / PEAK_FP32 else "operations")
            for k, (b, f) in out.items()}


def _ba_profile(fn, calls=5):
    """Device time by kernel name (s a call) and the device operations a
    call, from torch.profiler over ``calls`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name, ops = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ops += 1
            by_name[e.name()] = by_name.get(e.name(), 0.0) + \
                e.duration_ns() * 1e-9 / calls
    return by_name, ops / calls


def droid_ba_phase(card):
    """(d) The dense BA's step on the card at ``droid_track``'s shapes
    (``droid_ba_case``: 290 edges, 21 frames, 4 fixed, 48x64) and at a
    small case: the kernel path (csrc/droid_ba.cu) against the plain path
    (an input that requires a gradient sends a card call there; the same
    plain steps on the CPU in float32 and float64): two steps' poses,
    disparities and covariance within 1e-4 of the CPU's plain path's
    relative to the largest entry (the card's plain path read beside it),
    their distance from the float64 steps at most 3x the plain float32
    path's; ms a call (2 steps) of each path by CUDA events, the host's
    enqueue time of each (the kernel path's buffers' part of it), device
    operations a step, each kernel's time beside its bound."""
    import torch
    from cut3r_slam_tpu_torch.ops import ba
    from cut3r_slam_tpu_torch.ops.ba import bundle_adjust
    res = {}
    for name, case in (("small", dict(n=5, fixedp=2, h8=12, w8=16,
                                       n_edges=18, seed=7)),
                       ("droid_track", dict(seed=8))):
        args = droid_ba_case(**case)
        fixedp = case.get("fixedp", 4)
        cpu = [a.cpu() for a in args]
        f64 = [a.double() if a.is_floating_point() else a for a in cpu]

        def kernel():
            return bundle_adjust(*args, fixedp=fixedp, steps=2)

        def plain():
            p = args[3].clone().requires_grad_()
            with torch.no_grad():
                return bundle_adjust(*args[:3], p, *args[4:], fixedp=fixedp,
                                     steps=2)

        with torch.no_grad():
            kp, kd, kc = kernel()
            cp, cd, cc = bundle_adjust(*cpu, fixedp=fixedp, steps=2)
            dp, dd, _ = bundle_adjust(*f64, fixedp=fixedp, steps=2)
        gp, gd, gc = plain()
        errs = {}
        for what, got, ref in (("poses", kp, cp), ("disps", kd, cd),
                               ("dzcov", kc, cc), ("card plain poses", gp,
                                                   cp),
                               ("card plain disps", gd, cd),
                               ("card plain dzcov", gc, cc)):
            got, ref = got.detach().double().cpu(), ref.double()
            errs[what] = float((got - ref).abs().max()
                               / ref.abs().max())
            if not what.startswith("card") and not errs[what] <= 1e-4:
                fail(f"phase 12(d): {name} kernel BA {what} {errs[what]:.3e}"
                     " from the plain path (limit 1e-4 of the largest entry)")
        ratio = {}
        for what, got, ref, x0 in (("poses", kp, cp, cpu[3]),
                                   ("disps", kd, cd, cpu[4])):
            truth = (dp if what == "poses" else dd) - x0.double()
            dk = float(((got.cpu().double() - x0.double()) - truth).norm())
            dc = float(((ref.double() - x0.double()) - truth).norm())
            ratio[what] = dk / max(dc, 1e-30)
            if not ratio[what] <= 3.0:
                fail(f"phase 12(d): {name} kernel BA {what} step {dk:.3e} "
                     f"from the float64 step, {ratio[what]:.2f}x the plain "
                     "float32 path's (limit 3x)")
        k_ms, p_ms = cuda_ms(kernel, 20), cuda_ms(plain, 5)

        def host_ms(fn, n=10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t = (time.perf_counter() - t0) / n
            torch.cuda.synchronize()
            return 1e3 * t
        with torch.no_grad():
            kh = host_ms(kernel)
            P0, HW = args[3].shape[0], args[4].shape[1] * args[4].shape[2]
            kb = host_ms(lambda: ba._step_work(len(args[6]), P0 - fixedp,
                                               P0, HW, args[6].device))
        ph = host_ms(plain, 3)
        for k in ba.LAUNCHES:
            ba.LAUNCHES[k] = 0
        k_names, k_ops = _ba_profile(kernel)
        _, p_ops = _ba_profile(plain, 2)
        launched = dict(ba.LAUNCHES)
        ii, jj = args[6].cpu().numpy(), args[7].cpu().numpy()
        bounds = ba_kernel_bounds(ii, jj, fixedp, P0, HW)
        kern = {}
        for k, (least, what) in bounds.items():
            t = sum(v for n_, v in k_names.items() if k + "_kernel" in n_)
            if k not in ("ba_plan", "ba_cov"):
                t /= 2              # a step
            kern[k] = {"ms": 1e3 * t, "bound_ms": 1e3 * least, "by": what}
        res[name] = {"errs": errs, "ratio_to_plain32": ratio,
                     "kernel_ms": k_ms, "plain_ms": p_ms,
                     "kernel_host_ms": kh, "kernel_buffers_host_ms": kb,
                     "plain_host_ms": ph,
                     "ops_per_step": {"kernel": k_ops / 2,
                                      "plain": p_ops / 2},
                     "launches": launched, "kernels": kern,
                     "edges": len(ii), "frames": int(P0)}
        log(f"[droid BA {name}] {json.dumps(res[name])} | {card}")
    return res


def droid_phase(G, card, frames):
    """(a) DroidNet at its full widths (fnet 128, cnet 256, 128-plane GRU;
    seeded random weights) on 7 of phase 6's frames at 384x512 (1/8 grid
    48x64), the 22 edges |i - j| <= 2, fixedp 2, 12 GRU steps x 2 BA
    iterations: ms of a forward (CUDA events) and its peak memory; one
    value-and-grad step of mean |residual| at num_steps 2 (finite loss,
    nonzero gradient); the oracle-target BA (>= 10x); the card-vs-CPU
    checks. Returns the kernels' launches over the part (none expected:
    DROID renders nothing)."""
    import torch
    from cut3r_slam_tpu_torch.models.blocks import init_random
    from cut3r_slam_tpu_torch.models.droid_net import DroidNet
    for k in G.LAUNCHES:
        G.LAUNCHES[k] = 0
    H, W = frames[0].shape[:2]
    h8, w8, f8 = H // 8, W // 8, 400.0 / 8
    net = init_random(DroidNet(device="cuda"),
                      torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in net.parameters())
    poses, disps, intr = droid_clip(DROID_FRAMES, h8, w8, f8, 20)
    ii, jj = droid_edges(DROID_FRAMES)
    dev = [torch.tensor(a, device="cuda") for a in (
        poses, np.stack(frames[:DROID_FRAMES]).astype(np.float32), disps,
        intr, ii, jj, np.ones(len(ii), np.float32))]

    def forward(steps=DROID_STEPS):
        return net(*dev, num_steps=steps, fixedp=2)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        p1, d1, r1 = forward()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        fwd_ms = cuda_ms(forward, 3)
    if not all(torch.isfinite(x).all() for x in (p1, d1, r1)):
        fail("phase 12: DroidNet forward gave non-finite output")
    moved = float((p1[2:] - dev[0][2:]).norm(dim=-1).max())
    def grad_step():
        loss = forward(2)[2].abs().mean()
        loss.backward()
        return loss

    net.zero_grad()
    torch.cuda.reset_peak_memory_stats()
    loss, step_s = synced_s(grad_step)
    gpeak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    gsum = sum(float(p.grad.abs().sum()) for p in net.parameters()
               if p.grad is not None)
    loss = loss.item()
    if not (np.isfinite(loss) and gsum > 0):
        fail(f"phase 12: DroidNet training step: loss {loss}, |grad| sum "
             f"{gsum}")
    e0, e1, ba_ms = oracle_ba(h8, w8, f8)
    if not (np.isfinite(e1) and e1 <= e0 / 10):
        fail(f"phase 12: oracle-target BA error {e0:.3e} -> {e1:.3e} "
             "(below 10x)")
    launches = dict(G.LAUNCHES)
    errs = droid_card_vs_cpu()
    droid_ba_phase(card)
    log(f"[droid] DroidNet {n_params / 1e6:.2f} M params (random, seed 0), "
        f"{DROID_FRAMES} frames {H}x{W} (grid {h8}x{w8}), {len(ii)} edges, "
        f"fixedp 2, {DROID_STEPS} GRU steps x 2 BA iterations: forward "
        f"{fwd_ms:.1f} ms (CUDA events, mean of 3; convolutions at torch's "
        f"default cuDNN precision with TF32 allowed, correlation f32, BA "
        f"under full_f32), peak {peak:.2f} GiB above the inputs; poses "
        f"moved up to {moved:.3e} | {card}")
    log(f"[droid] value-and-grad step of mean |residual| at num_steps 2: "
        f"loss {loss:.4f}, |grad| sum {gsum:.3e}, {1e3 * step_s:.1f} "
        f"ms, peak {gpeak:.2f} GiB | {card}")
    log(f"[droid] oracle-target BA (8 x 2 steps, 7 frames, 22 edges, grid "
        f"{h8}x{w8}): worst pose error {e0:.3e} -> {e1:.3e} "
        f"({e0 / max(e1, 1e-30):.1f}x); one 2-iteration bundle_adjust "
        f"{ba_ms:.2f} ms | {card}")
    log("[droid] card vs CPU (f32), max err / max |cpu|: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()))
    log(f"[droid] launches: {launches}")
    if any(launches.values()):
        fail(f"phase 12: the DROID stack launched a rasterizer kernel: "
             f"{launches}")
    del net, dev
    return launches


def shared_math_card_vs_cpu(card, frames):
    """(b) tv_loss, sobel_edges and gaussian_blur on a 384x512 frame and
    the robust Sim(3) of a 384x512 point-map pair (a tenth of the rows
    outliers, 20 IRLS iterations: the scale within 0.02 of the truth, as
    tests/test_shared_math.py), card vs CPU, within the tolerances of
    tests/test_torch_shared_math.py (1e-6 on the image maps and the loss,
    1e-5 on the scale, 1e-4 on R and t)."""
    import torch
    from cut3r_slam_tpu_torch.geometry.sim3_align import \
        weighted_align_point_maps
    from cut3r_slam_tpu_torch.ops.imageproc import (gaussian_blur,
                                                     sobel_edges, tv_loss)
    rng = np.random.default_rng(30)
    img = frames[0].astype(np.float32) / 255.0
    H, W = img.shape[:2]
    depth = rng.uniform(0.5, 3.0, (2, H, W)).astype(np.float32)
    normal = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    conf = rng.uniform(0, 1, (2, H, W)).astype(np.float32)
    image = np.stack([img, frames[1].astype(np.float32) / 255.0])
    res = {}
    for dev in ("cuda", "cpu"):
        t = {k: torch.tensor(v, device=dev) for k, v in dict(
            depth=depth, normal=normal, image=image, conf=conf,
            img=img).items()}
        res[dev] = dict(
            tv=tv_loss(t["depth"], t["normal"], t["image"], t["conf"]),
            sobel=sobel_edges(t["img"]), blur=gaussian_blur(t["img"], 5,
                                                            1.0))
    out = {}
    for k in ("sobel", "blur"):
        out[k] = _within(k, res["cuda"][k], res["cpu"][k], 1e-6, 0)
    out["tv loss"] = _within("tv_loss", res["cuda"]["tv"][0],
                             res["cpu"]["tv"][0], 1e-6, 0)
    out["tv weights"] = _within("tv weights", res["cuda"]["tv"][1],
                                res["cpu"]["tv"][1], 1e-6, 0)
    from scipy.spatial.transform import Rotation
    R = Rotation.random(random_state=31).as_matrix().astype(np.float32)
    pm2 = rng.normal(size=(1, H, W, 3)).astype(np.float32)
    pm1 = (1.3 * pm2.reshape(-1, 3) @ R.T + np.float32([0.2, -0.1, 0.4]))
    pm1 = pm1.reshape(pm2.shape).astype(np.float32)
    c = rng.uniform(0, 2, (1, H, W)).astype(np.float32)
    bad = H // 10                 # a tenth of the rows are outliers
    pm1[:, :bad] += rng.normal(scale=2.0, size=pm1[:, :bad].shape).astype(
        np.float32)
    def align(dev):
        args = [torch.tensor(a, device=dev) for a in (pm1, c, pm2, c)]
        return weighted_align_point_maps(*args, 0.5, delta=0.1,
                                         max_iters=20)

    align("cuda")
    sim_card, secs = synced_s(lambda: align("cuda"))
    sim_cpu = align("cpu")
    for name, i, atol in (("s", 0, 1e-5), ("R", 1, 1e-4), ("t", 2, 1e-4)):
        out[f"sim3 {name}"] = _within(f"robust Sim(3) {name}", sim_card[i],
                                      sim_cpu[i], atol, 0)
    if abs(float(sim_card[0]) - 1.3) > 0.02:
        fail(f"phase 12: robust Sim(3) scale {float(sim_card[0])}")
    sim_ms = 1e3 * secs
    log(f"[shared] card vs CPU at {H}x{W}, max err / max |cpu|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in out.items())
        + f"; robust Sim(3) over {H * W} points {sim_ms:.1f} ms | {card}")


def _http(port, path):
    import urllib.request
    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        body = r.read()
        return r.status, r.headers.get("Content-Type"), body, \
            time.perf_counter() - t0


def _png(body):
    import cv2
    return cv2.imdecode(np.frombuffer(body, np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1]


def viewer_phase(G, card, frames, K4):
    """(c) SLAMSystem with ``GUI: {active: true, port: 0}`` over phase 6's
    first 8 frames, a keyframe each (full-width CUT3R, phase 6's mapping
    cuts). A client
    thread requests /api/state, /api/splats and /api/render while run()
    maps, and again after it. Fails unless every response is 200 (the
    render once a mapper exists), the splat count equals the arena's
    alive count, the render PNG equals render_view of the same pose
    within one 8-bit level and K1 launches inside the render requests.
    Returns the kernels' launches inside those requests."""
    import threading
    import torch
    from cut3r_slam_tpu_torch import full_f32
    from cut3r_slam_tpu_torch.slam.renderer import render_view
    from cut3r_slam_tpu_torch.slam.system import SLAMSystem
    from cut3r_slam_tpu_torch.utils.config import DEFAULT_CONFIG
    H, W = frames[0].shape[:2]
    model = plausible_random_cut3r(seed=0)
    cfg = json.loads(json.dumps(DEFAULT_CONFIG))
    # a keyframe per frame: the first mapping event within the 8 frames
    cfg["Tracking"]["motion_filter"]["kf_every"] = 1
    cfg["Mapping"].update(SLICE_MAPPING_CUTS)
    cfg["GUI"] = {"active": True, "port": 0}
    out_dir = _scratch("chip_smoke_viewer_")
    slam = SLAMSystem(model, cfg, buffer=64, img_hw=(H, W),
                      output_dir=out_dir, device="cuda")
    port = slam.viewer.port
    eye = ",".join(str(float(v)) for v in np.eye(4).ravel())
    stop = threading.Event()
    during = {"state": 0, "splats": 0, "render": 0, "bad": []}

    def client():
        while not stop.is_set():
            try:
                for path in ("/api/state", "/api/splats") + (
                        (f"/api/render?w2c={eye}",)
                        if slam.mapper is not None else ()):
                    status, _, body, _ = _http(port, path)
                    key = path.split("?")[0].rsplit("/", 1)[-1]
                    if status != 200 or not body:
                        during["bad"].append((path, status))
                    during[key] += 1
            except Exception as e:
                during["bad"].append(repr(e))
                return
            time.sleep(0.05)

    th = threading.Thread(target=client)
    th.start()
    events = 0
    t0 = time.perf_counter()
    try:
        for t, img in enumerate(frames[:VIEWER_FRAMES]):
            _, viz = slam.run(t, img, K4, img_map=img, K4_map=K4,
                              last=(t == VIEWER_FRAMES - 1))
            events += viz is not None
    finally:
        stop.set()
        th.join(timeout=300)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if during["bad"]:
        fail(f"phase 12: viewer responses during run(): {during['bad'][:5]}")
    if events < 1 or slam.mapper is None or during["render"] < 1:
        fail(f"phase 12: no render request during mapping ({events} events, "
             f"{during})")
    m = slam.mapper
    kf = slam.keyframes
    # after run(): state, splats, then renders of the last keyframe's view
    status, _, body, _ = _http(port, "/api/state")
    st = json.loads(body)
    alive = int(m.arena.alive.sum())
    if status != 200 or st["n_kf"] != kf.count or st["n_alive"] != alive:
        fail(f"phase 12: /api/state {status} {st['n_kf']} keyframes, "
             f"{st['n_alive']} alive (system: {kf.count}, {alive})")
    sp = [_http(port, "/api/splats") for _ in range(3)]
    (n_splats,) = np.frombuffer(sp[-1][2][:4], "<u4")
    if any(s[0] != 200 for s in sp) or n_splats != alive or \
            len(sp[-1][2]) != 4 + 20 * alive:
        fail(f"phase 12: /api/splats gave {n_splats} splats, "
             f"{len(sp[-1][2])} bytes; the arena holds {alive}")
    c2w = np.eye(4, dtype=np.float32)
    from scipy.spatial.transform import Rotation
    pose = kf.pose[kf.count - 1]
    c2w[:3, :3] = Rotation.from_quat(pose[3:7]).as_matrix()
    c2w[:3, 3] = pose[:3]
    w2c = np.linalg.inv(c2w).astype(np.float32)
    q = ",".join(repr(float(v)) for v in w2c.ravel())
    _http(port, f"/api/render?w2c={q}")          # warm
    for k in G.LAUNCHES:
        G.LAUNCHES[k] = 0
    rs = [_http(port, f"/api/render?w2c={q}") for _ in range(5)]
    launches = dict(G.LAUNCHES)
    if any(r[0] != 200 or r[1] != "image/png" for r in rs):
        fail(f"phase 12: /api/render answered {[r[:2] for r in rs]}")
    if launches["gs_blend_fwd"] <= 0 or launches["gs_blend_bwd"] != 0 \
            or launches["gs_pack_bwd"] != 0:
        fail(f"phase 12: launches inside /api/render: {launches}")
    got = _png(rs[-1][2]).astype(int)

    def reference():
        with torch.no_grad(), full_f32():
            arena_b, _ = m._sliced()
            out = render_view(arena_b.params(), arena_b.alive,
                              torch.tensor(w2c, device="cuda"), m.K4,
                              m.raster_cfg)
            return (torch.clamp(out["color"], 0.0, 1.0).cpu().numpy()
                    * 255).astype(np.uint8)

    ref_s = [synced_s(reference)[1] for _ in range(3)]
    ref = reference()
    from cut3r_slam_tpu_torch.gui.server import _encode_png
    png_s = [synced_s(lambda: _encode_png(ref))[1] for _ in range(3)]
    ref = ref.astype(int)
    diff = int(np.abs(got - ref).max()) if got.shape == ref.shape else -1
    if not 0 <= diff <= 1 or ref.max() == 0:
        fail(f"phase 12: the /api/render PNG differs from render_view by "
             f"{diff} levels (shapes {got.shape} / {ref.shape})")
    slam.viewer.stop()
    render_ms = 1e3 * np.mean([r[3] for r in rs])
    splat_ms = 1e3 * np.mean([s[3] for s in sp])
    log(f"[viewer] {VIEWER_FRAMES} frames, {kf.count} keyframes, {events} "
        f"mapping events in {run_s:.1f} s; during run(): {during['state']} "
        f"state, {during['splats']} splats and {during['render']} render "
        f"responses, all 200 | {card}")
    log(f"[viewer] after run(): /api/render {render_ms:.1f} ms at "
        f"{m.cfg.height}x{m.cfg.width} (mean of 5, HTTP + render + PNG), "
        f"PNG equal to render_view within {diff} level(s); of which the "
        f"render to host {1e3 * np.mean(ref_s):.1f} ms, the PNG encode "
        f"{1e3 * np.mean(png_s):.1f} ms; /api/splats "
        f"{splat_ms:.1f} ms for {len(sp[-1][2])} bytes ({alive} splats); "
        f"launches inside the render requests {launches} | {card}")
    del slam, model, m
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches


def droid_viewer_phase(G, card, frames, K4):
    """Phase 12 (see the module docstring). Returns the kernels' launches
    of the DROID part and inside the viewer's render requests."""
    import torch
    t0 = time.perf_counter()
    droid = droid_phase(G, card, frames)
    gc.collect()
    torch.cuda.empty_cache()
    shared_math_card_vs_cpu(card, frames)
    viewer = viewer_phase(G, card, frames, K4)
    log(f"[phase 12] in {time.perf_counter() - t0:.1f} s")
    return droid, viewer


# ---------------------------------------------------------------------------
# phase 13: view-parallel mapping, data-parallel / FSDP training and sharded
# inference over torch.distributed, two ranks on the one card
# ---------------------------------------------------------------------------

VP_WORLD = 2
VP_TIMEOUT_S = 60.0          # a collective waiting longer raises
VP_FRAMES = 8                # (b): phase 6's first frames
VP_WINDOW_ITERS = 10         # (a): window iterations with pose
VP_GBA_K = 4                 # (a): views a global-BA step, one segment
# of 3 steps, as the JAX suite's parallel global-BA case (k 4, segment 3):
# over phase 6's 50-step segment the one-rank run's own Adam steps drift
# with the order of the sum (280 of 393,216 f_dc elements beyond the
# JAX tolerance, 0.85 lr at most, against two ranks on an H100 80GB HBM3)
VP_GBA_SEGMENT = 3
VP_REFINE_VIEWS = 5          # (a): views of one batched refinement
# (a) against the sequential run: the JAX suite's tolerances
# (tests/test_parallel_mapping.py:84-97)
VP_LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
VP_ARENA_TOL = dict(rtol=2e-3, atol=2e-5)
VP_W2C_TOL = dict(rtol=1e-4, atol=1e-5)
# (b) runs the mapping counts of tests/test_torch_parallel_slam.py (CFG,
# MAP_EXTRA): at phase 6's counts the one-rank run's own keyframe poses
# move by ~5e-3 when only its float summation order changes
# (scripts/slam_order_sensitivity.py), so no bound could tell a fault
# from rounding there
VP_SLAM_MAPPING = {"iterations": 4, "window_opt_iters": 2,
                   "new_view_opt_iters": 2, "gba_per_view": 0,
                   "gba_views_per_iter": 2}
VP_SLAM_MAP_EXTRA = {"pose_refine_iters": 2, "opt_segment": 2,
                     "gba_segment": 4}
VP_SLAM_FINALIZE = 2
# largest keyframe-pose entry difference of (b) from the one-rank run: two
# Adam steps of a pose's translation (2 x 10 x pose_lr = 6e-3). The one-rank
# run on the card repeats itself bitwise, but the split over ranks
# reorders float sums, and at 384x512 some pose-gradient entries lie at
# the rounding floor: Adam's first step moves such an entry by a full
# learning rate of either sign (two ranks moved translations by up to
# 3.8e-3 and rotations by up to 5.2e-4 at these counts on an H100 80GB
# HBM3; the CPU test at 32x48 measures 9.7e-8 and holds 1e-5)
VP_POSE_BOUND = 2 * 10 * 0.0003
# (d): the f32 forwards against the single forward, max |err| / max |ref|
# per output within phase 11(b)'s bound for a full-width f32 network summed
# in another order (Omnidata through 16 bottlenecks and 12 ViT blocks:
# 5e-4); element by element the JAX suite's tiny-model tolerance (rtol
# 2e-3, atol 2e-4) missed on 2 of 2.36 M pointmap coordinates near zero
# (2.6e-4 absolute), where a coordinate carries its point's error
VP_FWD_REL = 5e-4
# FSDP2's collectives (all_gather_into_tensor, reduce_scatter_tensor) and
# the DTensor ones of tensor parallelism run over gloo on CUDA tensors on
# the H100's torch 2.11 (scripts/probe_gloo_cuda.py), so (c) and (d) run
# at world size 2 over gloo like (a) and (b); NCCL, which refuses two
# ranks on one card, runs at world size 1 in (e)
VP_BACKEND = "gloo"
# (c)'s full-width step: both ranks hold the unsharded model, its gradients
# and their activations on the one card (at phase 9's 384x512 the two
# ranks together ran out of its 80 GB), so the step runs at CUT3R's 224
# training resolution
VP_TRAIN_HW = (224, 224)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _vp_sync(dev):
    import torch
    if dev == "cuda":
        torch.cuda.synchronize()


def _vp_snapshot(be):
    import copy
    return copy.deepcopy((be.arena, be.cams, be.adam, be.current_window,
                          be.initialized))


def _vp_restore(be, snap):
    import copy
    import torch
    (be.arena, be.cams, be.adam, be.current_window,
     be.initialized) = copy.deepcopy(snap)
    be.gen = torch.Generator().manual_seed(be.rng_seed)


def _vp_mapping(G, spec, mesh):
    """(a) on one backend loaded from phase 6's state (``mesh`` None: the
    sequential path): the window optimization, one global-BA segment and
    one batched refinement, each from the loaded state. Returns per run
    the loss, arena, camera rows, K1 / K2 launches and ms an iteration."""
    import torch
    from cut3r_slam_tpu_torch.slam.mapping import MappingBackend, \
        MappingConfig
    dev = spec["device"]
    be = MappingBackend(MappingConfig(**spec["map_cfg"]), spec["K4_map"],
                        device=dev, mesh=mesh)
    be.load(spec["mapper"])
    snap = _vp_snapshot(be)
    window, refine = spec["window"], spec["refine"]
    runs = {
        "window": (VP_WINDOW_ITERS,
                   lambda: be.optimization(VP_WINDOW_ITERS, window)),
        "gba": (be.cfg.gba_segment, lambda: be.global_ba(
            VP_GBA_K * be.cfg.gba_segment, densify=False)),
        "refine": (be.cfg.pose_refine_iters,
                   lambda: be.pose_refine_multi(refine))}
    out = {}
    for name, (iters, fn) in runs.items():
        _vp_restore(be, snap)
        for k in G.LAUNCHES:
            G.LAUNCHES[k] = 0
        _vp_sync(dev)
        t0 = time.perf_counter()
        r = fn()
        _vp_sync(dev)
        ms = 1e3 * (time.perf_counter() - t0) / iters
        views = window if name == "window" else (
            refine if name == "refine" else
            [i for i in range(be.cfg.cam_capacity) if bool(be.cams.valid[i])])
        res = {"ms_per_iter": ms, "launches": dict(G.LAUNCHES),
               "w2c": be.cams.w2c[views].cpu(),
               "arena": {k: v.detach().cpu().clone()
                         for k, v in be.arena.params().items()}}
        if name == "window":
            res["loss"] = float(r)
        if name == "refine":
            res["pm"], res["val"] = r[0].cpu(), r[1].cpu()
        out[name] = res
    return out


def _vp_slam(G, spec, view_parallel):
    """(b) ``SLAMSystem.run`` over phase 6's first frames with phase 6's
    mapping cuts, then ``terminate``; ``view_parallel`` 0 is the one-rank
    run. Returns the decisions, the keyframe poses, the arena, K1 / K2
    launches over ``run`` and frames/s."""
    import torch
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu_torch.slam.system import SLAMSystem
    dev = spec["device"]
    model = CUT3R(spec.get("cut3r", CUT3RConfig()), device=dev)
    model.load_state_dict(torch.load(spec["model"], map_location=dev))
    cfg = json.loads(json.dumps(spec["slam_cfg"]))
    cfg["Mapping"].update(VP_SLAM_MAPPING, view_parallel=view_parallel)
    cfg["opt_params"] = {"position_lr_max_steps": VP_SLAM_FINALIZE}
    # a keyframe each (as phase 12(c)): the first mapping event falls
    # inside the first 8 frames
    cfg["Tracking"]["motion_filter"]["kf_every"] = 1
    H, W = spec["hw"]
    slam = SLAMSystem(model.eval(), cfg, buffer=64, img_hw=(H, W),
                      output_dir=os.path.join(spec["out"],
                                              f"slam_vp{view_parallel}"),
                      device=dev)
    slam._map_cfg_extra.update(VP_SLAM_MAP_EXTRA)
    frames = synth_frames(24, H, W)[:spec["frames"]]
    K4 = np.asarray(spec["K4"], np.float32)
    for k in G.LAUNCHES:
        G.LAUNCHES[k] = 0
    _vp_sync(dev)
    t0 = time.perf_counter()
    events = []
    for t, img in enumerate(frames):
        _, viz = slam.run(t, img, K4, img_map=img, K4_map=K4,
                          last=(t == len(frames) - 1))
        if viz is not None:
            events.append(list(viz))
    _vp_sync(dev)
    run_s = time.perf_counter() - t0
    launches = dict(G.LAUNCHES)
    slam.terminate(len(frames) - 1)
    kf, m = slam.keyframes, slam.mapper
    return {"events": events, "tstamp": kf.tstamp[:kf.count].copy(),
            "pose": kf.pose[:kf.count].copy(),
            "arena": {k: v.detach().cpu().clone()
                      for k, v in m.arena.params().items()},
            "alive": m.arena.alive.cpu().clone(), "launches": launches,
            "fps": len(frames) / run_s}


def _vp_tiny_batch(root):
    """One global batch of B=2, V=2 at 32x48 whose two samples have
    different valid counts (the second loses 8 rows)."""
    from cut3r_slam_tpu_torch.datasets import (
        MultiViewDataset, SceneFolderSource, SceneLayout, make_batch_iter,
        generate_multiview_scenes)
    generate_multiview_scenes(root, n_scenes=1, views_per_scene=8,
                              hw=(32, 48), seed=0)
    b = next(make_batch_iter(MultiViewDataset(
        SceneFolderSource(root, SceneLayout("synth")), num_views=2, span=6,
        resolution=(32, 48), seed=0), 2, 0))
    b["valid_mask"][:, 1, :8] = False
    return b


def _vp_train(spec, rank):
    """(c) one ``train`` step at dp 2 and at fsdp 2 of the tiny CUT3R with
    the linear head, on the CPU and on the card (f32, no TF32), then one
    full-width ``make_train_step`` at V=4 under fsdp 2 on the card.
    Returns the tiny runs' logs and checkpoints and the full step's
    seconds, setup seconds, loss and peak memory."""
    import dataclasses
    import torch
    from cut3r_slam_tpu_torch import full_f32
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu_torch.train.train_step import (
        init_trainable, make_optimizer, make_train_step)
    from cut3r_slam_tpu_torch.train.trainer import (TrainerConfig,
                                                    distribute, train)
    root = os.path.join(spec["out"], "train")
    batch = _vp_tiny_batch(os.path.join(root, f"scenes{rank}"))
    tiny = dataclasses.replace(CUT3RConfig.tiny(), head_type="linear")
    init = CUT3R(tiny, device="cpu")
    init.init_random(torch.Generator().manual_seed(1))
    out = {"tiny": {}, "names": [n for n, _ in init.named_parameters()]}
    init = {k: v.clone() for k, v in init.state_dict().items()}
    for dev in ("cpu", spec["device"]):
        for name, fsdp in (("dp2", 1), ("fsdp2", 2)):
            logs = []
            ckpt = os.path.join(root, f"{dev}_{name}")
            t0 = time.perf_counter()
            with full_f32():
                train(CUT3R(tiny, device=dev), iter([batch]), TrainerConfig(
                    lr=1e-4, weight_decay=0.05, warmup_steps=0,
                    total_steps=1, log_every=1, ckpt_dir=ckpt, fsdp=fsdp),
                    init_params=init, log_fn=logs.append, device=dev)
            out["tiny"][(dev, name)] = (logs, os.path.join(ckpt,
                                                           "step_1.pt"))
            out.setdefault("tiny_seconds", {})[(dev, name)] = \
                time.perf_counter() - t0
    if spec["device"] != "cuda":
        return out
    # one full-width step at V=4, the parameters sharded over fsdp 2 (the
    # package's training init from seed 0)
    dirs = training_scenes(os.path.join(root, f"full{rank}"), VP_TRAIN_HW,
                           1, seed=0)
    b4 = next(training_batches(dirs, VP_TRAIN_HW, 4, seed=0))
    t0 = time.perf_counter()
    model = CUT3R(CUT3RConfig(), device="cuda")
    init_trainable(model, torch.Generator(device="cuda").manual_seed(0))
    distribute(model, 2, "cuda")
    t_setup = time.perf_counter() - t0
    opt = make_optimizer(model.parameters(), lr=1e-4, weight_decay=0.05,
                         warmup_steps=0, total_steps=10)
    step = make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(step(b4)["total"])
    torch.cuda.synchronize()
    out["full"] = {"seconds": time.perf_counter() - t0, "loss": loss,
                   "setup": t_setup,
                   "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def _vp_infer(spec, rank):
    """(d) the batch-sharded (B=2 over dp 2) and tensor-parallel (tp 2)
    forwards of the full-width CUT3R, in f32, against its single forward
    on the same images (held to VP_FWD_REL). Returns (max |err| / max
    |ref| per kind and output, seconds of each sharded forward, its setup
    included)."""
    import dataclasses
    import torch
    from cut3r_slam_tpu_torch import full_f32
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu_torch.parallel import make_mesh
    from cut3r_slam_tpu_torch.parallel.inference import (
        make_sharded_forward, make_tp_sharded_forward)
    dev = spec["device"]
    H, W = spec["hw"]
    imgs = (torch.rand(2, 2, H, W, 3, generator=torch.Generator()
                       .manual_seed(7)) * 2 - 1).to(dev)
    cfg = dataclasses.replace(spec.get("cut3r", CUT3RConfig()),
                              compute_dtype=torch.float32)
    m = CUT3R(cfg, device=dev)
    m.load_state_dict(torch.load(spec["model"], map_location=dev))
    m.eval()
    out, secs = {}, {}
    with torch.no_grad(), full_f32():
        ref = m(imgs)
        t0 = time.perf_counter()
        dp = make_sharded_forward(m, make_mesh(VP_WORLD, axes=("dp",),
                                               device_type=dev))(imgs)
        secs["dp"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the same weights, now Megatron-split in place
        tp = make_tp_sharded_forward(m, make_mesh(
            VP_WORLD, axes=("dp", "tp"), shape=(1, VP_WORLD),
            device_type=dev))(imgs)
        secs["tp"] = time.perf_counter() - t0
    for kind, got in (("dp", dp), ("tp", tp)):
        for k, r in ref.items():
            rel = float((got[k].float() - r.float()).abs().max()) / max(
                float(r.abs().max()), 1e-12)
            if not rel <= VP_FWD_REL:
                raise AssertionError(f"phase 13: {kind} forward {k}: max "
                                     f"err / max {rel:.3e}")
            out[(kind, k)] = rel
    return out, secs


def _vp_rank(rank, spec):
    """One rank of phase 13: (a)-(d), its results saved under
    ``spec["out"]``; any failure ends the process with an error, which
    fails the parent."""
    import faulthandler
    # two ranks share the card: each hands back what a stage freed
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist
    from cut3r_slam_tpu_torch.ops import gs_raster_cuda as G
    from cut3r_slam_tpu_torch.parallel import init_distributed, make_mesh
    faulthandler.enable()     # a rank dying in native code prints its stack
    torch.set_num_threads(4)
    init_distributed(backend=VP_BACKEND, timeout_s=VP_TIMEOUT_S,
                     init_method=f"tcp://localhost:{spec['port']}",
                     rank=rank, world_size=VP_WORLD)

    def stage(name, fn, *a):
        t = time.perf_counter()
        r = fn(*a)
        gc.collect()
        if spec["device"] == "cuda":
            torch.cuda.empty_cache()
        log(f"[vp] rank {rank}: {name} in {time.perf_counter() - t:.1f} s")
        return r
    try:
        t0 = time.perf_counter()
        mesh = make_mesh(VP_WORLD, axes=("mv",), device_type=spec["device"])
        out = {"mapping": stage("(a)", _vp_mapping, G, spec, mesh)}
        out["slam"] = stage("(b)", _vp_slam, G, spec, VP_WORLD)
        out["train"] = stage("(c)", _vp_train, spec, rank)
        out["infer"] = stage("(d)", _vp_infer, spec, rank)
        out["seconds"] = time.perf_counter() - t0
        torch.save(out, os.path.join(spec["out"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _vp_close_arena(what, got, ref, lr):
    """An arena parameter at the JAX suite's tolerance (VP_ARENA_TOL) on
    all but at most 1e-4 of its elements, those within two Adam steps (2
    lr): as phase 9 holds parameters, because Adam divides each gradient
    element by its own magnitude, so an element whose gradient lies at the
    rounding floor moves by a different fraction of a step when the sum
    over views is reordered. Returns (elements beyond the tolerance, max
    |diff| / lr)."""
    got, ref = got.numpy(), ref.numpy()
    bad = ~np.isclose(got, ref, **VP_ARENA_TOL)
    steps = float(np.abs(got - ref).max()) / lr
    if bad.sum() > 1e-4 * bad.size or steps > 2.0:
        fail(f"phase 13: {what}: {int(bad.sum())} of {bad.size} elements "
             f"beyond rtol {VP_ARENA_TOL['rtol']} / atol "
             f"{VP_ARENA_TOL['atol']}, max |diff| {steps:.3f} lr")
    return int(bad.sum()), steps


def _vp_close(what, got, ref, tol):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    ref = ref.numpy() if hasattr(ref, "numpy") else np.asarray(ref)
    bad = ~np.isclose(got, ref, **tol)
    if bad.any():
        fail(f"phase 13: {what}: {int(bad.sum())} of {bad.size} elements "
             f"beyond rtol {tol['rtol']} / atol {tol['atol']} (max |diff| "
             f"{float(np.abs(got - ref).max()):.3e})")
    return float(np.abs(got - ref).max())


def _vp_nccl_world1(spec, card):
    """(e) NCCL at world size 1: one all_reduce of a window iteration's
    Gaussian-gradient buffer through the view-parallel reducer."""
    import torch
    import torch.distributed as dist
    from cut3r_slam_tpu_torch.parallel import init_distributed, make_mesh
    from cut3r_slam_tpu_torch.parallel.mapping import ViewShards
    init_distributed(backend="nccl", timeout_s=VP_TIMEOUT_S,
                     init_method=f"tcp://localhost:{_free_port()}", rank=0,
                     world_size=1)
    try:
        sh = ViewShards(make_mesh(1, axes=("mv",)))
        n = spec["map_cfg"]["capacity"]
        g = torch.Generator(device="cuda").manual_seed(0)
        grads = [torch.randn(n, *s, generator=g, device="cuda")
                 for s in ((3,), (3,), (), (3,), (4,))]
        red = sh.all_reduce(grads + [torch.ones((), device="cuda")] * 2)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(grads, red))
        ms = cuda_ms(lambda: sh.all_reduce(grads), 10)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    if not same:
        fail("phase 13: NCCL all_reduce at world size 1 changed the buffer")
    return backend, sum(x.numel() for x in grads), ms


def view_parallel_phase(G, card, spec):
    """Phase 13 (see the module docstring). ``spec``: phase 6's mapper
    state and settings (``vp_spec``). Returns rank 0's K1 / K2 launches
    over (b)'s ``run``."""
    import torch
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    dev = spec["device"]
    model = plausible_random_cut3r(seed=0, config=spec.get("cut3r"),
                                   device=dev)
    torch.save(model.state_dict(), spec["model"])
    del model
    # the one-rank references, the card to themselves
    seq_map = _vp_mapping(G, spec, None)
    seq_slam = _vp_slam(G, spec, 0)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    log(f"[vp] one-rank references in {time.perf_counter() - t_phase:.1f} "
        f"s; {VP_BACKEND} ranks start")
    t0 = time.perf_counter()
    ctx = mp.spawn(_vp_rank, args=(dict(spec, port=_free_port()),),
                   nprocs=VP_WORLD, join=False)
    try:
        while not ctx.join():
            pass
    except Exception as e:    # a rank failed: the phase fails
        fail(f"phase 13: a rank failed: {e}")
    ranks = [torch.load(os.path.join(spec["out"], f"rank{r}.pt"),
                        weights_only=False) for r in range(VP_WORLD)]
    log(f"[vp] ranks done in {time.perf_counter() - t0:.1f} s (rank work "
        f"{ranks[0]['seconds']:.1f} / {ranks[1]['seconds']:.1f} s)")

    # (a) mapping, each rank against the one-rank run, ranks bitwise equal
    mc = spec["map_cfg"]
    lrs = {"xyz": mc["position_lr"], "f_dc": mc["feature_lr"],
           "opacity_logit": mc["opacity_lr"], "log_scales": mc["scaling_lr"],
           "quat": mc["rotation_lr"]}
    for name in ("window", "gba", "refine"):
        s, r0, r1 = (x[name] for x in (seq_map, ranks[0]["mapping"],
                                       ranks[1]["mapping"]))
        outside, steps = 0, 0.0
        for k, v in r0["arena"].items():
            if not torch.equal(v, r1["arena"][k]):
                fail(f"phase 13: {name}: the ranks' arena {k} differs")
            o, st = _vp_close_arena(f"{name} arena {k}", v, s["arena"][k],
                                    lrs[k])
            outside, steps = outside + o, max(steps, st)
        w2c = _vp_close(f"{name} w2c", r0["w2c"], s["w2c"], VP_W2C_TOL)
        extra = ""
        if name == "window":
            _vp_close("window loss", r0["loss"], s["loss"], VP_LOSS_TOL)
            extra = f", loss {r0['loss']:.6f} vs {s['loss']:.6f}"
        if name == "refine":
            _vp_close("refine pointmaps", r0["pm"], s["pm"],
                      dict(rtol=1e-4, atol=1e-4))
            if not torch.equal(r0["val"], s["val"]):
                fail("phase 13: refine validity masks differ")
        log(f"[vp] (a) {name}: ms an iteration one rank "
            f"{s['ms_per_iter']:.2f}, two ranks {r0['ms_per_iter']:.2f} / "
            f"{r1['ms_per_iter']:.2f}; K1/K2 one rank "
            f"{s['launches']['gs_blend_fwd']}/{s['launches']['gs_blend_bwd']}"
            f", per rank {r0['launches']['gs_blend_fwd']}/"
            f"{r0['launches']['gs_blend_bwd']} and "
            f"{r1['launches']['gs_blend_fwd']}/"
            f"{r1['launches']['gs_blend_bwd']}; max |w2c diff| {w2c:.2e}"
            f"{extra}; arena elements beyond the JAX tolerance {outside}, "
            f"max |diff| {steps:.4f} lr | {card}")
    # (b) the whole system
    b0, b1 = ranks[0]["slam"], ranks[1]["slam"]
    if not (b0["events"] == b1["events"] == seq_slam["events"]) \
            or not np.array_equal(b0["tstamp"], seq_slam["tstamp"]) \
            or not np.array_equal(b1["tstamp"], seq_slam["tstamp"]):
        fail(f"phase 13: keyframe decisions differ: {b0['events']} / "
             f"{b1['events']} vs one rank {seq_slam['events']}")
    if not b0["events"]:
        fail("phase 13: no mapping event ran in (b)")
    if not np.array_equal(b0["pose"], b1["pose"]) \
            or not torch.equal(b0["alive"], b1["alive"]) \
            or not all(torch.equal(v, b1["arena"][k])
                       for k, v in b0["arena"].items()):
        fail("phase 13: the ranks' keyframe poses or arenas differ")
    pose_err = float(np.abs(b0["pose"] - seq_slam["pose"]).max())
    if not pose_err <= VP_POSE_BOUND:
        fail(f"phase 13: keyframe poses {pose_err:.3e} from the one-rank "
             f"run (bound {VP_POSE_BOUND:.1e})")
    for r, b in enumerate((b0, b1)):
        if min(b["launches"].values()) <= 0:
            fail(f"phase 13: rank {r} launched no kernel in run(): "
                 f"{b['launches']}")
    log(f"[vp] (b) SLAMSystem.run, view_parallel 2, {spec['frames']} "
        f"frames: events {b0['events']}, {len(b0['tstamp'])} keyframes as "
        f"one rank; max |pose diff| {pose_err:.3e} (bound "
        f"{VP_POSE_BOUND:.1e}); "
        f"frames/s one rank {seq_slam['fps']:.3f}, two ranks "
        f"{b0['fps']:.3f} / {b1['fps']:.3f}; K1/K2 in run() one rank "
        f"{seq_slam['launches']}, rank 0 {b0['launches']}, rank 1 "
        f"{b1['launches']} | {card}")
    # (c) training: the card's world-2 steps against the CPU's
    tiny = ranks[0]["train"]["tiny"]
    names = ranks[0]["train"]["names"]
    worst = {}
    for name in ("dp2", "fsdp2"):
        (lc, pc), (lg, pg) = tiny[("cpu", name)], tiny[(dev, name)]
        a, b = lg[0]["loss"], lc[0]["loss"]
        if not abs(a - b) <= 1e-5 * abs(b) + 5e-6:
            fail(f"phase 13: {name} loss card {a} vs cpu {b}")
        sc = torch.load(pc, map_location="cpu", weights_only=False)
        sg = torch.load(pg, map_location="cpu", weights_only=False)
        mu = [{names[i]: st["mu"] for i, st in s_["opt_state"]["state"]
               .items()} for s_ in (sc, sg)]
        worst[name] = (grads_agree(mu[0], mu[1], f"phase 13: {name}"),
                       params_agree(sc["params"], sg["params"], [1e-4],
                                    f"phase 13: {name}")[0])
    full = ranks[0]["train"].get("full")
    if full is not None and not np.isfinite(full["loss"]):
        fail(f"phase 13: full-width fsdp loss {full['loss']}")
    log(f"[vp] (c) tiny train() steps at world 2 over {VP_BACKEND} ("
        + ", ".join(f"{d} {n} {t:.1f} s" for (d, n), t in
                    ranks[0]["train"]["tiny_seconds"].items())
        + "), card vs cpu: dp2 / fsdp2 gradient (Adam first moment) worst "
        f"{worst['dp2'][0]:.2e} / {worst['fsdp2'][0]:.2e} of norm + floor, "
        f"params max {worst['dp2'][1]:.2e} / {worst['fsdp2'][1]:.2e}"
        + ("" if full is None else
           f"; full width V=4 {VP_TRAIN_HW[0]}x{VP_TRAIN_HW[1]} "
           f"make_train_step under fsdp 2: {full['seconds']:.3f} s (a "
           f"first step; setup with the weights' broadcast "
           f"{full['setup']:.1f} s), loss {full['loss']:.4f}, peak "
           f"{full['peak_gb']:.2f} GiB a rank")
        + f" | {card}")
    # (d) inference
    inf, secs = ranks[0]["infer"]
    worst = {kind: max(v for k, v in inf.items() if k[0] == kind)
             for kind in ("dp", "tp")}
    log(f"[vp] (d) full-width f32 forward, V=2 B=2 at {spec['hw'][0]}x"
        f"{spec['hw'][1]}, max err / max of any output vs the single "
        f"forward (bound {VP_FWD_REL}): dp {worst['dp']:.2e}, tp "
        f"{worst['tp']:.2e}; {secs['dp']:.2f} / {secs['tp']:.2f} s with "
        f"their setup (the weights' broadcast, the tp split) | {card}")
    # (e) the production backend on the card
    if dev == "cuda":
        backend, n, ms = _vp_nccl_world1(spec, card)
        log(f"[vp] (e) {backend} at world size 1: all_reduce of a "
            f"{n}-float mapping-gradient buffer {ms:.3f} ms | {card}")
    shutil.rmtree(spec["out"], ignore_errors=True)
    log(f"[vp] phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return b0["launches"]


def vp_spec(slam, slam_cfg, frames_hw, K4, device="cuda"):
    """Phase 13's inputs from phase 6's system: its mapper's state saved
    once (``MappingBackend.save``), its mapping settings with 4-view
    global-BA steps, the window, 5 views to refine and the live loop's
    settings."""
    import dataclasses
    m = slam.mapper
    out = _scratch("chip_smoke_vp_")
    m.save(os.path.join(out, "mapper.npz"))
    valid = [i for i in range(m.cfg.cam_capacity) if bool(m.cams.valid[i])]
    return {"device": device, "out": out,
            "mapper": os.path.join(out, "mapper.npz"),
            "model": os.path.join(out, "cut3r.pt"),
            "map_cfg": dict(dataclasses.asdict(m.cfg),
                            gba_views_per_iter=VP_GBA_K,
                            gba_segment=VP_GBA_SEGMENT),
            "K4_map": m.K4.cpu().numpy(), "window": list(m.current_window),
            "refine": valid[:VP_REFINE_VIEWS], "slam_cfg": slam_cfg,
            "hw": frames_hw, "K4": np.asarray(K4, np.float32).tolist(),
            "frames": VP_FRAMES}


# ---------------------------------------------------------------------------
# phase 14: the benchmark driver
# ---------------------------------------------------------------------------

BENCH_FRAMES = 16   # cut from 40: the first mapping event starts at frame 12


@contextlib.contextmanager
def plain_blend(G):
    """K1 / K2's plain versions in place of the kernels for CUDA tensors
    inside the block (the launch counts do not move)."""
    saved = G.blend_forward, G.blend_backward
    G.blend_forward = lambda A, ext, with_residuals=False: \
        G.blend_forward_plain(A, ext, with_residuals)
    G.blend_backward = lambda A, ext, tchk, tleft, *cots: \
        G.blend_backward_plain(A, ext, *cots)
    try:
        yield
    finally:
        G.blend_forward, G.blend_backward = saved


def micro_vs_plain(G, bench, H, W, n):
    """The micro-bench's colour and its gradient with cached bins on its
    arena, kernels against plain versions: (K1's largest colour error,
    the largest fraction of colour elements off, K2's per-channel max
    |err| / max |ref| of the packed cotangent, the gradients' max |err| /
    max |ref| per parameter)."""
    import torch
    from cut3r_slam_tpu_torch.slam.renderer import bin_view, render_view
    params, alive, w2c, K4, rcfg = bench.micro_scene(H, W, n, "cuda")
    bins = bin_view(params, alive, w2c, K4, rcfg)
    with torch.no_grad():
        color = render_view(params, alive, w2c, K4, rcfg)["color"]
        with plain_blend(G):
            color_p = render_view(params, alive, w2c, K4, rcfg)["color"]
    err = (color - color_p).abs()
    frac = float((err > 1e-3 + 1e-3 * color_p.abs()).float().mean())
    if frac > 1e-4 or float(err.max()) > 0.05:
        fail(f"phase 14: micro-bench colour, K1 vs plain: {frac:.2e} of "
             f"elements off, max err {float(err.max())}")

    seen = {}
    k2 = G.blend_backward

    def spy(A, ext, tchk, tleft, *cots):
        seen["args"], seen["dA"] = (A, ext) + cots, k2(A, ext, tchk, tleft,
                                                        *cots)
        return seen["dA"]

    def grads():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = render_view(p, alive, w2c, K4, rcfg, bins=bins)[
            "color"].mean()
        return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

    G.blend_backward = spy
    try:
        g_k = grads()
    finally:
        G.blend_backward = k2
    with plain_blend(G):
        g_p = grads()
    ref = G.blend_backward_plain(*seen["args"])
    e2 = (seen["dA"] - ref).abs().amax((0, 1))
    rel = e2 / ref.abs().amax((0, 1)).clamp(min=1e-12)
    bad = [k for k in range(rel.shape[0]) if not float(rel[k]) < 5e-4]
    if bad:
        fail(f"phase 14: micro-bench K2 channels {bad}: max err / max |ref|"
             f" = {[float(rel[k]) for k in bad]}")
    g_rel = {k: float((g_k[k] - g_p[k]).abs().max()
                      / g_p[k].abs().max().clamp(min=1e-30)) for k in g_k}
    if not all(torch.isfinite(g).all() for g in g_k.values()):
        fail("phase 14: non-finite micro-bench gradients")
    return float(err.max()), frac, rel, g_rel


def bench_phase(G, card):
    """Phase 14 (see the module docstring). Returns the K1 / K2 launches
    of the timed pass."""
    import io
    import torch
    from cut3r_slam_tpu_torch import bench
    from cut3r_slam_tpu_torch.slam.system import SLAMSystem
    t_phase = time.perf_counter()
    rec = {"resets": 0}
    reset, micro = SLAMSystem.reset_state, bench.raster_micro

    def reset_state(self):
        reset(self)
        rec["resets"] += 1
        torch.cuda.synchronize()
        for k in G.LAUNCHES:
            G.LAUNCHES[k] = 0

    def raster_micro(*a, **k):
        rec["launches"] = dict(G.LAUNCHES)
        return micro(*a, **k)

    out = io.StringIO()
    SLAMSystem.reset_state, bench.raster_micro = reset_state, raster_micro
    try:
        with contextlib.redirect_stdout(out):
            run = bench.run_bench("cuda", n_frames=BENCH_FRAMES)
    finally:
        SLAMSystem.reset_state, bench.raster_micro = reset, micro
    bench_s = time.perf_counter() - t_phase
    lines = out.getvalue().splitlines()
    last = json.loads(lines[-1])
    log(f"[bench] {len(lines)} lines; the last: {lines[-1]}")
    bd, warm, timed = last["breakdown"], run["warm"], run["timed"]
    fs = timed["frame_s"]
    if last != run["result"] or not (last["warm_pass"]
                                     and last["steady_state"]
                                     and last["mapping_included"]):
        fail(f"phase 14: the last line is not a warm, steady, mapping "
             f"result: {lines[-1]}")
    if bd["n_mapping_events"] < 1 or last["frames"] != BENCH_FRAMES \
            or len(fs) != BENCH_FRAMES:
        fail(f"phase 14: {bd['n_mapping_events']} mapping events over "
             f"{last['frames']} of {BENCH_FRAMES} frames")
    if last["value"] != round(len(fs) / sum(fs), 3):
        fail(f"phase 14: value {last['value']} is not {len(fs)} frames / "
             f"{sum(fs):.3f} s")
    if "new_compile_cache_entries" in bd or bd.get("raster_backend") != \
            "cuda":
        fail(f"phase 14: breakdown keys {sorted(bd)}")
    micro_ms = [bd.get(k) for k in ("raster_fwd_ms", "raster_bwd_ms",
                                    "raster_bin_ms",
                                    "raster_bwd_cached_bins_ms")]
    if not all(isinstance(t, float) and np.isfinite(t) and t > 0
               for t in micro_ms):
        fail(f"phase 14: micro-bench times {micro_ms}")
    pose_d = float(np.abs(timed["kf_pose"] - warm["kf_pose"]).max()) \
        if timed["kf_count"] == warm["kf_count"] else float("inf")
    if timed["viz"] != warm["viz"] or timed["slices"] != warm["slices"] \
            or timed["closures"] != warm["closures"] or not pose_d <= 1e-6:
        fail(f"phase 14: the timed pass did not repeat the warm pass: "
             f"keyframes {warm['kf_count']} / {timed['kf_count']}, events "
             f"{warm['viz']} / {timed['viz']}, slices {warm['slices']} / "
             f"{timed['slices']}, closures {warm['closures']} / "
             f"{timed['closures']}, pose difference {pose_d:.3e}")
    launches = rec.get("launches")
    if rec["resets"] != 1 or launches is None \
            or min(launches.values()) <= 0:
        fail(f"phase 14: K1 / K2 inside the timed pass: {launches} "
             f"({rec['resets']} resets)")
    log(f"[bench] {BENCH_FRAMES} frames: {last['value']} frames/s "
        f"amortized, tracking only {bd.get('fps_tracking_only')}, largest "
        f"frame {bd['max_frame_s']} s, {bd['n_mapping_events']} events / "
        f"{bd['n_mapping_frames']} mapping frames (mean "
        f"{bd.get('mapping_frame_s_mean')} s), warm-up {bd['warmup_s']} s; "
        f"keyframes {timed['kf_count']} in both passes, pose difference "
        f"{pose_d:.3e}; launches in the timed pass {launches}; loop "
        f"closure stage {'ran' if 'loop_backend' in bd else 'did not run'}"
        f", {timed['closures']} closures | {card}")
    log(f"[bench] micro-bench at 2^17 Gaussians: forward {micro_ms[0]} ms, "
        f"gradient {micro_ms[1]} ms, binning {micro_ms[2]} ms, gradient "
        f"with cached bins {micro_ms[3]} ms | {card}")
    from cut3r_slam_tpu_torch import full_f32
    with full_f32():
        e1, fl, rel, g_rel = micro_vs_plain(G, bench, 384, 512, 2 ** 17)
    log(f"[bench] micro-bench vs plain: colour max err {e1:.3e} (off "
        f"fraction {fl:.1e}), K2 max err / max |ref| per channel "
        f"{float(rel.max()):.3e}; gradients max err / max |ref| "
        + ", ".join(f"{k} {v:.2e}" for k, v in g_rel.items())
        + " (quat: zero up to rounding for isotropic Gaussians)")
    log(f"[bench] phase 14 in {time.perf_counter() - t_phase:.1f} s "
        f"(run_bench {bench_s:.1f} s)")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the cached bin plan; bf16 weight storage
# ---------------------------------------------------------------------------

PLAN_MAPS = ("color", "alpha", "depth", "mdepth", "normal")


def planned_grads(bench, device, names=("fresh", "cached", "planned")):
    """The micro-bench arena's maps and gradients on ``device`` through
    fresh bins, cached bins and cached bins with their plan, and the
    callables that recompute each gradient."""
    import torch
    from cut3r_slam_tpu_torch.ops.gs_raster import compute_bin_plan
    from cut3r_slam_tpu_torch.slam.renderer import bin_view, render_view
    params, alive, w2c, K4, rcfg = bench.micro_scene(384, 512, 2 ** 17,
                                                     device)
    bins = bin_view(params, alive, w2c, K4, rcfg)
    plan = compute_bin_plan(*bins, params["xyz"].shape[0], rcfg)
    which = {"fresh": None, "cached": bins, "planned": bins + plan}

    def grad(b):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        out = render_view(p, alive, w2c, K4, rcfg, bins=b)
        loss = out["color"].mean() + 0.1 * out["depth"].mean()
        g = torch.autograd.grad(loss, list(p.values()))
        return {k: out[k].detach() for k in PLAN_MAPS}, dict(zip(p, g))

    res = {n: grad(which[n]) for n in names}
    return res, {n: (lambda b=which[n]: grad(b)) for n in names}


def grad_errors(got, ref):
    """max |err| / max |ref| per parameter; the quaternions' (zero up to
    rounding on an isotropic arena) over the largest gradient of any
    parameter."""
    top = max(float(g.abs().max()) for g in ref.values())
    return {k: float((got[k].cpu() - ref[k].cpu()).abs().max())
            / (top if k == "quat" else max(float(ref[k].abs().max()), 1e-30))
            for k in ref}


RG_VIEWS = 6      # phase 16's window: slam_map's V = 6 window
RG_ITERS = 20     # iterations a window optimization call (2 segments)


def window_mapper(H=384, W=512, views=RG_VIEWS):
    """A mapper at ``slam_map``'s shapes: 2^18 slots, ``views`` keyframes
    of ``synth_frames`` 2 cm apart over a gently curved wall 2-3 m away,
    the first two seeded (~98k Gaussians)."""
    import torch
    from cut3r_slam_tpu_torch.geometry.pointmap import depth_to_pointmap
    from cut3r_slam_tpu_torch.slam.mapping import MappingBackend, \
        MappingConfig
    f = 0.9 * W
    K4 = np.asarray([f, f, W / 2, H / 2], np.float32)
    be = MappingBackend(MappingConfig(height=H, width=W), K4,
                        device="cuda", seed=0)
    frames = synth_frames(views, H, W, seed=16)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    depth = (2.5 + 0.3 * np.sin(xx / 60.0) * np.cos(yy / 45.0)).astype(
        np.float32)
    for i, img in enumerate(frames):
        w2c = np.eye(4, dtype=np.float32)
        w2c[0, 3] = -0.02 * i
        be.add_keyframe(i, img, depth, w2c)
        if i < 2:
            pm = depth_to_pointmap(
                torch.tensor(depth), torch.tensor(K4),
                c2w=torch.linalg.inv(torch.tensor(w2c))).numpy()
            be.seed(i, pm[::2, ::2], img[::2, ::2].astype(np.float32) / 255.0,
                    np.ones((H // 2, W // 2), bool), 0)
    be.current_window = list(range(views))
    return be


def _host_calls(fn):
    """Run ``fn`` under ``torch.profiler``: (kernel launches, host waits)
    among its CUDA runtime and driver calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    waits = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
             "cuCtxSynchronize")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU]
    return (sum("Launch" in n for n in names),
            sum(n in waits for n in names) - 1)   # the closing synchronize


def render_graph_phase(card):
    """Phase 16 (see the module docstring)."""
    import torch
    from cut3r_slam_tpu_torch import full_f32
    from cut3r_slam_tpu_torch.slam import render_graph
    from cut3r_slam_tpu_torch.utils.profiling import StageTimer, attach
    window = list(range(RG_VIEWS))
    eager_run = render_graph.run
    capture_s = []
    init = render_graph._Graphed.__init__

    def timed_init(self, *a, **k):
        t0 = time.perf_counter()
        init(self, *a, **k)
        torch.cuda.synchronize()
        capture_s.append(time.perf_counter() - t0)

    def call(be):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in be.optimization_steps(RG_ITERS, window):
            pass
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / RG_ITERS

    out = {}
    with full_f32():
        # one untimed call first: the kernels built and loaded
        render_graph.run = lambda body, cfg, x: body(cfg, x)
        call(window_mapper())
        for mode in ("eager", "graphed"):
            render_graph.clear()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            render_graph.run = (lambda body, cfg, x: body(cfg, x)) \
                if mode == "eager" else eager_run
            render_graph._Graphed.__init__ = timed_init
            timer = StageTimer()
            prev = attach(timer)
            try:
                be = window_mapper()
                alive = int(be.arena.alive.sum())
                first = call(be)
                before = dict(timer.counters)
                launches, waits = _host_calls(lambda: call(be))
                second = call(be)
            finally:
                attach(prev)
                render_graph.run = eager_run
                render_graph._Graphed.__init__ = init
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            peak = torch.cuda.max_memory_allocated()
            render_graph.clear()
            gc.collect()
            held -= torch.cuda.memory_allocated()
            c = timer.counters
            out[mode] = ({k: v.detach().clone() for k, v in
                          be.arena.params().items()},
                         be.cams.w2c.clone(), be.cams.exposure_a.clone(),
                         be.cams.exposure_b.clone())
            log(f"[graphs] {mode}: {alive} alive of {be.cfg.capacity}, "
                f"window V = {RG_VIEWS}: {first:.1f} ms an iteration (first "
                f"call), {second:.1f} ms (third call); "
                f"{launches / RG_ITERS:.1f} launches and "
                f"{waits / RG_ITERS:.2f} host waits an iteration (second "
                f"call, profiled); peak {peak / 1e9:.3f} GB, graphs hold "
                f"{held / 1e9:.3f} GB; counters {dict(c)} | {card}")
            if mode == "graphed":
                steady = {k: c.get(k, 0) - before.get(k, 0)
                          for k in ("render.graph.capture",
                                    "render.graph.replay",
                                    "render.graph.eager")}
                if not c.get("render.graph.capture") \
                        or not c.get("render.graph.replay"):
                    fail(f"phase 16: the graphed run did not capture and "
                         f"replay: {dict(c)}")
                if steady["render.graph.capture"] \
                        or steady["render.graph.eager"]:
                    fail(f"phase 16: a warm call captured or ran eagerly: "
                         f"{steady}")
                log(f"[graphs] {len(capture_s)} captures, "
                    f"{', '.join(f'{1e3 * s:.1f}' for s in capture_s)} ms")
    names = ("Gaussian parameters", "poses", "exposure a", "exposure b")
    for name, a, b in zip(names, out["eager"], out["graphed"]):
        pairs = a.items() if isinstance(a, dict) else [("", a)]
        for k, v in pairs:
            w = b[k] if k else b
            if not torch.equal(v, w):
                fail(f"phase 16: graphed {name} {k} differ from eager by "
                     f"{float((v - w).abs().max()):.3e}")
    log("[graphs] eager and graphed window optimizations: Gaussians, poses "
        "and exposures torch.equal")


def planned_bins_phase(G, card):
    """Phase 15 (see the module docstring)."""
    import torch
    from cut3r_slam_tpu_torch import bench, full_f32
    from cut3r_slam_tpu_torch.models import CUT3RConfig
    from cut3r_slam_tpu_torch.models.convert import cast_params_bf16
    from cut3r_slam_tpu_torch.models.cut3r import normalize_images
    t_phase = time.perf_counter()
    with full_f32():
        for k in G.LAUNCHES:
            G.LAUNCHES[k] = 0
        res, fns = planned_grads(bench, "cuda")
        launches = dict(G.LAUNCHES)
        if min(launches.values()) <= 0:
            fail(f"phase 15: a kernel did not launch: {launches}")
        t_plan = cuda_ms(fns["planned"], 10)
        t_cached = cuda_ms(fns["cached"], 10)
        t_fresh = cuda_ms(fns["fresh"], 10)
        cpu, _ = planned_grads(bench, "cpu", ("planned",))
    maps_p, g_p = res["planned"]
    for ref in ("fresh", "cached"):
        maps_r, g_r = res[ref]
        e_map = max(float((maps_p[k] - maps_r[k]).abs().max())
                    for k in PLAN_MAPS)
        e_g = grad_errors(g_p, g_r)
        log(f"[plan] planned vs {ref} bins on the card: maps max |err| "
            f"{e_map:.3e}; gradients max err / max |ref| "
            + ", ".join(f"{k} {v:.2e}" for k, v in e_g.items()))
        if not e_map <= 1e-5 or not max(e_g.values()) <= 5e-4:
            fail(f"phase 15: planned vs {ref} bins: maps {e_map:.3e}, "
                 f"gradients {e_g}")
    maps_c, g_c = cpu["planned"]
    color, color_c = maps_p["color"].cpu(), maps_c["color"]
    err = (color - color_c).abs()
    frac = float((err > 1e-3 + 1e-3 * color_c.abs()).float().mean())
    e_g = grad_errors(g_p, g_c)
    log(f"[plan] planned, card vs CPU: colour max err {float(err.max()):.3e}"
        f" (off fraction {frac:.1e}); gradients max err / max |ref| "
        + ", ".join(f"{k} {v:.2e}" for k, v in e_g.items()))
    if frac > 1e-4 or float(err.max()) > 0.05 \
            or not max(e_g.values()) <= 5e-3:
        fail(f"phase 15: planned render card vs CPU: colour {frac:.2e} off,"
             f" max {float(err.max())}; gradients {e_g}")
    log(f"[plan] gradient at 2^17 Gaussians, 384x512: planned bins "
        f"{t_plan:.3f} ms, cached bins {t_cached:.3f} ms, fresh bins "
        f"{t_fresh:.3f} ms; launches {launches} | {card}")
    del res, fns, cpu
    gc.collect()
    torch.cuda.empty_cache()

    # bf16 weight storage: the full-width model loads the cast state_dict
    model = plausible_random_cut3r(seed=0)
    if model.cfg.compute_dtype != torch.bfloat16 \
            or CUT3RConfig().compute_dtype != torch.bfloat16:
        fail("phase 15: the full-width CUT3R does not compute in bf16")
    frames = synth_frames(2, 384, 512)
    imgs = normalize_images(torch.tensor(np.stack(frames),
                                         device="cuda"))[:, None]
    with torch.no_grad():
        ref = model(imgs)
        sd = cast_params_bf16(model.state_dict())
        n_cast = sum(v.dtype == torch.bfloat16 for v in sd.values())
        model.load_state_dict(sd, strict=True)
        got = model(imgs)
    errs = {}
    for k, v in ref.items():
        if not torch.is_floating_point(v):
            continue
        if got[k].shape != v.shape or not torch.isfinite(got[k]).all():
            fail(f"phase 15: bf16-stored CUT3R output {k} not finite or "
                 f"reshaped")
        errs[k] = float((got[k].float() - v.float()).abs().max()
                        / v.float().abs().max().clamp(min=1e-30))
    log(f"[plan] CUT3R with {n_cast} of {len(sd)} tensors stored bf16: "
        f"outputs max err / max |ref| vs f32 storage "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if not max(errs.values()) <= 5e-2:
        fail(f"phase 15: bf16-stored CUT3R outputs off: {errs}")
    del model, ref, got, sd
    log(f"[plan] phase 15 in {time.perf_counter() - t_phase:.1f} s")


def kernel_phases(G, card):
    """Phases 3 and 4: K1 / K2 against their plain versions on the 32x32
    scene, the staging-edge scene and at the mapping shape (V = 1 and 10,
    the median cotangent nonzero), K3 on a gradient render's inputs at the
    mapping shape (V = 1 and 10), then their times at the mapping shape.
    Returns the V = 1 rows of the kernels line: name -> (ms, plain ms,
    bound, max |err|, library ms)."""
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
        t_3, p_3, l_3, b_3, e_3, n_in, n_rows = k3_parity(
            G, frustum_scene(2 ** 16, H, W, f, V, V), K4m, cfg)
        log(f"[parity] 512x384 P=2^16 V={V}: K3 on a gradient render, "
            f"{n_in} masked-in entries of {V * cfg.n_tiles * cfg.max_per_tile}"
            f" onto {n_rows} rows: equal to its plain version and to "
            f"index_put_; masked-out cotangents zero")
        log(f"[time] V={V}: K3 {t_3:.4f} ms (plain {p_3:.3f}, index_put_ "
            f"{l_3:.3f}, bound {b_3[0]:.4f} by bytes) | {card}")
        if V == 1:
            rows["gs_pack_bwd"] = (t_3, p_3, b_3, e_3, l_3)
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
            rows["gs_blend_fwd"] = (t_f, p_f, b_f, e1, None)
            rows["gs_blend_bwd"] = (t_b, p_b, b_b, e2, None)
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

    def mark(done):
        log(f"[time] {done} done at {time.perf_counter() - t_start:.1f} s")

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

    mark("phases 1-4")
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

    mark("phase 5")
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
    slice_frames = frames[:SLICE_FRAMES]
    K4 = np.asarray([f, f, W / 2, H / 2], np.float32)
    for k in G.LAUNCHES:
        G.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    event_s, frame_s = [], []
    for t, img in enumerate(slice_frames):
        te = time.perf_counter()
        _, viz = slam.run(t, img, K4, img_map=img, K4_map=K4,
                          last=(t == len(slice_frames) - 1))
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - te)
        if viz is not None:
            event_s.append(frame_s[-1])
    run_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    slam.terminate(len(slice_frames) - 1)
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
    log(f"[slice] {len(slice_frames)} frames, {kf.count} keyframes, "
        f"{len(event_s)} mapping events, {alive} alive Gaussians, "
        f"median depth {float(np.median(kf.depth[:kf.count])):.3f}")
    log(f"[slice] {len(slice_frames) / run_s:.3f} frames/s over run() "
        f"({run_s:.1f} s), {np.mean(event_s):.2f} s per mapping-event frame "
        f"({', '.join(f'{s:.2f}' for s in event_s)}), terminate "
        f"{term_s:.1f} s, peak memory {peak_gb:.2f} GiB | {card}")
    log(f"[slice] main-path launches: {launches}; loop closures fired: "
        f"{len(slam.backend.closed)} (random weights: none is required)")

    # phase 13's input: this mapper's state and settings, saved now
    vp = vp_spec(slam, slam_cfg, (H, W), K4)

    mark("phase 6")
    # 7. the loop-closure path ------------------------------------------------------
    lc_launches = loop_closure_phase(model, G, card)

    mark("phase 7")
    # 8. the demo driver at the production mapping schedule ------------------
    demo_launches, demo_max, demo_out = demo_phase(model,
                                                   frames[:DEMO_FRAMES], K4, G,
                                                   card)
    log(f"[demo] largest frame: {max(frame_s):.2f} s drained (phase 6) vs "
        f"{demo_max:.2f} s interleaved, production schedule (phase 8); not "
        f"a paired comparison | {card}")

    mark("phase 8")
    # 9. CUT3R training (the SLAM phases' state released first) -------------
    del slam, model, m, kf, live
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = training_phase(G, card)

    mark("phase 9")
    # 10. the offline evaluation chain ----------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    offline_launches, _, _ = offline_phase(demo_out, G, card)

    mark("phase 10")
    # 11. the mono prior and the other model families ----------------------
    gc.collect()
    torch.cuda.empty_cache()
    prior_launches = model_families_phase(G, card, frames, K4)

    mark("phase 11")
    # 12. the DROID stack, the shared math and the live viewer ------------
    gc.collect()
    torch.cuda.empty_cache()
    droid_launches, viewer_launches = droid_viewer_phase(G, card, frames,
                                                          K4)

    mark("phase 12")
    # 13. view-parallel mapping, dp / fsdp training, sharded inference ----
    gc.collect()
    torch.cuda.empty_cache()
    vp_launches = view_parallel_phase(G, card, vp)

    mark("phase 13")
    # 14. the benchmark driver ----------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    bench_launches = bench_phase(G, card)

    mark("phase 14")
    # 15. the cached bin plan; bf16 weight storage ---------------------------
    gc.collect()
    torch.cuda.empty_cache()
    planned_bins_phase(G, card)

    mark("phase 15")
    # 16. the mapping window's gradient renders as CUDA graphs -------------
    gc.collect()
    torch.cuda.empty_cache()
    render_graph_phase(card)

    mark("phase 16")

    kernels = []
    for name, replaces in (
            ("gs_blend_fwd", ":186 _blend_fwd_kernel"),
            ("gs_blend_bwd", ":241 _blend_bwd_kernel"),
            ("gs_pack_bwd", ":347-350 the default pack gather's backward,"
                            " XLA's scatter-add (no Pallas kernel)")):
        t_k, t_p, (b_ms, b_by, _), err, t_lib = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cut3r_slam_tpu_torch/csrc/{name}.cu",
            "replaces": "cut3r_slam_tpu/ops/gs_raster_pallas.py" + replaces,
            "launches": launches[name],
            "launches_by_path": {"live": launches[name],
                                 "loop_closure": lc_launches[name],
                                 "demo_production_schedule":
                                     demo_launches[name],
                                 "training": train_launches[name],
                                 "offline_eval": offline_launches[name],
                                 "mono_prior": prior_launches[name],
                                 "droid": droid_launches[name],
                                 "viewer": viewer_launches[name],
                                 "view_parallel": vp_launches[name],
                                 "bench": bench_launches[name]},
            "max_abs_err": err, "ms": t_k,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_lib})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
