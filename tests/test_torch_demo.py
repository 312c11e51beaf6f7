"""The port's demo driver end to end on the CPU, in-process:
``python -m cut3r_slam_tpu_torch.demo --cpu --tiny-model`` over a dozen
48x32 PNGs of a sliding panorama, with a config on the JAX package's
production mapping schedule (parallel keyframe refinement, batched global
BA keys, interleaved mapping, early stop) at tiny iteration counts, loop
closure on. Every output file of ``demo.py`` and of ``terminate``'s eval
must be written and hold finite numbers."""
import json
import os

import numpy as np
import pytest

from cut3r_slam_tpu_torch import demo
from test_torch_batched_mapping import few_threads  # noqa: F401 (autouse)

N, H, W = 12, 32, 48
CONFIG = """\
Tracking:
  motion_filter: {kf_every: 1}
  backend: {loop_iters: 5}
Mapping:
  window_size: 3
  iterations: 4
  pose_refine_iters: 2
  window_opt_iters: 2
  new_view_opt_iters: 2
  gba_per_view: 0
  parallel_kf_refine: true
  gba_views_per_iter: 4
  gba_resample_every: 4
  interleave: 3
  opt_early_stop: 0.01
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import cv2
    root = tmp_path_factory.mktemp("demo")
    rng = np.random.default_rng(0)
    pano = rng.uniform(0, 255, (H, W + 2 * N, 3))
    for _ in range(2):
        pano = (pano + np.roll(pano, 1, 0) + np.roll(pano, 1, 1)) / 3.0
    pano = pano.astype(np.uint8)
    os.makedirs(root / "img")
    for i in range(N):
        cv2.imwrite(str(root / "img" / f"frame{i:04d}.png"),
                    np.ascontiguousarray(pano[:, 2 * i:2 * i + W]))
    (root / "calib.txt").write_text("40 40 24 16\n")
    (root / "cfg.yaml").write_text(CONFIG)
    out = str(root / "out")
    slam, result = demo.main([
        "--imagedir", str(root / "img"), "--calib", str(root / "calib.txt"),
        "--config", str(root / "cfg.yaml"), "--output", out, "--cpu",
        "--tiny-model", "--target_width", str(W), "--finalize_iters", "0",
        "--arena_capacity", "4096"])
    return slam, result, out


def test_demo_outputs(run):
    slam, result, out = run
    for f in ("image_shape.txt", "timing.json", "traj_kf.txt",
              "intrinsics.npy", "result.json", "gaussians.npz",
              "3dgs_final.ply", "psnr/final/final_result_kf.json",
              "psnr/final/final_result_kf_only.json"):
        assert os.path.exists(os.path.join(out, f)), f
    with open(os.path.join(out, "result.json")) as f:
        res = json.load(f)
    assert res["frames"] == N and res["keyframes"] == slam.keyframes.count
    assert np.isfinite(res["psnr_kf"]) and np.isfinite(res["fps"])
    assert res["eval_kf"]["n_views"] == int(slam.mapper.cams.valid.sum()) > 6
    traj = np.loadtxt(os.path.join(out, "traj_kf.txt"))
    assert traj.shape == (slam.keyframes.count, 8) and np.isfinite(traj).all()
    K = np.load(os.path.join(out, "intrinsics.npy"))
    assert K.shape == (slam.keyframes.count, 4) and np.isfinite(K).all()
    n = res["eval_kf"]["n_views"]
    kf = os.listdir(os.path.join(out, "renders_kf"))
    assert len([f for f in kf if f.startswith("color_")]) == n
    assert len(os.listdir(os.path.join(out, "renders_kf",
                                       "depth_final"))) == n


def test_demo_schedule_and_timing(run):
    slam, _, out = run
    assert slam.map_interleave == 3 and slam.mapper.cfg.parallel_kf_refine
    assert slam._map_gen is None          # terminate drained the backlog
    with open(os.path.join(out, "timing.json")) as f:
        timing = json.load(f)
    # demo.py's stages: the system's own are timed only with a timer
    # attached (tests/test_torch_schedule.py)
    assert set(timing) == {"frame", "terminate"} and slam.timer is None
    assert timing["frame"]["calls"] == N and timing["terminate"]["calls"] == 1
    for stage in timing:
        assert np.isfinite(timing[stage]["mean_ms"]), stage
    m = slam.mapper
    live = m.arena.alive
    assert live.sum() > 0
    for k in ("xyz", "f_dc", "opacity_logit", "log_scales", "quat"):
        assert np.isfinite(getattr(m.arena, k)[live].numpy()).all(), k


def test_stage_timer_and_trace_match_jax(tmp_path):
    """``StageTimer``'s summary has the JAX package's JSON layout, and
    ``timed`` times a stage only with a timer."""
    import torch
    from cut3r_slam_tpu.utils.profiling import StageTimer as JTimer
    from cut3r_slam_tpu_torch.utils.profiling import StageTimer, timed
    a, b = StageTimer(), JTimer()
    for tm in (a, b):
        for _ in range(2):
            with tm("x"):
                pass
        with tm("y"):
            pass
    sa, sb = json.loads(a.dump(str(tmp_path / "t.json"))), b.summary()
    assert set(sa) == set(sb) == {"x", "y"}
    for k in sa:
        assert set(sa[k]) == set(sb[k]) and sa[k]["calls"] == sb[k]["calls"]
    with timed(None, "z"):
        pass
    with timed(a, "z", torch.device("cpu")):
        pass
    assert a.counts["z"] == 1
