"""Terminate-time rendering eval and the metrics of the port vs the JAX
package on the CPU.

* ``eval_rendering_kf``, ``eval_rendering_full`` and ``export_renders``
  from one mapper state (the JAX backend's ``save`` loaded by the port,
  four keyframes of tests/test_torch_batched_mapping.py): the same files
  under the output directory and the same JSON keys; PSNR, SSIM and depth
  L1 to 1e-3 (both render in f32; the blends differ in summation order).
* ``utils/eval`` (psnr, ssim, depth_l1, evaluate_renders, ate_rmse) and
  ``umeyama_alignment`` on seeded inputs: to 1e-5 relative (f32 SVDs of
  the same 3x3 matrix; the metrics are f64 numpy on both sides).
"""
import json
import os
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cut3r_slam_tpu.slam.system import SLAMSystem as JSLAM
from cut3r_slam_tpu.utils import eval as JE
from cut3r_slam_tpu.geometry.pointmap import umeyama_alignment as j_umeyama
from cut3r_slam_tpu_torch.geometry.pointmap import umeyama_alignment
from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
from cut3r_slam_tpu_torch.slam.system import SLAMSystem
from cut3r_slam_tpu_torch.utils import eval as TE
from test_torch_batched_mapping import _state, few_threads  # noqa: F401


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    jb, tb = _state(tmp_path_factory.mktemp("state"), raster_backend="xla")
    out_j = str(tmp_path_factory.mktemp("jax"))
    out_t = str(tmp_path_factory.mktemp("torch"))
    # the JAX SLAMSystem's eval methods on the JAX mapper, without building
    # a model
    js = types.SimpleNamespace(output_dir=out_j, mapper=jb,
                               keyframes=types.SimpleNamespace(
                                   count=4, tstamp=np.arange(4) * 3),
                               images={}, map_hw=(32, 32),
                               _EVAL_BATCH=JSLAM._EVAL_BATCH,
                               _save_render=JSLAM._save_render)
    js._render_views_batched = types.MethodType(
        JSLAM._render_views_batched, js)
    j_kf = JSLAM.eval_rendering_kf(js)
    j_full = JSLAM.eval_rendering_full(js)
    JSLAM.export_renders(js, os.path.join(out_j, "renders_kf"))
    ts = SLAMSystem(CUT3R(CUT3RConfig.tiny(), device="cpu"), {}, buffer=8,
                    img_hw=(32, 32), output_dir=out_t, device="cpu")
    ts.mapper = tb
    ts.keyframes.count = 4
    ts.keyframes.tstamp[:4] = np.arange(4) * 3
    t_kf = ts.eval_rendering_kf()
    t_full = ts.eval_rendering_full()
    ts.export_renders(os.path.join(out_t, "renders_kf"))
    return out_j, j_kf, j_full, out_t, t_kf, t_full


def test_eval_files_match(evals):
    out_j, _, _, out_t, _, _ = evals
    files = _files(out_t)
    assert files == _files(out_j)
    for f in ("psnr/final/final_result_kf.json",
              "psnr/final/final_result_kf_only.json",
              "renders_kf/image_final/000003.jpg",
              "renders_kf/depth_final/000003.png",
              "renders_kf/color_00003.png", "renders_kf/depth_00003.png",
              "renders/image_final/000009.jpg"):
        assert f in files, f
    import cv2
    for f in ("renders_kf/depth_final/000002.png",
              "renders_kf/depth_00002.png"):
        a = cv2.imread(os.path.join(out_t, f), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(os.path.join(out_j, f), cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype == np.uint16
        # uint16 depth x 6553.5: 1e-3 m is 6.5 counts
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 7, f


@pytest.mark.parametrize("which", ["kf", "full"])
def test_eval_metrics_match(evals, which):
    out_j, j_kf, j_full, out_t, t_kf, t_full = evals
    j, t = (j_kf, t_kf) if which == "kf" else (j_full, t_full)
    assert set(t) == set(j) and t["n_views"] == j["n_views"] == 4
    assert t["mean_lpips"] is None and j["mean_lpips"] is None
    for k in ("mean_psnr", "mean_ssim", "mean_l1"):
        assert np.isfinite(t[k]), k
        np.testing.assert_allclose(t[k], j[k], rtol=1e-3, err_msg=k)
    name = "final_result_kf.json" if which == "kf" \
        else "final_result_kf_only.json"
    with open(os.path.join(out_t, "psnr", "final", name)) as f:
        assert json.load(f) == t


def test_eval_functions_match_jax():
    rng = np.random.default_rng(0)
    img, gt = rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32)
    gt = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(
        np.float32)
    d, gd = rng.uniform(0.5, 3, (2, 24, 32)).astype(np.float32)
    gd[:4] = 0.0
    assert TE.psnr(img, gt) == JE.psnr(img, gt)
    np.testing.assert_allclose(TE.ssim(img, gt), JE.ssim(img, gt),
                               rtol=1e-5)
    assert TE.depth_l1(d, gd) == JE.depth_l1(d, gd)
    assert TE.lpips(img, gt) is None   # no torchmetrics
    a = TE.evaluate_renders([img, gt], [gt, gt], [d, d], [gd, gd])
    b = JE.evaluate_renders([img, gt], [gt, gt], [d, d], [gd, gd])
    assert set(a) == set(b)
    for k in ("psnr", "ssim", "depth_l1"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    est = rng.normal(size=(20, 3))
    ang = 0.7
    R = np.asarray([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang),
                                                     np.cos(ang), 0],
                    [0, 0, 1]])
    gt_t = 1.7 * est @ R.T + [0.3, -1.0, 2.0] + rng.normal(0, 0.01, (20, 3))
    for scale in (True, False):
        np.testing.assert_allclose(TE.ate_rmse(est, gt_t, with_scale=scale),
                                   JE.ate_rmse(est, gt_t, with_scale=scale),
                                   rtol=1e-5)
    assert TE.ate_rmse(est, gt_t) < 0.03
    Rt, tt, st = umeyama_alignment(torch.tensor(est, dtype=torch.float32),
                                   torch.tensor(gt_t, dtype=torch.float32))
    Rj, tj, sj = j_umeyama(jnp.asarray(est, jnp.float32),
                           jnp.asarray(gt_t, jnp.float32))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
    np.testing.assert_allclose(Rt.numpy(), R, atol=1e-2)


def test_trajectory_filler_matches_jax(tmp_path):
    """Non-keyframe poses refined against one map from the nearest
    earlier keyframe on both packages (20 Adam steps of the alpha-masked
    RGB L1): to 1e-4 (one deterministic refinement, f32)."""
    from cut3r_slam_tpu.slam.trajectory_filler import TrajectoryFiller as JF
    from cut3r_slam_tpu_torch.geometry.lie import se3_from_matrix
    from cut3r_slam_tpu_torch.slam.trajectory_filler import TrajectoryFiller
    jb, tb = _state(tmp_path, raster_backend="xla")
    kf_ts = np.asarray([0, 3, 6, 9])
    kf_poses = se3_from_matrix(torch.linalg.inv(tb.cams.w2c[:4])).numpy()
    imgs = [tb.cams.image[i].numpy() for i in (1, 3)]
    ts = [4, 11]
    a = TrajectoryFiller(tb, iters=20).fill(imgs, ts, kf_ts, kf_poses)
    b = JF(jb, iters=20).fill(imgs, ts, kf_ts, kf_poses)
    assert a.shape == (2, 7) and np.isfinite(a).all()
    flip = np.sign(np.sum(a[:, 3:] * np.asarray(b)[:, 3:], -1,
                          keepdims=True))
    np.testing.assert_allclose(a[:, :3], np.asarray(b)[:, :3], atol=1e-4)
    np.testing.assert_allclose(a[:, 3:] * flip, np.asarray(b)[:, 3:],
                               atol=1e-4)
    assert np.abs(a - kf_poses[[1, 3]]).max() > 1e-5   # the poses moved


def test_eval_view_and_small_helpers_match_jax(tmp_path):
    """``MappingBackend.eval_view`` (one keyframe's PSNR) to 1e-4 relative;
    ``matrix_to_pose_vec`` / ``pointmap_to_depth`` to 1e-6; the depth PNG
    writers byte for byte."""
    import cv2
    from cut3r_slam_tpu.geometry import pointmap as JP
    from cut3r_slam_tpu.utils import viz as JV
    from cut3r_slam_tpu_torch.geometry import pointmap as TP
    from cut3r_slam_tpu_torch.utils import viz as TV
    jb, tb = _state(tmp_path, raster_backend="xla")
    for i in (0, 2):
        np.testing.assert_allclose(tb.eval_view(i), jb.eval_view(i),
                                   rtol=1e-4)
    m = tb.cams.w2c[:4]
    np.testing.assert_allclose(TP.matrix_to_pose_vec(m).numpy(),
                               np.asarray(JP.matrix_to_pose_vec(
                                   jnp.asarray(m.numpy()))), atol=1e-6)
    pts = torch.randn(5, 6, 3)
    assert torch.equal(TP.pointmap_to_depth(pts), pts[..., 2])
    d = np.random.default_rng(0).uniform(0.5, 3.0, (24, 32)).astype(
        np.float32)
    d[0] = 0.0
    for colorize in (True, False):
        a, b = str(tmp_path / f"t{colorize}.png"), str(tmp_path / "j.png")
        TV.save_depth_png(a, d, colorize=colorize)
        JV.save_depth_png(b, d, colorize=colorize)
        np.testing.assert_array_equal(cv2.imread(a, cv2.IMREAD_UNCHANGED),
                                      cv2.imread(b, cv2.IMREAD_UNCHANGED))
