"""The whole ported slice vs the JAX package on the CPU: ``SLAMSystem.run``
over a drifting synthetic sequence, then ``terminate``, at the tiny CUT3R
config (f32, same weights through ``params_from_jax``), 32x48 frames,
``kf_every=2`` and enough frames for two mapping events, with small
mapping iteration counts. ``gba_per_view=0`` and a zero finalize budget
keep every random draw out of the run.

Keyframe count and timestamps must agree exactly; the keyframe poses and
depths written back by mapping agree to 1e-2 (the mapping event is
chaotic at float-rounding level, see tests/test_torch_mapping.py).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
from cut3r_slam_tpu.slam.system import SLAMSystem as JSLAM
from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
from cut3r_slam_tpu_torch.models.convert import params_from_jax
from cut3r_slam_tpu_torch.slam.system import SLAMSystem

from test_torch_cut3r_train import few_threads  # noqa: F401

H, W = 32, 48
N_FRAMES = 23
K4 = np.asarray([40.0, 40.0, W / 2, H / 2], np.float32)
CFG = {
    "Tracking": {"motion_filter": {"kf_every": 2}},
    "Mapping": {"arena_capacity": 4096, "window_size": 3, "iterations": 4,
                "window_opt_iters": 2, "new_view_opt_iters": 2,
                "gba_per_view": 0},
    "opt_params": {"position_lr_max_steps": 0},
    "keep_all_frames": False,
}
# mapping knobs the JAX SLAMSystem does not read from its config
MAP_EXTRA = {"pose_refine_iters": 2, "opt_segment": 2}


def _frames():
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, size=(H, W + 2 * N_FRAMES, 3))
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3.0
    base = base.astype(np.uint8)
    return [np.ascontiguousarray(base[:, 2 * i:2 * i + W])
            for i in range(N_FRAMES)]


def _drive(slam, frames):
    events = []
    for t, f in enumerate(frames):
        _, viz = slam.run(t, f, K4, last=(t == len(frames) - 1))
        if viz is not None:
            events.append(list(viz))
    slam.terminate(len(frames) - 1, **({} if isinstance(slam, SLAMSystem)
                                       else {"eval_render": False,
                                             "export_renders": False}))
    return events


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    frames = _frames()
    jm = JCUT3R(JConfig.tiny())
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, H, W, 3)))
    out_j = str(tmp_path_factory.mktemp("jax"))
    js = JSLAM(jm, params, CFG, buffer=32, img_hw=(H, W), enable_loop=False,
               output_dir=out_j)
    js._map_cfg_extra.update(MAP_EXTRA)
    ev_j = _drive(js, frames)

    tm = CUT3R(CUT3RConfig.tiny(), device="cpu")
    tm.load_state_dict(params_from_jax(flatten_dict(params["params"],
                                                    sep="/")))
    out_t = str(tmp_path_factory.mktemp("torch"))
    ts = SLAMSystem(tm, CFG, buffer=32, img_hw=(H, W), output_dir=out_t,
                    device="cpu")
    ts._map_cfg_extra.update(MAP_EXTRA)
    ev_t = _drive(ts, frames)
    return js, ev_j, ts, ev_t


def test_keyframes_and_events_match(runs):
    js, ev_j, ts, ev_t = runs
    assert ts.keyframes.count == js.keyframes.count == 12
    np.testing.assert_array_equal(ts.keyframes.tstamp, js.keyframes.tstamp)
    assert ev_t == ev_j and len(ev_t) == 2


def test_written_back_poses_and_depths_match(runs):
    js, _, ts, _ = runs
    n = js.keyframes.count
    assert ts.mapper is not None and int(ts.mapper.cams.valid.sum()) == 11
    np.testing.assert_allclose(ts.keyframes.pose[:n, :3],
                               js.keyframes.pose[:n, :3], atol=1e-2)
    qj, qt = js.keyframes.pose[:n, 3:], ts.keyframes.pose[:n, 3:]
    # quaternions are sign-ambiguous
    flip = np.sign(np.sum(qj * qt, -1, keepdims=True))
    np.testing.assert_allclose(qt * flip, qj, atol=1e-2)
    dj, dt = js.keyframes.depth[:n], ts.keyframes.depth[:n]
    np.testing.assert_allclose(dt, dj, atol=1e-2, rtol=1e-2)


def test_terminate_outputs(runs):
    """``terminate`` defaults to the rendering eval and the render export,
    as in the JAX package (the JAX run above turns both off)."""
    import json
    _, _, ts, _ = runs
    out = ts.output_dir
    assert os.path.exists(os.path.join(out, "gaussians.npz"))
    assert os.path.exists(os.path.join(out, "3dgs_final.ply"))
    with open(os.path.join(out, "psnr", "final", "final_result_kf.json")) as f:
        ev = json.load(f)
    assert ev["n_views"] == 11 and np.isfinite(ev["mean_psnr"])
    assert os.path.exists(os.path.join(out, "psnr", "final",
                                       "final_result_kf_only.json"))
    for sub, name in (("image_final", "000010.jpg"),
                      ("depth_final", "000010.png")):
        assert os.path.exists(os.path.join(out, "renders_kf", sub, name))
    assert os.path.exists(os.path.join(out, "renders_kf", "color_00010.png"))
    traj = os.path.join(ts.output_dir, "traj_kf.txt")
    ts.save_trajectory(traj)
    rows = np.loadtxt(traj)
    assert rows.shape == (ts.keyframes.count, 8)
    assert np.isfinite(rows).all()


@pytest.mark.parametrize("cfg, kwargs", [
    ({"Mapping": {"view_parallel": 2}}, {}),
], ids=["view_parallel"])
def test_unported_settings_raise(cfg, kwargs, tmp_path):
    """A setting the system cannot honour here is refused when asked for,
    not silently skipped: view-parallel mapping without a process group
    of that size names torchrun (the view-parallel runs:
    tests/test_torch_parallel_slam.py; the mono prior:
    tests/test_torch_prior.py; the viewer: tests/test_torch_gui.py)."""
    model = CUT3R(CUT3RConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        SLAMSystem(model, cfg, buffer=4, img_hw=(H, W),
                   output_dir=str(tmp_path), device="cpu", **kwargs)


@pytest.mark.parametrize("pgba", [False, True], ids=["loop", "loop_pgba"])
def test_loop_closure_settings_run(pgba, tmp_path):
    """Loop closure is on by default, as in the JAX package, and the Sim(3)
    PGBA is accepted; both drive the live loop through the loop backend's
    scan (the first tracking event after keyframe 10 calls it)."""
    model = CUT3R(CUT3RConfig.tiny(), device="cpu")
    cfg = {"Tracking": {"motion_filter": {"kf_every": 2},
                        "backend": {"loop_iters": 5},
                        "pgba": {"active": pgba}},
           "keep_all_frames": False}
    slam = SLAMSystem(model, cfg, buffer=32, img_hw=(H, W),
                      enable_mapping=False, output_dir=str(tmp_path),
                      device="cpu")
    assert slam.enable_loop and (slam.pgba is not None) == pgba
    assert slam.backend.loop_iters == 5
    calls = []
    scan = slam.backend.run
    slam.backend.run = lambda t1: calls.append(t1) or scan(t1)
    for t, f in enumerate(_frames()):
        slam.run(t, f, K4, last=(t == N_FRAMES - 1))
    assert calls == [11]
    kf = slam.keyframes
    assert kf.count == 12 and np.isfinite(kf.pose[:kf.count]).all()
