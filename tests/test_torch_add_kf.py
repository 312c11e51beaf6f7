"""Terminate-time densification (``SLAMSystem.add_kf_densify``, reached
by ``terminate(add_kf=True)``), the port vs the JAX package on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
from flax.traverse_util import flatten_dict, unflatten_dict

from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
from cut3r_slam_tpu.slam.system import SLAMSystem as JSLAM
from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
from cut3r_slam_tpu_torch.models.convert import params_from_jax
from cut3r_slam_tpu_torch.slam.system import SLAMSystem
from test_torch_batched_mapping import (K4, _lr_units, _state,  # noqa: F401
                                        few_threads)


def test_add_kf_densify_matches_jax(tmp_path):
    """Terminate-time densification on both packages from one state: the
    tiny CUT3R's JAX params (the port's through ``params_from_jax``), one
    mapper state (the JAX backend's ``save`` loaded by the port), the same
    four keyframes (a 40-frame gap after the first) and the same frame
    store. On both the gap's middle frame is decoded against the first
    keyframe, appended as a keyframe and mapped (pose refine, seed, a
    20-iteration polish). Its keyframe pose and its mapping w2c to 1e-4
    and its keyframe depth to 1e-3 (one f32 decode and one deterministic
    refinement apart by summation order: 2e-8 and 3e-6 on this input); the
    same alive slots and the Gaussians, after the 20 Adam steps of the
    polish, in units of their learning rate as in
    tests/test_torch_batched_mapping.py."""
    jm = JCUT3R(JConfig.tiny())
    flat = flatten_dict(jm.init(jax.random.PRNGKey(0), jnp.zeros(
        (1, 1, 32, 32, 3)))["params"], sep="/")
    # chip_smoke.py's plausible random model: a plane about 1 m in front of
    # a near-static camera, so the new keyframe lands inside the map
    for k, scale, bias in (("downstream_head/dpt_self/head_4", 0.05,
                            [0, 0, 1, 0]),
                           ("downstream_head/pose_head/mlp/fc2", 0.01,
                            [0, 0, 0, 1, 0, 0, 0])):
        flat[k + "/kernel"] = flat[k + "/kernel"] * scale
        flat[k + "/bias"] = jnp.asarray(bias, jnp.float32)
    params = {"params": unflatten_dict(flat, sep="/")}
    tm = CUT3R(CUT3RConfig.tiny(), device="cpu")
    tm.load_state_dict(params_from_jax(flat))
    jb, tb = _state(tmp_path, raster_backend="xla")
    js = JSLAM(jm, params, {}, buffer=8, img_hw=(32, 32),
               output_dir=str(tmp_path / "jax"))
    ts = SLAMSystem(tm, {}, buffer=8, img_hw=(32, 32),
                    output_dir=str(tmp_path / "torch"), device="cpu")
    img = tb.cams.image[0].numpy()
    frames = {t: img for t in range(43)}
    frames[20] = np.ascontiguousarray(np.roll(img, 3, axis=1))
    for sys_, mapper in ((js, jb), (ts, tb)):
        sys_.mapper = mapper
        sys_.images = dict(frames)
        for t in (0, 40, 41, 42):
            sys_.keyframes.append(
                t, img, feat=sys_.filter.encode(img),
                pose=np.asarray([0, 0, 0, 0, 0, 0, 1], np.float32),
                depth=np.full((32, 32), 2.0, np.float32), intrinsic=K4)
    n0 = int(tb.arena.alive.sum())
    assert ts.add_kf_densify() == js.add_kf_densify() == 1
    kt, kj = ts.keyframes, js.keyframes
    assert kt.count == kj.count == 5 and kt.tstamp[4] == kj.tstamp[4] == 20
    assert bool(tb.cams.valid[4]) and bool(jb.cams.valid[4])
    pt, pj = kt.pose[4], kj.pose[4]
    assert np.isfinite(pt).all()
    np.testing.assert_allclose(pt[:3], pj[:3], atol=1e-4)
    flip = np.sign(np.sum(pt[3:] * pj[3:]))
    np.testing.assert_allclose(pt[3:] * flip, pj[3:], atol=1e-4)
    np.testing.assert_allclose(kt.depth[4], kj.depth[4], atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(tb.cams.w2c[4].numpy(),
                               np.asarray(jb.cams.w2c[4]), atol=1e-4)
    assert int(tb.arena.alive.sum()) > n0
    _lr_units(jb, tb)
