"""A mapping event with ``parallel_kf_refine``, the port vs the JAX
MappingBackend on the CPU (XLA), on the plane of tests/test_mapping.py:
three new keyframes after the first event, refined as one batch, seeded,
then optimized jointly. The yield sequence ("refine", "seed", the window
and polish segment losses, the global-BA segments), the losses to 1e-3
relative, the final arena in units of its learning rates and poses /
writeback to 2e-2 (the tolerances of tests/test_torch_mapping.py), with
the JAX global-BA draws injected.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from cut3r_slam_tpu.slam.mapping import (MappingBackend as JBackend,
                                         MappingConfig as JConfig)
from cut3r_slam_tpu.geometry.pointmap import depth_to_pointmap as j_d2p
from cut3r_slam_tpu.geometry.lie import se3_exp as j_se3_exp, \
    se3_matrix as j_se3_matrix
from cut3r_slam_tpu_torch.slam.mapping import MappingBackend, MappingConfig
from test_torch_batched_mapping import XIS, _lr_units, _make_scene, \
    few_threads, jax_gba_draws  # noqa: F401 (few_threads: autouse)

H, W = 32, 32
K4 = np.array([40.0, 40.0, W / 2, H / 2], np.float32)
CFG = dict(height=H, width=W, capacity=2048, cam_capacity=8, window_size=3,
           pose_refine_iters=4, opt_segment=2, window_opt_iters=4,
           new_view_opt_iters=2, gba_per_view=2, gba_segment=2,
           max_per_tile=256, parallel_kf_refine=True)
ITERS = 4


def _packet(viz):
    img, depth = _make_scene()
    pm = np.asarray(j_d2p(jnp.asarray(depth), jnp.asarray(K4)))
    w2c = [np.asarray(j_se3_matrix(j_se3_exp(jnp.asarray(XIS[i]))),
                      np.float32) for i in viz]
    n = len(viz)
    return {"viz_idx": list(viz), "images": np.stack([img] * n),
            "depths": np.stack([depth] * n),
            "pointmaps": np.stack([pm[::2, ::2]] * n),
            "confs": np.ones((n, H // 2, W // 2), np.float32),
            "w2c": np.stack(w2c), "submap_idx": 0,
            "tstamp": np.asarray(viz)}


def _drain(gen):
    ys = []
    while True:
        try:
            ys.append(next(gen))
        except StopIteration as e:
            return ys, e.value


def _pair():
    """Both backends after the first event (keyframe 0), the port fed the
    JAX draws; returns them and the JAX backend's key afterwards."""
    jb = JBackend(JConfig(raster_backend="xla", **CFG), K4)
    tb = MappingBackend(MappingConfig(**CFG), K4, device="cpu")
    _drain(jb.run_steps(_packet([0]), ITERS))
    views, noise, rng = jax_gba_draws([0], CFG["gba_per_view"], 1, 1,
                                      CFG["gba_segment"], CFG["capacity"])
    _drain(tb.run_steps(_packet([0]), ITERS, view_idx=views,
                        split_noise=noise))
    return jb, tb, rng


@pytest.fixture(scope="module")
def parallel_event():
    jb, tb, rng = _pair()
    j_ys, j_upd = _drain(jb.run_steps(_packet([0, 1, 2, 3]), ITERS))
    views, noise, _ = jax_gba_draws([0, 1, 2, 3], 4 * CFG["gba_per_view"], 1,
                                    1, CFG["gba_segment"], CFG["capacity"],
                                    rng)
    refined = []
    multi = tb.pose_refine_multi
    tb.pose_refine_multi = lambda idxs: refined.append(list(idxs)) or \
        multi(idxs)
    t_ys, t_upd = _drain(tb.run_steps(_packet([0, 1, 2, 3]), ITERS,
                                      view_idx=views, split_noise=noise))
    return jb, j_ys, j_upd, tb, t_ys, t_upd, refined


def test_parallel_event_yields(parallel_event):
    _, j_ys, _, tb, t_ys, _, refined = parallel_event
    assert refined == [[1, 2, 3]]

    def kinds(ys):
        return [y if isinstance(y, str) else type(y).__name__ for y in ys]
    # refine, seed, window 3 x 4 iterations = 6 segments, polish 1, GBA 4
    assert kinds(t_ys) == kinds(j_ys) == ["refine", "seed"] + ["float"] * 7 \
        + ["int"] * 4
    jl = [y for y in j_ys if isinstance(y, float)]
    tl = [y for y in t_ys if isinstance(y, float)]
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tb.current_window == [1, 2, 3]


def test_parallel_event_final_state(parallel_event):
    jb, _, j_upd, tb, _, t_upd, _ = parallel_event
    _lr_units(jb, tb)
    np.testing.assert_allclose(tb.cams.w2c.numpy(), np.asarray(jb.cams.w2c),
                               atol=2e-2)
    assert t_upd["window"] == j_upd["window"] == [1, 2, 3]
    np.testing.assert_allclose(t_upd["depths"], j_upd["depths"], atol=2e-2)
    np.testing.assert_allclose(t_upd["c2w"], j_upd["c2w"], atol=2e-2)
