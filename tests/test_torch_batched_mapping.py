"""Batched mapping of the port vs the JAX MappingBackend on the CPU, from
one seeded state (the JAX backend's ``save`` loaded by the port): four
keyframes of the textured plane of tests/test_mapping.py under small pose
offsets, the map seeded from the first.

* ``pose_refine_multi`` over three views against the JAX package's (XLA:
  a lax.map of single-view refinements; the port renders the three views
  through one fused blend a step and sums their losses, the same
  independent problems). From one state one refinement agrees to float
  rounding, so poses are held to 1e-5 and the returned pointmaps to 1e-5
  + 1e-5 relative; the stored depths are bf16 on both sides (one bf16
  step, 2^-8 relative).

The block-binned global BA is held in tests/test_torch_gba_blocks.py.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cut3r_slam_tpu.slam.mapping import (MappingBackend as JBackend,
                                         MappingConfig as JConfig)
from cut3r_slam_tpu.geometry.pointmap import depth_to_pointmap as j_d2p
from cut3r_slam_tpu.geometry.lie import se3_exp as j_se3_exp, \
    se3_matrix as j_se3_matrix
from cut3r_slam_tpu_torch.slam.mapping import MappingBackend, MappingConfig


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's CPU work, the caller's count
    restored after: under ``pytest -n`` every worker's default pool spans
    all cores, and the pools then spin against each other (a 3x longer
    wall time on 8 cores with two workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


H, W = 32, 32
K4 = np.array([40.0, 40.0, W / 2, H / 2], np.float32)
CFG = dict(height=H, width=W, capacity=2048, cam_capacity=8, window_size=3,
           pose_refine_iters=4, opt_segment=2, max_per_tile=256)
GBA = dict(gba_views_per_iter=2, gba_resample_every=2, gba_segment=4)
XIS = ([0.0] * 6, [0.01, -0.01, 0.02, 0.01, 0.0, -0.01],
       [-0.02, 0.01, 0.0, 0.0, 0.01, 0.01], [0.015, 0.02, -0.01, -0.01, 0.0,
                                             0.005])


def _make_scene():
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = np.stack([(np.sin(xx / 3.0) * 0.5 + 0.5),
                    (np.cos(yy / 4.0) * 0.5 + 0.5),
                    ((xx + yy) % 7) / 7.0], axis=-1)
    depth = 2.0 + 0.2 * np.sin(xx / 5.0).astype(np.float32)
    return (img * 255).astype(np.uint8), depth.astype(np.float32)


def _state(tmp_path, **jkw):
    """JAX backend with four keyframes and a map seeded from the first,
    and the port backend loaded from its ``save``. The seeded Gaussians
    are isotropic, where the rotation's gradient is float noise that Adam
    turns into full steps of either sign: their scales and rotations get
    a seeded jitter first."""
    jb = JBackend(JConfig(**CFG, **jkw), K4)
    img, depth = _make_scene()
    pm = np.asarray(j_d2p(jnp.asarray(depth), jnp.asarray(K4)))
    for i, xi in enumerate(XIS):
        w2c = np.asarray(j_se3_matrix(j_se3_exp(jnp.asarray(xi))),
                         np.float32)
        jb.add_keyframe(i, img, depth, w2c)
    jb.seed(0, pm[::2, ::2], img[::2, ::2].astype(np.float32) / 255.0,
            np.ones((H // 2, W // 2), bool), 0)
    rng = np.random.default_rng(0)
    q = np.asarray(jb.arena.quat)
    q = q + rng.normal(0, 0.2, q.shape).astype(np.float32)
    jb.arena = dataclasses.replace(
        jb.arena, quat=jnp.asarray(q / np.linalg.norm(q, axis=1,
                                                      keepdims=True)),
        log_scales=jb.arena.log_scales + jnp.asarray(rng.normal(
            0, 0.1, jb.arena.log_scales.shape), jnp.float32))
    path = str(tmp_path / "state.npz")
    jb.save(path)
    tkw = {k: v for k, v in jkw.items() if k in MappingConfig.__annotations__}
    tb = MappingBackend(MappingConfig(**CFG, **tkw), K4, device="cpu")
    tb.load(path)
    return jb, tb


def jax_gba_draws(view_ids, total, k, m, seg, capacity, rng=None):
    """The draws JAX ``global_ba_steps`` makes (mapping.py:1153-1178) from
    ``rng`` (a fresh backend's PRNGKey(0) by default): per segment a
    (blocks per segment, k) array of distinct views a block, the densify
    split noise, and the backend's key afterwards."""
    n_steps = max(1, -(-total // k))
    bps = max(1, seg // m)
    n_segs = max(1, -(-max(1, -(-n_steps // m)) // bps))
    ids = jnp.asarray(view_ids, jnp.int32)
    rng = jax.random.PRNGKey(0) if rng is None else rng
    views, noise = [], None
    for s in range(n_segs):
        rng, k1, _ = jax.random.split(rng, 3)
        keys = jax.random.split(k1, bps)
        views.append(np.asarray(jax.vmap(lambda kk: jax.random.choice(
            kk, ids, shape=(k,), replace=False))(keys)))
        if s == max(n_segs // 2 - 1, 0):
            rng, k3 = jax.random.split(rng)
            noise = np.asarray(jax.random.normal(k3, (capacity, 3)))
    return views, noise, rng


def _lr_units(jb, tb, skip=()):
    alive = np.asarray(jb.arena.alive)
    np.testing.assert_array_equal(tb.arena.alive.numpy(), alive)
    for k, lr in tb._lrs().items():
        if k in skip:
            continue
        err = np.abs(np.asarray(getattr(jb.arena, k))[alive]
                     - getattr(tb.arena, k).numpy()[alive]) / lr
        q50, q90 = np.quantile(err, [0.5, 0.9])
        assert q50 < 0.1 and q90 < 1.5 and err.max() < 20, \
            (k, q50, q90, err.max())


def test_pose_refine_multi_matches_jax(tmp_path):
    jb, tb = _state(tmp_path, raster_backend="xla")
    idxs = [1, 2, 3]
    jp, jv = jb.pose_refine_multi(idxs)
    tp, tv = tb.pose_refine_multi(idxs)
    w2c_t, w2c_j = tb.cams.w2c.numpy()[idxs], np.asarray(jb.cams.w2c)[idxs]
    assert np.abs(w2c_t - tb.cams.w2c.numpy()[0]).max() > 1e-3  # moved
    np.testing.assert_allclose(w2c_t, w2c_j, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(
        tb.cams.depth.float().numpy()[idxs],
        np.asarray(jb.cams.depth.astype(jnp.float32))[idxs], rtol=2 ** -8)


def test_pose_refine_multi_is_each_views_refine(tmp_path):
    """The batched problem is the single-view problems side by side: each
    view refined alone from the same state ends where the batch does."""
    _, tb = _state(tmp_path, raster_backend="xla")
    path = str(tmp_path / "port.npz")
    tb.save(path)
    pm, _ = tb.pose_refine_multi([1, 2, 3])
    for j, i in enumerate((1, 2, 3)):
        one = MappingBackend(tb.cfg, K4, device="cpu")
        one.load(path)
        p1, _ = one.pose_refine(i)
        np.testing.assert_allclose(one.cams.w2c[i].numpy(),
                                   tb.cams.w2c[i].numpy(), atol=1e-6)
        np.testing.assert_allclose(p1.numpy(), pm[j].numpy(), atol=1e-5)
