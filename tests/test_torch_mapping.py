"""Mapping port vs the JAX MappingBackend on CPU: one mapping event
(``MappingBackend.run``) on the synthetic plane of tests/test_mapping.py,
JAX on its CPU XLA backend and the port on CPU (plain blend), with the
JAX package's global-BA view draws and densify split noise injected into
the port. Also: a JAX ``save`` npz round-trips through the port's
``load``/``save``.

Tolerances: both sides render in f32 and differ only in summation order
(from identical states one pose refinement agrees to 5e-8), but the
event is chaotic at that level: Adam normalizes each gradient entry, so
entries whose gradient sits at float noise take different steps, and the
alpha > 0.5 / depth masks of the losses are discontinuous. So segment
losses are held to 1e-3 relative, arena parameters in units of their
learning rate (median < 0.1 lr, 90th percentile < 1.5 lr, max < 20 lr
over the event's ~14 Adam steps) and poses / writeback to 2e-2.
"""
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
from cut3r_slam_tpu_torch import full_f32
from cut3r_slam_tpu_torch.slam.mapping import MappingBackend, MappingConfig

from test_torch_cut3r_train import few_threads  # noqa: F401

H, W = 32, 32
K4 = np.array([40.0, 40.0, W / 2, H / 2], np.float32)
CFG = dict(height=H, width=W, capacity=2048, cam_capacity=8, window_size=3,
           pose_refine_iters=4, opt_segment=2, window_opt_iters=4,
           new_view_opt_iters=2, gba_per_view=2, gba_segment=2,
           max_per_tile=256)
ITERS = 4


def _make_scene():
    """Textured fronto-parallel plane at z=2 with a bump
    (tests/test_mapping.py:22-32)."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = np.stack([(np.sin(xx / 3.0) * 0.5 + 0.5),
                    (np.cos(yy / 4.0) * 0.5 + 0.5),
                    ((xx + yy) % 7) / 7.0], axis=-1)
    depth = 2.0 + 0.2 * np.sin(xx / 5.0).astype(np.float32)
    return (img * 255).astype(np.uint8), depth.astype(np.float32)


def _packet():
    img, depth = _make_scene()
    pm = np.asarray(j_d2p(jnp.asarray(depth), jnp.asarray(K4)))
    d2 = np.asarray(j_se3_matrix(j_se3_exp(jnp.asarray(
        [0.01, -0.01, 0.02, 0.01, 0.0, -0.01]))), np.float32)
    return {"viz_idx": [0, 1], "images": np.stack([img, img]),
            "depths": np.stack([depth, depth]),
            "pointmaps": np.stack([pm[::2, ::2]] * 2),
            "confs": np.ones((2, H // 2, W // 2), np.float32),
            "w2c": np.stack([np.eye(4, dtype=np.float32), d2]),
            "submap_idx": 0, "tstamp": np.asarray([0, 1])}


def _jax_gba_draws(n_views, capacity):
    """The draws JAX global_ba_steps makes for one event (mapping.py:
    1159-1178): per-segment view choices and the densify noise."""
    seg = CFG["gba_segment"]
    total = CFG["gba_per_view"] * n_views
    n_segs = max(1, (total + seg - 1) // seg)
    ids = jnp.arange(n_views, dtype=jnp.int32)
    rng = jax.random.PRNGKey(0)
    views, noise = [], None
    for s in range(n_segs):
        rng, k1, _ = jax.random.split(rng, 3)
        keys = jax.random.split(k1, seg)
        views.append(np.asarray(jax.vmap(lambda kk: jax.random.choice(
            kk, ids, shape=(1,), replace=False))(keys)))
        if s == max(n_segs // 2 - 1, 0):
            rng, k3 = jax.random.split(rng)
            noise = np.asarray(jax.random.normal(k3, (capacity, 3)))
    return views, noise


def _drain(gen):
    ys = []
    while True:
        try:
            ys.append(next(gen))
        except StopIteration as e:
            return ys, e.value


@pytest.fixture(scope="module")
def event():
    jb = JBackend(JConfig(raster_backend="xla", **CFG), K4)
    j_yields, j_upd = _drain(jb.run_steps(_packet(), ITERS))
    views, noise = _jax_gba_draws(2, CFG["capacity"])
    tb = MappingBackend(MappingConfig(**CFG), K4, device="cpu")
    t_yields, t_upd = _drain(tb.run_steps(_packet(), ITERS, view_idx=views,
                                          split_noise=noise))
    return jb, j_yields, j_upd, tb, t_yields, t_upd


def test_mapping_event_loss_trace(event):
    jb, j_yields, _, tb, t_yields, _ = event
    jl = [y for y in j_yields if isinstance(y, float)]
    tl = [y for y in t_yields if isinstance(y, float)]
    # init view 2 segments, new view 2 window + 1 polish segment
    assert len(jl) == len(tl) == 5, (jl, tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


def test_mapping_event_final_state(event):
    jb, _, j_upd, tb, _, t_upd = event
    alive_j = np.asarray(jb.arena.alive)
    np.testing.assert_array_equal(tb.arena.alive.numpy(), alive_j)
    assert alive_j.sum() > 256
    for k, lr in tb._lrs().items():
        a = np.asarray(getattr(jb.arena, k))[alive_j]
        b = getattr(tb.arena, k).numpy()[alive_j]
        err = np.abs(a - b) / lr
        q50, q90 = np.quantile(err, [0.5, 0.9])
        assert q50 < 0.1 and q90 < 1.5 and err.max() < 20, \
            (k, q50, q90, err.max())
    np.testing.assert_allclose(tb.cams.w2c.numpy(), np.asarray(jb.cams.w2c),
                               atol=2e-2)
    np.testing.assert_allclose(t_upd["depths"], j_upd["depths"], atol=2e-2)
    np.testing.assert_allclose(t_upd["c2w"], j_upd["c2w"], atol=2e-2)
    assert t_upd["window"] == j_upd["window"]


def test_save_load_round_trip(event, tmp_path):
    """State carried across: JAX save -> port load -> port save -> JAX
    load reproduces every array."""
    jb = event[0]
    p1, p2 = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jb.save(p1)
    tb = MappingBackend(MappingConfig(**CFG), K4, device="cpu")
    tb.load(p1)
    assert tb.current_window == jb.current_window
    assert tb.initialized == jb.initialized
    np.testing.assert_array_equal(tb.arena.xyz.numpy(),
                                  np.asarray(jb.arena.xyz))
    tb.save(p2)
    a, b = np.load(p1), np.load(p2)
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_data_update_keeps_every_window_view(event):
    """Deliberate divergence (ROADMAP §3): the JAX data_update pads or cuts
    its batch to window_size (mapping.py:1211), so a longer window loses
    writebacks; the port renders every view it is given."""
    tb = event[3]
    upd = tb.data_update([0, 1, 0, 1])
    assert len(upd["depths"]) == len(upd["c2w"]) == 4 > CFG["window_size"]
    np.testing.assert_allclose(upd["depths"][2], upd["depths"][0])


def test_gaussian_update_matches_jax(event, tmp_path):
    """Loop-closure writeback from one state on both sides (the JAX
    backend after the event, carried to the port through ``save`` /
    ``load``): half the alive Gaussians relabelled to submap 1, updates for
    submaps 1 and 2 (2 matches none), new w2c for both cameras, then the
    rigid move and each camera's pose refinement. Moved parameters agree
    to 1e-6; the refined poses to 1e-5 (one pose refinement from one
    state agrees to 5e-8 in f32; four are chained here)."""
    import dataclasses
    jb = event[0]
    saved = (jb.arena, jb.adam, jb.cams)
    try:
        alive = np.asarray(jb.arena.alive)
        kf_id = np.asarray(jb.arena.kf_id).copy()
        kf_id[np.flatnonzero(alive)[::2]] = 1
        jb.arena = dataclasses.replace(jb.arena, kf_id=jnp.asarray(kf_id))
        path = str(tmp_path / "state.npz")
        jb.save(path)
        tb = MappingBackend(MappingConfig(**CFG), K4, device="cpu")
        tb.load(path)
        upd = np.zeros((2, 7), np.float32)
        upd[:, :3] = [[0.02, -0.01, 0.015], [5.0, 5.0, 5.0]]
        q = np.asarray([0.01, -0.02, 0.015, 1.0], np.float32)
        upd[:, 3:] = q / np.linalg.norm(q)
        w2c = np.asarray(jb.cams.w2c)[:2].copy()
        w2c[:, :3, 3] += [[0.01, 0.0, -0.01], [0.0, 0.01, 0.0]]
        args = ([1, 2], upd, [0, 1], list(w2c))
        m_before = tb.adam.m["xyz"].clone()
        jb.gaussian_update(*args)
        tb.gaussian_update(*args)
        moved = kf_id == 1
        assert moved.sum() > 100
        for k, tol in (("xyz", 1e-6), ("quat", 1e-6)):
            a = getattr(tb.arena, k).numpy()
            b = np.asarray(getattr(jb.arena, k))
            np.testing.assert_allclose(a[alive], b[alive], atol=tol, err_msg=k)
        still = alive & ~moved
        np.testing.assert_array_equal(tb.adam.m["xyz"].numpy()[still],
                                      m_before.numpy()[still])
        assert np.abs(m_before.numpy()[moved]).max() > 0
        for d in (tb.adam.m, tb.adam.v):
            for k, x in d.items():
                assert not x.numpy()[moved].any(), k
                np.testing.assert_array_equal(
                    x.numpy()[moved],
                    np.asarray((jb.adam[0] if d is tb.adam.m
                                else jb.adam[1])[k])[moved])
        np.testing.assert_allclose(tb.cams.w2c.numpy()[:2],
                                   np.asarray(jb.cams.w2c)[:2], atol=1e-5)
        assert np.abs(tb.cams.w2c.numpy()[:2] - w2c).max() > 1e-6
    finally:
        jb.arena, jb.adam, jb.cams = saved


@pytest.mark.parametrize("caller", [True, False])
def test_mapping_leaves_tf32_settings_alone(caller):
    """TF32 is off only inside the mapping path's renders and losses
    (``full_f32``); building a backend and leaving the block restore the
    caller's process-wide settings, whatever they were."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = caller
        MappingBackend(MappingConfig(**CFG), K4, device="cpu")
        assert [f.allow_tf32 for f in flags] == [caller, caller]
        with full_f32():
            assert [f.allow_tf32 for f in flags] == [False, False]
        assert [f.allow_tf32 for f in flags] == [caller, caller]
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b
