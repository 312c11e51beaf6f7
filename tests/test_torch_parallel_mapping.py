"""View-parallel mapping (``parallel/mapping.py``) at world size 2 over
gloo on the CPU, mirroring the five cases of tests/test_parallel_mapping.py
on the same state (256 random Gaussians, four views of 32x48; the
Gaussians' scales and rotations jittered, see ``_state``):

* the window optimization with poses over four views (two a rank) and
  over three (uneven shards: two and one), and without poses;
* the global-BA batch (k 4, segment 3, 12 renders) with the JAX package's
  view draws injected;
* the batched refinement of three views (two and one).

Each is held to the JAX package's ``MappingBackend`` built on a 2-device
``mv`` mesh and to the port's sequential path, at the JAX suite's
tolerances (loss rtol 2e-4 / atol 2e-5, arena rtol 2e-3 / atol 2e-5,
w2c rtol 1e-4 / atol 1e-5), and the two ranks' arenas and camera buffers
are bitwise equal. The JAX references run in the test process; the ranks
never import JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cut3r_slam_tpu_torch.parallel import make_mesh
from cut3r_slam_tpu_torch.slam.mapping import MappingBackend, MappingConfig
from test_torch_parallel_mesh import few_threads, run_world, \
    wait  # noqa: F401

H, W = 32, 48
N_GAUSS = 256
N_CAMS = 4
K4 = np.asarray([0.9 * W, 0.9 * W, W / 2, H / 2], np.float32)
CASES = {
    # name: (window_size, window, optimize_pose)
    "window4": (4, [0, 1, 2, 3], True),
    "window3_uneven": (3, [0, 1, 2], True),
    "no_pose": (4, [0, 1], False),
}
GBA = dict(gba_views_per_iter=4, gba_segment=3)
GBA_RENDERS = 12
REFINE = [0, 1, 2]
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
ARENA_TOL = dict(rtol=2e-3, atol=2e-5)
W2C_TOL = dict(rtol=1e-4, atol=1e-5)
KEYS = ("xyz", "f_dc", "opacity_logit", "log_scales", "quat")


def _cfg(window_size, **kw):
    return dict(height=H, width=W, capacity=N_GAUSS, cam_capacity=8,
                window_size=window_size, opt_segment=4, max_per_tile=64,
                **kw)


def _state(jitter=True):
    """tests/test_parallel_mapping.py's arena and views, as numpy; with
    ``jitter`` (the cases that optimize the Gaussians) a seeded jitter of
    their scales and rotations, as in tests/test_torch_batched_mapping.py:
    the rotation gradient of an isotropic Gaussian is zero up to rounding,
    which Adam turns into full steps of either sign, so two
    implementations' rotations would differ by whole learning rates
    there. The refinement moves poses only and runs on the JAX suite's
    state as it is."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1.5, 1.5, (N_GAUSS, 3)).astype(np.float32)
    xyz[:, 2] += 3.0
    f_dc = rng.uniform(-0.3, 0.3, (N_GAUSS, 3)).astype(np.float32)
    jit = np.random.default_rng(1)
    q = np.float32([1, 0, 0, 0]) + jit.normal(0, 0.2, (N_GAUSS, 4))
    arena = dict(xyz=xyz, f_dc=f_dc,
                 opacity_logit=np.zeros(N_GAUSS, np.float32),
                 log_scales=np.full((N_GAUSS, 3), -2.5, np.float32),
                 quat=np.tile(np.float32([1, 0, 0, 0]), (N_GAUSS, 1)))
    if jitter:
        arena["log_scales"] = (arena["log_scales"] + jit.normal(
            0, 0.1, (N_GAUSS, 3))).astype(np.float32)
        arena["quat"] = (q / np.linalg.norm(q, axis=1, keepdims=True)) \
            .astype(np.float32)
    views = []
    for i in range(N_CAMS):
        img = rng.uniform(0, 255, (H, W, 3)).astype(np.uint8)
        depth = rng.uniform(2.0, 4.0, (H, W)).astype(np.float32)
        w2c = np.eye(4, dtype=np.float32)
        w2c[0, 3] = 0.05 * i
        views.append((img, depth, w2c))
    return arena, views


def _port(cfg, mesh=None, jitter=True):
    arena, views = _state(jitter)
    be = MappingBackend(MappingConfig(**cfg), K4, device="cpu", mesh=mesh)
    for k, v in arena.items():
        getattr(be.arena, k).copy_(torch.as_tensor(v))
    be.arena.alive.fill_(True)
    for i, (img, depth, w2c) in enumerate(views):
        be.add_keyframe(i, img, depth, w2c)
    return be


def _snapshot(be, **extra):
    out = {k: getattr(be.arena, k).clone() for k in KEYS}
    out.update(w2c=be.cams.w2c.clone(), exp_a=be.cams.exposure_a.clone(),
               depth=be.cams.depth.float().clone(),
               grad_accum=be.arena.grad_accum.clone())
    out.update(extra)
    return out


def _run_cases(mesh, gba_views):
    """Every case on fresh backends (``mesh`` None: the sequential path)."""
    res = {}
    for name, (ws, window, pose) in CASES.items():
        be = _port(_cfg(ws), mesh)
        loss = be.optimization(4, window, optimize_pose=pose)
        res[name] = _snapshot(be, loss=float(loss))
    be = _port(_cfg(4, **GBA), mesh)
    be.global_ba(GBA_RENDERS, densify=False, view_idx=gba_views)
    res["gba"] = _snapshot(be, k=be.gba_plan(GBA_RENDERS, N_CAMS)[0])
    be = _port(_cfg(4), mesh, jitter=False)
    pm, val = be.pose_refine_multi(REFINE)
    res["refine"] = _snapshot(be, pm=pm.clone(), val=val.clone())
    return res


def _mapping_worker(rank, world, gba_views, out):
    mesh = make_mesh(world, axes=("mv",))
    torch.save(_run_cases(mesh, gba_views), f"{out}/map{rank}.pt")


def _jax_gba_views():
    from test_torch_batched_mapping import jax_gba_draws
    views, _, _ = jax_gba_draws(list(range(N_CAMS)), GBA_RENDERS,
                                GBA["gba_views_per_iter"], 1,
                                GBA["gba_segment"], N_GAUSS)
    return views


def _jax_refs():
    """The JAX package's mesh path on every case."""
    import jax.numpy as jnp
    from cut3r_slam_tpu.parallel import make_mesh as j_make_mesh
    from cut3r_slam_tpu.slam.mapping import (MappingBackend as JBackend,
                                             MappingConfig as JConfig)
    mesh = j_make_mesh(2, axes=("mv",), shape=(2,))

    def backend(cfg, jitter=True):
        arena, views = _state(jitter)
        jb = JBackend(JConfig(raster_backend="xla", **cfg), K4, mesh=mesh)
        jb.arena = dataclasses.replace(
            jb.arena, **{k: jnp.asarray(v) for k, v in arena.items()},
            alive=jnp.ones((N_GAUSS,), bool))
        for i, (img, depth, w2c) in enumerate(views):
            jb.add_keyframe(i, img, depth, w2c)
        return jb

    def snap(jb, **extra):
        out = {k: np.asarray(getattr(jb.arena, k)) for k in KEYS}
        out.update(w2c=np.asarray(jb.cams.w2c),
                   exp_a=np.asarray(jb.cams.exposure_a),
                   grad_accum=np.asarray(jb.arena.grad_accum))
        out.update(extra)
        return out

    res = {}
    for name, (ws, window, pose) in CASES.items():
        jb = backend(_cfg(ws))
        loss = jb.optimization(4, window, optimize_pose=pose)
        res[name] = snap(jb, loss=float(loss))
    jb = backend(_cfg(4, **GBA))
    jb.global_ba(GBA_RENDERS, densify=False)
    res["gba"] = snap(jb)
    jb = backend(_cfg(4), jitter=False)
    pm, val = jb.pose_refine_multi(REFINE)
    res["refine"] = snap(jb, pm=np.asarray(pm), val=np.asarray(val))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_mapping")
    views = _jax_gba_views()
    ranks = run_world(_mapping_worker, tmp, views, str(tmp), join=False)
    jax_res = _jax_refs()
    seq = _run_cases(None, views)
    wait(ranks)
    ranks = [torch.load(tmp / f"map{r}.pt", weights_only=False)
             for r in range(2)]
    return jax_res, seq, ranks


@pytest.mark.parametrize("case", list(CASES) + ["gba", "refine"])
def test_ranks_bitwise_equal(runs, case):
    _, _, (r0, r1) = runs
    for k, v in r0[case].items():
        if torch.is_tensor(v):
            assert torch.equal(v, r1[case][k]), (case, k)
        else:
            assert v == r1[case][k], (case, k)


def _close(got, want, case, n_views):
    for k in KEYS:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   err_msg=f"{case}: arena {k}", **ARENA_TOL)
    np.testing.assert_allclose(np.asarray(got["w2c"][:n_views]),
                               np.asarray(want["w2c"][:n_views]),
                               err_msg=f"{case}: w2c", **W2C_TOL)
    np.testing.assert_allclose(np.asarray(got["exp_a"][:n_views]),
                               np.asarray(want["exp_a"][:n_views]),
                               err_msg=f"{case}: exposure", **W2C_TOL)
    if "loss" in want:
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   err_msg=f"{case}: loss", **LOSS_TOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["jax", "sequential"])
def test_window_optimization(runs, case, ref):
    jax_res, seq, (r0, _) = runs
    want = jax_res[case] if ref == "jax" else seq[case]
    assert np.isfinite(r0[case]["loss"])
    _close(r0[case], want, case, len(CASES[case][1]))
    moved = np.abs(r0[case]["xyz"].numpy() - _state()[0]["xyz"]).max()
    assert moved > 1e-5


@pytest.mark.parametrize("ref", ["jax", "sequential"])
def test_gba_batch(runs, ref):
    """k = 4 views a step, two a rank; gradient sums, densification
    statistics and radii reduced over the ranks."""
    jax_res, seq, (r0, _) = runs
    assert r0["gba"]["k"] == 4
    want = jax_res["gba"] if ref == "jax" else seq["gba"]
    _close(r0["gba"], want, "gba", N_CAMS)
    np.testing.assert_allclose(r0["gba"]["grad_accum"].numpy(),
                               np.asarray(want["grad_accum"]), rtol=2e-3,
                               atol=2e-6)


@pytest.mark.parametrize("ref", ["jax", "sequential"])
def test_pose_refine(runs, ref):
    jax_res, seq, (r0, _) = runs
    want = jax_res["refine"] if ref == "jax" else seq["refine"]
    got = r0["refine"]
    np.testing.assert_allclose(got["w2c"][:3].numpy(),
                               np.asarray(want["w2c"][:3]), **W2C_TOL)
    np.testing.assert_allclose(got["pm"].numpy(), np.asarray(want["pm"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["val"].numpy(),
                                  np.asarray(want["val"]))
    if ref == "sequential":
        np.testing.assert_allclose(got["depth"][:3].numpy(),
                                   want["depth"][:3].numpy(), rtol=1e-2)
