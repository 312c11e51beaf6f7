"""Batched global BA of the port vs the JAX MappingBackend on the CPU,
from the state of tests/test_torch_batched_mapping.py (the JAX backend's
``save`` loaded by the port).

* ``global_ba_steps`` with 2 views a step in blocks of 2 steps sharing one
  binning, with the JAX view draws and split noise injected, against the
  JAX package's Pallas path in interpret mode (the only JAX path that
  caches block bins, and the port's rasterizer semantics) and its XLA
  path (which re-bins every render; on this scene the cached and the
  fresh bins render alike: the port's first segment loss equals XLA's to
  2e-7). Segment losses to 1e-3 relative against XLA and to 1e-2 against
  Pallas, whose batch drops the isotropy term's scale gradient
  (test_gba_iso_gradient_kept; its losses part from XLA's by 2.4e-3 over
  the first segment here). Arena parameters in units of their learning
  rate (median < 0.1 lr, 90th percentile < 1.5 lr, max < 20 lr, as in
  tests/test_torch_mapping.py; against Pallas all but the log-scales),
  poses and exposures to 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cut3r_slam_tpu.geometry.lie import se3_exp as j_se3_exp, \
    se3_matrix as j_se3_matrix
from cut3r_slam_tpu_torch.slam.mapping import MappingBackend, MappingConfig
from test_torch_batched_mapping import (CFG, GBA, K4, XIS,  # noqa: F401
                                        _lr_units, _make_scene, _state,
                                        few_threads, jax_gba_draws)


@pytest.mark.parametrize("backend, rtol", [("pallas", 1e-2), ("xla", 1e-3)])
def test_global_ba_blocks_match_jax(backend, rtol, tmp_path):
    jkw = {"raster_backend": backend, "raster_interpret": backend == "pallas"}
    jb, tb = _state(tmp_path, **jkw, **GBA)
    total = 16   # 8 steps of 2 views, 4 blocks of 2, 2 segments
    views, noise, _ = jax_gba_draws([0, 1, 2, 3], total, 2, 2,
                                    GBA["gba_segment"], CFG["capacity"])
    assert [v.shape for v in views] == [(2, 2)] * 2
    assert tb.gba_plan(total, 4) == (2, 2, 2, 2)
    j_losses = []
    seg = jb._gba_segment
    jb._gba_segment = lambda *a: (lambda out: j_losses.append(float(
        out[-1])) or out)(seg(*a))
    jb.global_ba(total, densify=True)
    tb.global_ba(total, densify=True, view_idx=views, split_noise=noise)
    t_losses = [float(x.mean()) for x in tb.gba_losses]
    assert [len(x) for x in tb.gba_losses] == [4, 4]
    np.testing.assert_allclose(t_losses, j_losses, rtol=rtol)
    # the JAX Pallas batch drops the isotropy term's scale gradient
    # (test_gba_iso_gradient_kept)
    _lr_units(jb, tb, skip=("log_scales",) if backend == "pallas" else ())
    for k in ("w2c", "exposure_a", "exposure_b"):
        np.testing.assert_allclose(getattr(tb.cams, k).numpy(),
                                   np.asarray(getattr(jb.cams, k)),
                                   atol=2e-2, err_msg=k)
    assert np.abs(tb.cams.w2c.numpy()[:4] - np.asarray(
        [np.asarray(j_se3_matrix(j_se3_exp(jnp.asarray(xi))))
         for xi in XIS])).max() > 1e-5   # the poses moved


def test_gba_iso_gradient_kept(tmp_path):
    """Deliberate divergence (ROADMAP §3): the JAX Pallas global-BA batch
    (``gba_batch_fused``, mapping.py:747) takes the isotropy term's scales
    from the enclosing function's params, not the differentiated ones, so
    its log-scale gradient lacks that term; its XLA batch and the port
    keep it. One batch from one state: the port's gradients equal the XLA
    batch's to 1e-5 of their scale, and the Pallas batch's log-scale
    gradient is off by far more."""
    from cut3r_slam_tpu_torch.geometry.pointmap import depth_to_normal
    vi = [1, 2]
    grads = {}
    for backend in ("pallas", "xla"):
        jb, tb = _state(tmp_path, raster_backend=backend,
                        raster_interpret=backend == "pallas", **GBA)
        out = jb._gba_batch(jb.arena.params(), jb.arena.alive, jb.cams.image,
                            jb.cams.depth, jb.cams.w2c, jb.cams.exposure_a,
                            jb.cams.exposure_b, jnp.asarray(vi, jnp.int32))
        grads[backend] = out[1]
    arena_b, _ = tb._sliced()
    n = arena_b.xyz.shape[0]
    ti = torch.tensor(vi)
    _, gp, _, _, _, _, _ = tb._gba_batch(
        arena_b.params(), arena_b.alive, tb.cams.w2c, tb.cams.exposure_a,
        tb.cams.exposure_b, ti, depth_to_normal(tb._depth(ti), tb.K4))
    for k in ("xyz", "f_dc", "opacity_logit", "log_scales", "quat"):
        ref = np.asarray(grads["xla"][k])[:n]
        scale = np.abs(ref).max()
        np.testing.assert_allclose(gp[k].numpy() / scale, ref / scale,
                                   atol=1e-5, err_msg=k)
    ref = np.asarray(grads["xla"]["log_scales"])[:n]
    pal = np.asarray(grads["pallas"]["log_scales"])[:n]
    assert np.abs(pal - ref).max() > 0.5 * np.abs(ref).max()


def test_global_ba_draws_distinct_views_per_block():
    """Without injected draws the port draws k distinct views a block from
    its generator, and a whole segment always runs."""
    tb = MappingBackend(MappingConfig(**CFG, **GBA), K4, device="cpu")
    img, depth = _make_scene()
    for i in range(3):
        tb.add_keyframe(i, img, depth, np.eye(4, dtype=np.float32))
    seen = []
    orig = tb._gba_segment
    tb._gba_segment = lambda a, b, vi: seen.append(vi.clone()) or orig(a, b,
                                                                       vi)
    tb.global_ba(3, densify=False)
    assert len(seen) == 1 and seen[0].shape == (2, 2)
    for row in seen[0]:
        assert len(set(row.tolist())) == 2
    assert [len(x) for x in tb.gba_losses] == [4]
