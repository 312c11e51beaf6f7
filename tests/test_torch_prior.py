"""The mono prior of the port vs the JAX package on the CPU: ``PriorNet``
(depth and normal, at depth 2 and 4: the hook clamp fills four pyramid
slots from two blocks) from the same seeded params carried through
``models/convert.params_from_jax``, and ``SLAMSystem`` with
``motion_filter.use_prior`` on both packages at ``CUT3RConfig.tiny()``
over a handful of frames, the prior nets' weights read by both from one
``prior_ckpt`` npz written from the JAX params: equal keyframe
timestamps and agreeing prior buffers, which ``reset_state`` keeps.

Tolerance: 1e-4 absolute + 1e-4 relative per element (f32 on both
sides, differing in summation order), the tolerance of
tests/test_torch_cut3r.py.

The JAX params come from ``jax.eval_shape(model.init)`` filled from
numpy (``jax_random_params``; an eager flax ``init`` costs ~70 s here).
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
from cut3r_slam_tpu.models.priors import (PriorNet as JPriorNet,
                                          normalize_imagenet as j_norm)
from cut3r_slam_tpu.slam.system import SLAMSystem as JSLAM
from cut3r_slam_tpu_torch.models.convert import params_from_jax
from cut3r_slam_tpu_torch.models.priors import PriorNet, normalize_imagenet
from cut3r_slam_tpu_torch.slam.system import SLAMSystem, build_prior_fns

from test_torch_cut3r_train import (few_threads, jax_params,  # noqa: F401
                                    jax_tiny_params, torch_from_flat)

H, W = 32, 48
TOL = dict(atol=1e-4, rtol=1e-4)
DIM, HEADS = 64, 2


def fill_params(shapes, seed=0):
    """A flax param tree of ``shapes`` (``jax.eval_shape`` of an init)
    filled from numpy as tests/test_torch_cut3r_train.py fills CUT3R's:
    N(0, 1 / fan_in) kernels, 1 + N(0, 0.02) scales, N(0, 0.02) else.
    Returns the flat ``/``-joined dict of numpy arrays."""
    flat = flatten_dict(unfreeze(shapes["params"]), sep="/")
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(flat):
        shp, leaf = flat[k].shape, k.rsplit("/", 1)[-1]
        z = rng.standard_normal(shp)
        if leaf == "kernel":
            v = z / math.sqrt(math.prod(shp[:-1]))
        else:
            v = (leaf == "scale") + 0.02 * z
        out[k] = v.astype(np.float32)
    return out


def jax_random_params(model, *args, seed=0, **kw):
    """Seeded params of a flax ``model`` at the inputs ``args`` (nothing
    compiled or run)."""
    return fill_params(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                      *args, **kw), seed)


def as_jax(flat):
    return {"params": unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                      for k, v in flat.items()})}


def _image(seed, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def prior_params(task, depth, seed):
    return jax_random_params(JPriorNet(task, DIM, depth, HEADS),
                             jnp.zeros((1, H, W, 3)), seed=seed)


@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("task", ["depth", "normal"])
def test_priornet_matches_jax(task, depth):
    flat = prior_params(task, depth, seed=depth)
    img = _image(depth)
    want = np.asarray(JPriorNet(task, DIM, depth, HEADS).apply(
        as_jax(flat), j_norm(jnp.asarray(img))[None]))
    net = PriorNet(task, DIM, depth, HEADS, device="cpu")
    net.load_state_dict(params_from_jax(flat), strict=True)
    with torch.no_grad():
        got = net(normalize_imagenet(torch.from_numpy(img))[None]).numpy()
    assert got.shape == want.shape == ((1, H, W) if task == "depth"
                                       else (1, H, W, 3))
    np.testing.assert_allclose(got, want, **TOL)
    if task == "depth":
        assert (got > 0).all()
    else:
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-5)


N_FRAMES = 8
CFG = {"Tracking": {"motion_filter": {"kf_every": 2, "use_prior": True,
                                      "prior_dim": DIM,
                                      "prior_depth_blocks": 2}},
       "keep_all_frames": False}


def _frames():
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, size=(H, W + 2 * N_FRAMES, 3))
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3.0
    base = base.astype(np.uint8)
    return [np.ascontiguousarray(base[:, 2 * i:2 * i + W])
            for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """Both SLAMSystems with the prior on (no mapping, no loop closure),
    driven over the same frames, the prior nets from one npz."""
    root = tmp_path_factory.mktemp("prior")
    npz = {f"{task}/{k}": v for seed, task in enumerate(("depth", "normal"))
           for k, v in prior_params(task, 2, 10 + seed).items()}
    ckpt = str(root / "prior.npz")
    np.savez(ckpt, **npz)
    cfg = {**CFG, "Tracking": {"motion_filter": {
        **CFG["Tracking"]["motion_filter"], "prior_ckpt": ckpt}}}
    flat = jax_tiny_params()
    js = JSLAM(JCUT3R(JConfig.tiny()), jax_params(flat), cfg, buffer=16,
               img_hw=(H, W), enable_mapping=False, enable_loop=False,
               output_dir=str(root / "jax"))
    ts = SLAMSystem(torch_from_flat(flat), cfg, buffer=16, img_hw=(H, W),
                    enable_mapping=False, enable_loop=False,
                    output_dir=str(root / "torch"), device="cpu")
    for t, f in enumerate(_frames()):
        for s in (js, ts):
            s.run(t, f, np.float32([40, 40, W / 2, H / 2]),
                  last=(t == N_FRAMES - 1))
    return js, ts


def test_live_loop_priors_match_jax(systems):
    js, ts = systems
    n = js.keyframes.count
    assert ts.keyframes.count == n >= 4
    np.testing.assert_array_equal(ts.keyframes.tstamp, js.keyframes.tstamp)
    kt, kj = ts.keyframes, js.keyframes
    depth, normal = kt.prior_depth.cpu().numpy(), kt.prior_normal.cpu().numpy()
    np.testing.assert_allclose(depth, kj.prior_depth, **TOL)
    np.testing.assert_allclose(normal, kj.prior_normal, **TOL)
    assert (depth[:n] > 0).all() and not depth[n:].any()
    np.testing.assert_allclose(np.linalg.norm(normal[:n], axis=-1),
                               1.0, atol=1e-5)


def test_reset_state_keeps_the_prior_buffers(systems):
    """``reset_state`` gives both packages a fresh store with empty prior
    buffers, which the next keyframe fills."""
    js, ts = systems
    img = _frames()[0]
    for s in (js, ts):
        s.reset_state()
        kf = s.keyframes
        assert tuple(kf.prior_depth.shape) == (16, H, W)
        assert tuple(kf.prior_normal.shape) == (16, H, W, 3)
        assert not kf.prior_depth.any() and not kf.prior_normal.any()
        s.run(0, img, np.float32([40, 40, W / 2, H / 2]))
    np.testing.assert_allclose(ts.keyframes.prior_depth[0].cpu().numpy(),
                               js.keyframes.prior_depth[0], **TOL)
    assert (ts.keyframes.prior_depth[0] > 0).all()


def test_random_init_prior():
    """Without ``prior_ckpt`` the prior nets are ``init_random`` draws of
    the configured size (the JAX package draws flax's init; the draws
    differ): positive depths, unit normals, one net per task."""
    d_fn, n_fn = build_prior_fns({"prior_dim": DIM,
                                  "prior_depth_blocks": 3}, (H, W), "cpu")
    net = d_fn.__defaults__[0]
    assert len(net.blocks) == 3 and net.blocks[0].attn.num_heads == 1
    with torch.no_grad():
        d, n = d_fn(_image(3)), n_fn(_image(3))
        other = d_fn(_image(4))
    assert d.shape == (H, W) and (d > 0).all()
    np.testing.assert_allclose(n.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    assert torch.isfinite(d).all() and not torch.equal(d, other)
