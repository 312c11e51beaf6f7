"""CroCo pretraining and the stereo / flow harness of the port vs the JAX
package on the CPU (f32), at ``CroCoConfig.tiny()`` from the same seeded
params through ``params_from_jax``:

* ``patchify`` / ``unpatchify`` (exact);
* ``CroCoPretrain`` with the JAX model's visible slots injected
  (``vis_idx``: JAX draws them with ``jax.random.permutation``, which the
  port does not reproduce), its mask, target and loss;
* ``CroCoDownstreamBinocular`` and ``laplacian_nll`` (with and without a
  valid mask);
* three ``train_stereoflow`` steps against the JAX harness's optax step:
  the loss of each within 1e-5 relative, the gradient of every tensor
  read from Adam's first moment after the two steps taken at the starting
  weights (the first update is zero by the warmup) as
  tests/test_torch_train_step.py reads it, the parameters after;
* ``tiled_predict`` over a tile grid, ``flow_metrics`` and
  ``evaluate_stereoflow``;
* the pair generators byte-equal on both of ``_warp_perspective``'s
  branches (cv2, and numpy when cv2 does not import: both packages
  pinned to the same one).

Tolerance: 1e-4 absolute + 1e-4 relative on model outputs.
"""
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from cut3r_slam_tpu.datasets import pairs as JP
from cut3r_slam_tpu.models import croco_pretrain as JC
from cut3r_slam_tpu.train import stereoflow as JF
from cut3r_slam_tpu_torch.datasets import pairs as TP
from cut3r_slam_tpu_torch.models import croco_pretrain as TC
from cut3r_slam_tpu_torch.models.convert import params_from_jax
from cut3r_slam_tpu_torch.train import stereoflow as TF
from cut3r_slam_tpu_torch.train.train_step import lr_at

from test_torch_cut3r_train import few_threads  # noqa: F401
from test_torch_prior import as_jax, jax_random_params
from test_torch_train_step import _params_close, adam_mu_jax, grads_close

TOL = dict(atol=1e-4, rtol=1e-4)
B, H, W = 2, 64, 96
JCFG, TCFG = JC.CroCoConfig.tiny(), TC.CroCoConfig.tiny()


def _imgs(seed, shape=(B, H, W, 3)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def test_patchify_matches_jax():
    x = _imgs(0)
    p_j = np.asarray(JC.patchify(jnp.asarray(x), 16))
    p_t = TC.patchify(torch.from_numpy(x), 16)
    np.testing.assert_array_equal(p_t.numpy(), p_j)
    for c in (1, 3, 5):
        y = _imgs(c, (B, 24, 16 * 16 * c))
        np.testing.assert_array_equal(
            TC.unpatchify(torch.from_numpy(y), (64, 96), 16, c).numpy(),
            np.asarray(JC.unpatchify(jnp.asarray(y), (64, 96), 16, c)))
    np.testing.assert_array_equal(
        TC.unpatchify(p_t, (H, W), 16).numpy(), x)


@pytest.fixture(scope="module")
def pretrain():
    jm = JC.CroCoPretrain(JCFG)
    flat = jax_random_params(jm, jnp.zeros((1, H, W, 3)),
                             jnp.zeros((1, H, W, 3)), seed=1)
    tm = TC.CroCoPretrain(TCFG, device="cpu")
    tm.load_state_dict(params_from_jax(flat), strict=True)
    return jm, as_jax(flat), tm


def test_pretrain_with_jax_visible_slots(pretrain):
    jm, params, tm = pretrain
    img1, img2 = _imgs(2), _imgs(3)
    key = jax.random.PRNGKey(7)
    pred_j, mask_j, tgt_j = jax.jit(lambda p, a, b, k: jm.apply(
        p, a, b, rng=k))(params, jnp.asarray(img1), jnp.asarray(img2), key)
    N = (H // 16) * (W // 16)
    n_vis = tm.n_visible(N)
    perm = jax.vmap(lambda k: jax.random.permutation(k, N))(
        jax.random.split(key, B))
    vis_idx = torch.from_numpy(np.asarray(perm[:, :n_vis]).astype(np.int64))
    with torch.no_grad():
        pred_t, mask_t, tgt_t = tm(torch.from_numpy(img1),
                                   torch.from_numpy(img2), vis_idx=vis_idx)
    assert n_vis == round(N * (1 - TCFG.mask_ratio)) == 6
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert int(mask_t.sum()) == B * (N - n_vis)
    np.testing.assert_allclose(tgt_t.numpy(), np.asarray(tgt_j), **TOL)
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), **TOL)
    loss_j = float(JC.croco_pretrain_loss(pred_j, mask_j, tgt_j))
    loss_t = float(TC.croco_pretrain_loss(pred_t, mask_t, tgt_t))
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)


def test_pretrain_draws_and_unmasked_forward(pretrain):
    """The port's own draw from a generator: n_vis distinct slots per
    sample, reproducible; and the unmasked forward matches JAX's."""
    jm, params, tm = pretrain
    a = tm.draw_visible(B, 24, torch.Generator().manual_seed(0))
    b = tm.draw_visible(B, 24, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.shape == (B, 6)
    assert all(len(set(r.tolist())) == 6 for r in a)
    img1, img2 = _imgs(4), _imgs(5)
    pred_j, mask_j, _ = jm.apply(params, jnp.asarray(img1),
                                 jnp.asarray(img2))
    with torch.no_grad():
        pred_t, mask_t, _ = tm(torch.from_numpy(img1), torch.from_numpy(img2))
    assert not mask_t.any() and not np.asarray(mask_j).any()
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), **TOL)


def _flow_pair(rng, h=32, w=32, dx=3, dy=1):
    img = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3.0
    gt = np.broadcast_to(np.float32([dx, dy]), (h, w, 2)).copy()
    return img, np.roll(img, (dy, dx), axis=(0, 1)), gt


def _flow_batches(n, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a, b, g = zip(*[_flow_pair(rng) for _ in range(batch)])
        valid = rng.uniform(size=(batch, 32, 32)) > 0.2
        out.append({"img1": np.stack(a), "img2": np.stack(b),
                    "gt": np.stack(g), "valid": valid})
    return out


@pytest.fixture(scope="module")
def downstream():
    cfg_j = JC.CroCoConfig(enc_embed_dim=48, enc_depth=2, enc_num_heads=2,
                           dec_embed_dim=32, dec_depth=2, dec_num_heads=2)
    cfg_t = TC.CroCoConfig(enc_embed_dim=48, enc_depth=2, enc_num_heads=2,
                           dec_embed_dim=32, dec_depth=2, dec_num_heads=2)
    jm = JC.CroCoDownstreamBinocular(cfg_j, num_channels=2, with_conf=True)
    flat = jax_random_params(jm, jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 32, 32, 3)), seed=2)
    tm = TC.CroCoDownstreamBinocular(cfg_t, 2, True, device="cpu")
    tm.load_state_dict(params_from_jax(flat), strict=True)
    return cfg_j, cfg_t, jm, flat, tm


def test_downstream_and_laplacian_nll(downstream):
    _, _, jm, flat, tm = downstream
    b = _flow_batches(1, seed=3)[0]
    pred_j, conf_j = jm.apply(as_jax(flat), jnp.asarray(b["img1"]),
                              jnp.asarray(b["img2"]))
    with torch.no_grad():
        pred_t, conf_t = tm(torch.from_numpy(b["img1"]),
                            torch.from_numpy(b["img2"]))
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), **TOL)
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j), **TOL)
    gt = torch.from_numpy(b["gt"])
    for valid in (None, b["valid"]):
        l_j = float(JC.laplacian_nll(pred_j, jnp.asarray(b["gt"]), conf_j,
                                     None if valid is None
                                     else jnp.asarray(valid)))
        l_t = float(TC.laplacian_nll(pred_t, gt, conf_t, valid))
        np.testing.assert_allclose(l_t, l_j, rtol=1e-5)


def test_stereoflow_steps_match_optax(downstream):
    """Three steps of the JAX harness's jitted optax step and of the port's
    ``train_stereoflow`` step, from the same weights on the same batches
    (warmup 1: the first update is zero)."""
    cfg_j, cfg_t, jm, flat, _ = downstream
    tcfg_j = JF.StereoFlowConfig(task="flow", lr=1e-3, total_steps=3,
                                 warmup_steps=1, log_every=1)
    tcfg_t = TF.StereoFlowConfig(task="flow", lr=1e-3, total_steps=3,
                                 warmup_steps=1, log_every=1)
    batches = _flow_batches(3, seed=4)
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, tcfg_j.lr, tcfg_j.warmup_steps, max(tcfg_j.total_steps, 2)),
        weight_decay=tcfg_j.weight_decay)
    params = as_jax(flat)
    state = tx.init(params)
    step_j = jax.jit(JF.make_stereoflow_step(jm, tx))
    tm = TC.CroCoDownstreamBinocular(cfg_t, 2, True, device="cpu")
    tm.load_state_dict(params_from_jax(flat), strict=True)
    opt = TF.make_stereoflow_optimizer(tm.parameters(), tcfg_t)
    step_t = TF.make_stereoflow_step(tm, opt)
    losses = []
    for i, b in enumerate(batches):
        params, state, loss_j = step_j(params, state,
                                       {k: jnp.asarray(v)
                                        for k, v in b.items()})
        loss_t = float(step_t(b))
        np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-5)
        losses.append(loss_t)
        if i < 2:
            grads_close(adam_mu_jax(state), tm, opt)
    _params_close(params, tm, [lr_at(i, tcfg_t.lr, 1, 3) for i in range(3)])
    # the loop itself: the same losses, logged every step
    logs = []
    model, logged = TF.train_stereoflow(
        cfg_t, iter(batches), tcfg_t, init_params=params_from_jax(flat),
        log_fn=logs.append, device="cpu")
    np.testing.assert_allclose(logged, losses, rtol=1e-6)
    assert [d["step"] for d in logs] == [0, 1, 2]


def test_tiled_predict_and_metrics(downstream):
    cfg_j, _, jm, flat, tm = downstream
    rng = np.random.default_rng(5)
    i1, i2, gt = _flow_pair(rng, h=48, w=80)
    want = JF.tiled_predict(jm, as_jax(flat), i1, i2, crop=(32, 32),
                            overlap=0.5)
    got = TF.tiled_predict(tm, i1, i2, crop=(32, 32), overlap=0.5)
    assert got.shape == (48, 80, 2) and TF._tile_starts(80, 32, 0.5) == \
        [0, 16, 32, 48]
    np.testing.assert_allclose(got, want, **TOL)
    valid = rng.uniform(size=(48, 80)) > 0.3
    for v in (None, valid):
        assert TF.flow_metrics(got, gt, v) == JF.flow_metrics(got, gt, v)
    pairs = [dict(zip(("img1", "img2", "gt"), _flow_pair(rng)))
             for _ in range(2)]
    e_j = JF.evaluate_stereoflow(jm, as_jax(flat), pairs, crop=(32, 32))
    e_t = TF.evaluate_stereoflow(tm, pairs, crop=(32, 32))
    assert set(e_t) == set(e_j)
    for k in e_j:
        np.testing.assert_allclose(e_t[k], e_j[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("branch", ["cv2", "numpy"])
def test_pairs_byte_equal(branch, monkeypatch):
    if branch == "numpy":   # ``import cv2`` raises in both packages
        monkeypatch.setitem(sys.modules, "cv2", None)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 56, 3), np.uint8)
    depth = rng.uniform(1, 3, (40, 56)).astype(np.float32)
    K4 = np.float32([50, 50, 28, 20])
    for fn, args in ((JP.homography_pair, (img,)),
                     (JP.reprojection_pair, (img, depth, K4))):
        want = fn(*args, np.random.default_rng(1))
        got = getattr(TP, fn.__name__)(*args, np.random.default_rng(1))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    frames = [{"image": rng.integers(0, 256, (40, 56, 3), np.uint8),
               "depth": depth, "K4": K4} for _ in range(3)]
    for synth in (False, True):
        ds_j = JP.PairDataset(frames, gap=1, synth=synth, seed=3)
        ds_t = TP.PairDataset(frames, gap=1, synth=synth, seed=3)
        assert len(ds_t) == len(ds_j) == 2
        res = (32, 48) if branch == "cv2" else None
        b_j = next(JP.make_pair_iter(ds_j, 3, seed=4, resolution=res))
        b_t = next(TP.make_pair_iter(ds_t, 3, seed=4, resolution=res))
        for k in ("img1", "img2"):
            assert np.array_equal(b_t[k], b_j[k]), (synth, k)
