"""DUSt3R-pair and Spann3R of the port vs the JAX package on the CPU (f32),
from the same seeded params through ``params_from_jax``:

* ``AsymmetricCroCo3DStereo.tiny()`` with the linear and the DPT head:
  both views' pointmaps and confidences;
* ``Spann3R.tiny()`` over V = 5 frames of 80x96 (30 tokens a frame), so
  that the working ring (2 frames) evicts from the third frame on and
  the long-term arena (64 tokens) from the fifth: every step's
  prediction and the whole final ``MemoryState``;
* the checkpoint converter: a made-up state dict in the upstream
  ``hislam2/modules/spann3r.py`` names (with the keys both converters
  drop) loads strictly through ``load_spann3r_checkpoint`` and matches
  the JAX ``convert_spann3r_state_dict`` tensor by tensor.

Tolerance: 1e-4 absolute + 1e-4 relative per element, per pixel on the
Euclidean norm for pointmaps (tests/test_torch_cut3r_train.py's). The
memory read zeroes attention weights below ``attn_thresh``; a weight
within rounding of the threshold can fall on either side in the two
packages. Such flips are counted (elements whose side differs) and must
stay below 1e-3 of the weights compared; none occurred at these inputs.
The arena's eviction order follows a stable sort of the accumulated
attention on both sides.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from cut3r_slam_tpu.models import dust3r_pair as JD, spann3r as JS
from cut3r_slam_tpu.models.convert import convert_spann3r_state_dict
from cut3r_slam_tpu_torch.models import dust3r_pair as TD, spann3r as TS
from cut3r_slam_tpu_torch.models.convert import (SPANN3R_SKIP,
                                                 load_spann3r_checkpoint,
                                                 params_from_jax)

from test_torch_cut3r_train import few_threads  # noqa: F401
from test_torch_prior import as_jax, jax_random_params

TOL = dict(atol=1e-4, rtol=1e-4)
FLIP_SHARE = 1e-3


def _imgs(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _pts_close(got, want):
    err = np.linalg.norm(got - want, axis=-1)
    bound = TOL["atol"] + TOL["rtol"] * np.linalg.norm(want, axis=-1)
    assert (err <= bound).all(), float((err - bound).max())


def _pred_close(got, want):
    _pts_close(got["pts3d"].numpy(), np.asarray(want["pts3d"]))
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(want["conf"]),
                               **TOL)


@pytest.mark.parametrize("head", ["linear", "dpt"])
def test_dust3r_pair_matches_jax(head):
    jc = dataclasses.replace(JD.Dust3rPairConfig.tiny(), head=head)
    tc = dataclasses.replace(TD.Dust3rPairConfig.tiny(), head=head)
    H, W = 32, 48
    jm = JD.AsymmetricCroCo3DStereo(jc)
    x = jnp.zeros((1, H, W, 3))
    flat = jax_random_params(jm, x, x, seed=3)
    tm = TD.AsymmetricCroCo3DStereo(tc, device="cpu")
    tm.load_state_dict(params_from_jax(flat), strict=True)
    a, b = _imgs(0, (2, H, W, 3)), _imgs(1, (2, H, W, 3))
    p1j, p2j = jax.jit(jm.apply)(as_jax(flat), jnp.asarray(a),
                                 jnp.asarray(b))
    with torch.no_grad():
        p1t, p2t = tm(torch.from_numpy(a), torch.from_numpy(b))
    _pred_close(p1t, p1j)
    _pred_close(p2t, p2j)


V, B, H, W = 5, 1, 80, 96


@pytest.fixture(scope="module")
def spann3r():
    jm = JS.Spann3R(JS.Spann3RConfig.tiny())
    imgs = _imgs(2, (V, B, H, W, 3))
    flat = jax_random_params(jm, jnp.zeros((2, B, H, W, 3)), seed=4)
    tm = TS.Spann3R(TS.Spann3RConfig.tiny(), device="cpu")
    tm.load_state_dict(params_from_jax(flat), strict=True)
    return jm, as_jax(flat), tm, imgs


def test_spann3r_recurrence_and_memory_match_jax(spann3r):
    jm, params, tm, imgs = spann3r
    preds_j, mem_j = jax.jit(jm.apply)(params, jnp.asarray(imgs))
    with torch.no_grad():
        preds_t, mem_t = tm(torch.from_numpy(imgs))
    assert len(preds_t) == len(preds_j) == V
    for pt, pj in zip(preds_t, preds_j):
        _pred_close(pt, pj)
    P = (H // 16) * (W // 16)
    cfg = tm.cfg
    # both memories evicted: the ring wrapped, the arena overflowed
    assert int(mem_t.work_head[0]) == V > cfg.work_mem_frames
    assert (V - cfg.work_mem_frames) * P > cfg.long_mem_tokens
    for f in dataclasses.fields(TS.MemoryState):
        got = getattr(mem_t, f.name).numpy()
        want = np.asarray(getattr(mem_j, f.name))
        assert got.shape == want.shape, f.name
        if got.dtype == bool or f.name == "work_head":
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=f.name)
        else:
            np.testing.assert_allclose(got, want, err_msg=f.name, **TOL)
    assert bool(mem_t.long_valid.all())


def _weights(norm_q, norm_k, q, mem, xp):
    """The memory read's attention weights before the ``attn_thresh`` cut
    (``memory_read``'s first half, in either package's array ops)."""
    B, P, C = q.shape
    cat = torch.cat if xp is torch else jnp.concatenate
    k = cat([mem.work_k.reshape(B, -1, C), mem.long_k], 1)
    rep = mem.work_k.shape[2]
    wmask = mem.work_valid.repeat_interleave(rep, 1) if xp is torch \
        else jnp.repeat(mem.work_valid, rep, axis=1)
    m = cat([wmask, mem.long_valid], 1)[:, None]
    lg = (norm_q(q) @ xp.swapaxes(norm_k(k), 1, 2)) * C ** -0.5
    lg = xp.where(m, lg, -1e9 * xp.ones_like(lg))
    sm = torch.softmax(lg, -1) if xp is torch else jax.nn.softmax(lg, -1)
    return sm * m


def test_memory_read_threshold_flips_bounded(spann3r):
    """One read over a memory filled by the recurrence, the same query and
    memory on both sides: the read and the attention each arena slot
    receives, and the weights that fell on the other side of
    ``attn_thresh`` in the two packages (counted, bounded)."""
    jm, params, tm, imgs = spann3r
    with torch.no_grad():
        carry = None
        for v in range(V):
            carry, _ = tm.step(carry, torch.from_numpy(imgs[v]))
        q, mem = carry[2], carry[3]
        out_t, la_t = tm.memory_read(q, mem)
        a_t = _weights(tm.norm_q, tm.norm_k, q, mem, torch).numpy()
    mem_j = JS.MemoryState(**{f.name: jnp.asarray(
        getattr(mem, f.name).numpy()) for f in dataclasses.fields(
            TS.MemoryState)})
    q_j = jnp.asarray(q.numpy())
    out_j, la_j = jm.apply(params, q_j, mem_j, method=JS.Spann3R.memory_read)
    a_j = np.asarray(jm.apply(params, q_j, mem_j, method=lambda mdl, q, m:
                              _weights(mdl.norm_q, mdl.norm_k, q, m, jnp)))
    thresh = tm.cfg.attn_thresh
    kept = a_j >= thresh
    flips = int(((a_t >= thresh) != kept).sum())
    print(f"\nattn_thresh {thresh}: {kept.mean():.3f} of {a_j.size} weights "
          f"kept; {flips} on the other side in the port")
    assert 0 < kept.mean() < 1            # the cut acts at these inputs
    assert flips <= FLIP_SHARE * a_j.size, flips
    np.testing.assert_allclose(a_t, a_j, atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(la_t.numpy(), np.asarray(la_j), **TOL)


def _upstream_state(tm, rng, dpt):
    """The port's tensors under their (upstream) names, random, plus the
    keys an upstream Spann3R checkpoint carries that neither package
    reads."""
    g = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    sd = {k: torch.randn(v.shape, generator=g)
          for k, v in tm.state_dict().items()}
    extra = {"dust3r.mask_token": torch.zeros(1, 1, 64),
             "dust3r.enc_pos_embed": torch.zeros(1, 16, 64),
             "dust3r.prediction_head.weight": torch.zeros(768, 48)}
    if dpt:
        for n in (1, 2):
            pre = f"dust3r.downstream_head{n}.dpt.scratch."
            for c in (1, 2):
                extra[f"{pre}refinenet4.resConfUnit1.conv{c}.weight"] = \
                    torch.randn(256, 256, 3, 3, generator=g)
            # the ModuleList alias of layer{k}_rn: the same tensor
            extra[f"{pre}layer_rn.0.weight"] = sd[f"{pre}layer1_rn.weight"]
    return sd, extra


@pytest.mark.parametrize("head", ["linear", "dpt"])
def test_upstream_checkpoint_matches_the_jax_converter(head, tmp_path):
    cfg = TS.Spann3RConfig.tiny()
    cfg = dataclasses.replace(cfg, dust3r=dataclasses.replace(cfg.dust3r,
                                                              head=head))
    tm = TS.Spann3R(cfg, device="cpu")
    sd, extra = _upstream_state(tm, np.random.default_rng(5), head == "dpt")
    path = str(tmp_path / "spann3r.pth")
    torch.save({"model": {"module." + k: v
                          for k, v in {**sd, **extra}.items()}}, path)
    got = load_spann3r_checkpoint(path)
    assert set(got) == set(sd)
    tm.load_state_dict(got, strict=True)
    jflat = flatten_dict(unfreeze(convert_spann3r_state_dict(
        {**sd, **extra})["params"]), sep="/")
    want = params_from_jax({k: np.asarray(v) for k, v in jflat.items()})
    # the JAX converter keeps the dead refinenet4 unit (flax never reads
    # it); the port drops it, as SPANN3R_SKIP says
    dead = {k for k in want if k.startswith(tuple(SPANN3R_SKIP))}
    assert set(want) - dead == set(got)
    assert bool(dead) == (head == "dpt")
    for k, v in got.items():
        assert torch.equal(v, want[k]) and torch.equal(v, sd[k]), k
