"""The training step of the port vs ``cut3r_slam_tpu/train/train_step.py``
on the CPU.

* the optimizer alone, against the JAX package's ``make_optimizer``
  (optax) on small seeded tensors: the warmup-cosine schedule step by
  step, global-norm clipping on both sides of its threshold, AdamW with
  weight decay on a leaf that gets no gradient, and ``accum_steps=2``
  (``optax.MultiSteps``) — parameters after every call within 1e-6
  relative to their scale (f32 elementwise math in another order);
* the whole step at the tiny config (V=2, B=1, 32x48, a procedural
  scene): three ``make_train_step`` steps from the same params on the
  same batches — the loss of every step within 1e-5 relative; the
  gradient of every parameter tensor, read from Adam's first moment
  after the two steps taken at the starting params (the first update is
  zero by the schedule), within 1e-4 of the JAX one relative to the
  tensor's norm plus a floor of 1e-6 x the largest tensor's
  (``grads_close``; the worst tensor is printed, about 2e-5 here and
  4e-5 in the TBPTT test: f32 in another summation order through
  pointmaps of |p| ~ 900); and every parameter afterwards within 1e-5
  absolute on all but 1e-4 of the elements, the rest within two Adam
  steps (``_params_close``: at these learning rates an element whose
  gradient is at the f32 rounding floor moves by +-lr in either package;
  1302 of 55.2 M elements here). The truncated-BPTT step is
  tests/test_torch_tbptt.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
from cut3r_slam_tpu.train import train_step as JS
from cut3r_slam_tpu_torch.datasets import (MultiViewDataset, SceneFolderSource,
                                           SceneLayout, make_batch_iter,
                                           generate_multiview_scenes)
from cut3r_slam_tpu_torch.models.convert import params_from_jax
from cut3r_slam_tpu_torch.train import train_step as TS

from test_torch_cut3r_train import (few_threads, jax_params,  # noqa: F401
                                    jax_tiny_params, torch_from_flat)

H, W = 32, 48
OPT = dict(lr=1e-4, weight_decay=0.05, warmup_steps=2, total_steps=10)


# ---------------------------------------------------------------------------
# the optimizer alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(2, 10), (0, 10), (3, 3),
                                          (1000, 100_000)])
def test_schedule_matches_optax(warmup, total):
    """Step by step, to f32 rounding (optax evaluates it in f32)."""
    sched = optax.warmup_cosine_decay_schedule(
        0.0, 1e-3, warmup, max(total, warmup + 1))
    for count in list(range(0, 14)) + [warmup, total, 2 * total + 5]:
        np.testing.assert_allclose(TS.lr_at(count, 1e-3, warmup, total),
                                   float(sched(count)), rtol=1e-5,
                                   atol=1e-12, err_msg=str(count))


def _tensors(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32),
            "frozen": rng.normal(size=(4, 2)).astype(np.float32)}


def _run_both(grad_scales, accum_steps=1, weight_decay=0.05, warmup=2):
    """Calls both optimizers on the same gradients (``frozen`` never has
    one: zeros for optax, ``None`` for the port); returns the parameter
    pairs after every call."""
    kw = dict(lr=1e-2, weight_decay=weight_decay, warmup_steps=warmup,
              total_steps=10, accum_steps=accum_steps)
    p_j = {k: jnp.asarray(v) for k, v in _tensors(0).items()}
    tx = JS.make_optimizer(**kw)
    st = tx.init(p_j)
    p_t = {k: torch.tensor(v) for k, v in _tensors(0).items()}
    opt = TS.make_optimizer(list(p_t.values()), **kw)
    out = []
    for i, s in enumerate(grad_scales):
        g = {k: s * v for k, v in _tensors(10 + i).items()}
        g["frozen"] = np.zeros_like(g["frozen"])
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                            p_j)
        p_j = optax.apply_updates(p_j, upd)
        for k, p in p_t.items():
            p.grad = None if k == "frozen" else torch.tensor(g[k])
        opt.step()
        out.append(({k: np.asarray(v) for k, v in p_j.items()},
                    {k: v.detach().numpy().copy() for k, v in p_t.items()}))
    return out


def _close(pj, pt):
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], rtol=0, err_msg=k,
                                   atol=1e-6 * max(np.abs(pj[k]).max(), 1))


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["under", "clipped"])
def test_adamw_clip_and_decay_match_optax(scale):
    """Gradients under and over the clip norm (1.0); weight decay moves
    the leaf without a gradient in both."""
    out = _run_both([scale] * 4)
    for pj, pt in out:
        _close(pj, pt)
    first, last = out[0][1], out[-1][1]
    assert np.array_equal(first["a"], _tensors(0)["a"])   # lr 0 at count 0
    assert not np.allclose(last["frozen"], _tensors(0)["frozen"])


def test_accum_steps_match_optax_multisteps():
    """accum_steps=2: the mean of two micro-gradients every second call,
    the parameters bitwise unchanged in between."""
    out = _run_both([1.0, 3.0, 0.5, 2.0, 1.5, 0.1], accum_steps=2,
                    warmup=1)
    for pj, pt in out:
        _close(pj, pt)
    start = _tensors(0)
    for i, (_, pt) in enumerate(out):
        moved = not all(np.array_equal(pt[k], out[i - 1][1][k] if i else
                                       start[k]) for k in pt)
        assert moved == (i % 2 == 1 and i > 1), i   # the first is at lr 0


def test_no_decay_leaves_gradless_leaves_bitwise():
    out = _run_both([1.0] * 3, weight_decay=0.0)
    assert np.array_equal(out[-1][1]["frozen"], _tensors(0)["frozen"])


# ---------------------------------------------------------------------------
# the whole step at the tiny config
# ---------------------------------------------------------------------------

def procedural_batches(root, num_views, n, seed):
    """``n`` batches of one procedural scene of 8 views (the sampler's
    span of 6 never reaches past the scene, so no view repeats: views
    that share one pose make the translation loss divide rounding by
    rounding, in both packages)."""
    generate_multiview_scenes(root, n_scenes=1, views_per_scene=8,
                              hw=(H, W), seed=seed)
    src = SceneFolderSource(root, SceneLayout("synth"))
    it = make_batch_iter(MultiViewDataset(src, num_views=num_views, span=6,
                                          resolution=(H, W), seed=seed),
                         1, seed)
    out = [next(it) for _ in range(n)]
    for b in out:
        poses = b["camera_pose"][:, 0].reshape(num_views, 16)
        assert len(np.unique(poses, axis=0)) == num_views
    return out


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    return procedural_batches(str(tmp_path_factory.mktemp("scenes")), 2, 3,
                              seed=0)


@pytest.fixture(scope="module")
def flat():
    return jax_tiny_params(seed=1)


def _params_close(params_j, tm, lrs):
    """Every parameter element within 1e-5 absolute of the JAX step's, but
    for at most 1e-4 of the model's elements, and those within two full
    Adam steps (2 * the summed learning rates): Adam divides each gradient
    element by its own magnitude, so an element whose gradient lies at
    the f32 rounding floor of its tensor takes a step of either sign."""
    sd = params_from_jax(flatten_dict(unfreeze(params_j["params"]),
                                      sep="/"))
    ours = tm.state_dict()
    diff = [(ours[k] - v).abs() for k, v in sd.items()]
    n_far = sum(int((d > 1e-5).sum()) for d in diff)
    n_all = sum(d.numel() for d in diff)
    worst = max(float(d.max()) for d in diff)
    assert n_far <= 1e-4 * n_all, (n_far, n_all)
    assert worst <= 2 * sum(lrs) + 1e-6, worst
    return sd


def adam_mu_jax(opt_state):
    """Adam's first moment in the JAX optimizer state, under the port's
    parameter names."""
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    return params_from_jax(flatten_dict(unfreeze(adam.mu["params"]),
                                        sep="/"))


def grads_close(ref_mu, tm, opt):
    """Adam's first moment of every parameter tensor — a mean of clipped
    gradients, all taken at the same params as the JAX ones — against
    ``ref_mu``: the norm of the difference within 1e-4 of the tensor's
    norm plus 1e-6 x the largest tensor's. Below that floor a gradient is
    zero up to rounding (a key bias, to which the softmax is invariant; a
    frozen encoder), and a tensor whose reference lies there must have
    ours there too. Returns the worst difference over (the tensor's norm
    + the floor)."""
    rtol, floor = 1e-4, 1e-6
    got = {n: opt.state[p]["mu"] for n, p in tm.named_parameters()}
    assert set(got) == set(ref_mu)
    top = max(float(v.norm()) for v in ref_mu.values())
    worst = 0.0
    for k, r in ref_mu.items():
        rn, gn = float(r.norm()), float(got[k].norm())
        if rn <= floor * top:
            assert gn <= floor * top, (k, rn / top, gn / top)
            continue
        rel = float((got[k] - r).norm()) / (rn + floor * top)
        assert rel <= rtol, (k, rel)
        worst = max(worst, rel)
    return worst


def test_train_steps_match_jax(flat, batches):
    """Three AdamW steps (the first at lr 0 by the schedule): the loss of
    each, the gradients of the two taken at the starting params, then
    every parameter."""
    jm = JCUT3R(JConfig.tiny())
    tx = JS.make_optimizer(**OPT)
    params = jax_params(flat)
    opt_state = tx.init(params)
    step_j = jax.jit(JS.make_train_step(jm, tx))
    tm = torch_from_flat(flat)
    opt = TS.make_optimizer(tm.parameters(), **OPT)
    step_t = TS.make_train_step(tm, opt)
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    for i, b in enumerate(batches):
        params, opt_state, aux_j = step_j(
            params, opt_state, {k: jnp.asarray(v) for k, v in b.items()})
        aux_t = step_t(b)
        for k in ("total", "loss_trans", "loss_quat"):
            np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                       rtol=1e-5, err_msg=k)
        if i < 2:
            worst = grads_close(adam_mu_jax(opt_state), tm, opt)
            print(f"step {i + 1}: worst tensor's gradient differs by "
                  f"{worst:.3e} of its norm + the floor")
    _params_close(params, tm, [TS.lr_at(i, OPT["lr"], OPT["warmup_steps"],
                                        OPT["total_steps"]) for i in range(3)])
    moved = [k for k, v in tm.state_dict().items()
             if not torch.equal(v, start[k])]
    assert len(moved) == len(start)    # AdamW decays every parameter
