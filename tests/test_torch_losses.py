"""The training losses of the port vs ``cut3r_slam_tpu/train/losses.py`` on
the CPU: every public function, its value and its gradient with respect
to the predictions, on the same seeded inputs (random rigid ground-truth
poses, world points, partial validity masks, per-sample BatchList flags).

Tolerance: 1e-5 relative, as max |port - jax| / max |jax| over each
output array and each gradient (f32 on both sides).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cut3r_slam_tpu.train import losses as JL
from cut3r_slam_tpu_torch.train import losses as TL

V, B, H, W = 3, 2, 8, 12
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rot(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3)


def _inputs(seed=0):
    """(pred, gt) as numpy dicts."""
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4), (V * B, 1, 1))
    c2w[:, :3, :3] = _rot(rng, V * B)
    c2w[:, :3, 3] = rng.normal(0, 1, (V * B, 3))
    q = rng.standard_normal((V, B, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[..., 0] = np.abs(q[..., 0])
    f32 = np.float32
    pred = {
        "pts3d_in_self_view": rng.normal(0, 2, (V, B, H, W, 3)).astype(f32),
        "pts3d_in_other_view": rng.normal(0, 2, (V, B, H, W, 3)).astype(f32),
        "conf_self": (1 + rng.exponential(1, (V, B, H, W))).astype(f32),
        "conf": (1 + rng.exponential(1, (V, B, H, W))).astype(f32),
        "camera_pose": np.concatenate(
            [rng.normal(0, 1, (V, B, 3)), q], -1).astype(f32),
        "rgb": rng.uniform(-1, 1, (V, B, H, W, 3)).astype(f32),
    }
    gt = {
        "pts3d": rng.normal(0, 3, (V, B, H, W, 3)).astype(f32),
        "camera_pose": c2w.reshape(V, B, 4, 4).astype(f32),
        "valid_mask": rng.uniform(size=(V, B, H, W)) > 0.2,
        "img": rng.uniform(-1, 1, (V, B, H, W, 3)).astype(f32),
    }
    return pred, gt


FLAGS = {"depth_only": np.array([True, False]),
         "single_view": np.array([False, True]),
         "is_metric": np.array([False, False]),
         "camera_only": np.array([False, True])}


def _check(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() / scale <= REL, (
        what, float(np.abs(got - want).max() / scale))


def _both(jfn, tfn, args, n_grad, seed=1):
    """Runs ``jfn`` / ``tfn`` on the same numpy ``args`` (pytrees of
    arrays); the first ``n_grad`` args are differentiated through a
    seeded random weighting of every float output."""
    rng = np.random.default_rng(seed)
    out_j = jax.jit(jfn)(*[jax.tree.map(jnp.asarray, a) for a in args])
    leaves_j = [x for x in jax.tree.leaves(out_j)
                if jnp.issubdtype(x.dtype, jnp.floating)]
    weights = [rng.uniform(0.5, 1.5, np.shape(x)).astype(np.float32)
               for x in leaves_j]

    def scalar_j(*a):
        leaves = [x for x in jax.tree.leaves(jfn(*a))
                  if jnp.issubdtype(x.dtype, jnp.floating)]
        return sum(jnp.sum(x * w) for x, w in zip(leaves, weights))

    grads_j = jax.jit(jax.grad(scalar_j, argnums=tuple(range(n_grad))))(
        *[jax.tree.map(jnp.asarray, a) for a in args])

    targs = [jax.tree.map(lambda x: torch.tensor(np.asarray(x)), a)
             for a in args]
    diff = [x for a in targs[:n_grad] for x in jax.tree.leaves(a)]
    for x in diff:
        x.requires_grad_(True)
    out_t = tfn(*targs)
    leaves_t = [x for x in jax.tree.leaves(out_t)
                if torch.is_tensor(x) and x.is_floating_point()]
    assert len(leaves_t) == len(leaves_j)
    for i, (x, y) in enumerate(zip(leaves_t, leaves_j)):
        _check(x.detach().numpy(), y, f"output {i}")
    s = sum((x * torch.from_numpy(w)).sum()
            for x, w in zip(leaves_t, weights))
    grads_t = torch.autograd.grad(s, diff, allow_unused=True) \
        if s.requires_grad else [None] * len(diff)     # all detached
    for i, (gt, gj) in enumerate(zip(grads_t, jax.tree.leaves(grads_j))):
        gt = np.zeros(np.shape(gj)) if gt is None else gt.numpy()
        _check(gt, gj, f"gradient {i}")


def test_regr3d_pose_loss():
    pred, gt = _inputs()
    _both(JL.regr3d_pose_loss, TL.regr3d_pose_loss, [pred, gt], 1)


@pytest.mark.parametrize("flags", [False, True], ids=["plain", "flags"])
def test_regr3d_pose_batchlist_loss(flags):
    pred, gt = _inputs(2)
    if flags:
        gt.update(FLAGS)
    _both(JL.regr3d_pose_batchlist_loss, TL.regr3d_pose_batchlist_loss,
          [pred, gt], 1)


@pytest.mark.parametrize("rgb", [True, False], ids=["rgb", "no_rgb"])
def test_cut3r_total_loss(rgb):
    pred, gt = _inputs(3)
    if not rgb:
        del pred["rgb"]
    _both(JL.cut3r_total_loss, TL.cut3r_total_loss, [pred, gt], 1)


def test_cut3r_batchlist_total_loss():
    pred, gt = _inputs(4)
    gt.update(FLAGS)
    _both(JL.cut3r_batchlist_total_loss, TL.cut3r_batchlist_total_loss,
          [pred, gt], 1)


def test_conf_rgb_masked_mean():
    pred, gt = _inputs(5)
    l = np.abs(pred["pts3d_in_self_view"][..., 0])
    _both(lambda l, c, v: JL.conf_loss(l, c, v, 0.3),
          lambda l, c, v: TL.conf_loss(l, c, v, 0.3),
          [l, pred["conf"], gt["valid_mask"]], 2)
    _both(JL.rgb_loss, TL.rgb_loss,
          [pred["rgb"], gt["img"], gt["valid_mask"]], 1)
    _both(JL.masked_mean, TL.masked_mean, [l, gt["valid_mask"]], 1)


def test_depth_and_scale_invariant_losses():
    pred, gt = _inputs(6)
    pr, gp, m = pred["pts3d_in_self_view"], gt["pts3d"], gt["valid_mask"]
    _both(JL.depth_scale_shift_inv_loss, TL.depth_scale_shift_inv_loss,
          [pr[..., 2], gp[..., 2], m], 1)
    _both(JL.scale_inv_loss, TL.scale_inv_loss, [pr, gp, m], 1)


@pytest.mark.parametrize("mode", ["avg", "median", "weiszfeld",
                                  "weiszfeld_stop_grad"])
@pytest.mark.parametrize("views", [1, 2])
def test_find_opt_scaling(mode, views):
    """Both views' valid points (or one view, all valid), each mode; the
    stop-grad mode's gradient is zero in both."""
    pred, gt = _inputs(7)
    g1, g2 = gt["pts3d"][0], gt["pts3d"][1]
    p1 = pred["pts3d_in_self_view"][0] + 0.7 * g1
    p2 = pred["pts3d_in_self_view"][1] + 0.7 * g2
    m1, m2 = gt["valid_mask"][0], gt["valid_mask"][1]
    if views == 1:
        _both(lambda p, g: JL.find_opt_scaling(g, None, p, fit_mode=mode),
              lambda p, g: TL.find_opt_scaling(g, None, p, fit_mode=mode),
              [p1, g1], 1)
    else:
        _both(lambda p1, p2, g1, g2, m1, m2: JL.find_opt_scaling(
                  g1, g2, p1, p2, fit_mode=mode, valid1=m1, valid2=m2),
              lambda p1, p2, g1, g2, m1, m2: TL.find_opt_scaling(
                  g1, g2, p1, p2, fit_mode=mode, valid1=m1, valid2=m2),
              [p1, p2, g1, g2, m1, m2], 2)


def test_overflowing_pointmaps_nan_as_in_jax_eager():
    """Pointmaps past ~1e19 overflow the f32 squared norms of the
    average-distance normalization. The port's loss is then NaN, as the JAX
    loss is when its ops run one by one; the JAX loss jitted as one program
    can return a finite number there, which XLA's rewrites leave, not the
    arithmetic (scripts/init_divergence_torch_vs_jax.py --probe-loss). The
    training from ``init_random`` reaches such pointmaps at its fifth step
    in both packages. Below the overflow the two agree."""
    for scale, finite in ((1e18, True), (1e21, False)):
        pred, gt = _inputs(3)
        for k in ("pts3d_in_self_view", "pts3d_in_other_view"):
            pred[k] = (pred[k] * scale).astype(np.float32)
        lj, _ = JL.cut3r_total_loss(
            *[{k: jnp.asarray(v) for k, v in d.items()} for d in (pred, gt)])
        lt, _ = TL.cut3r_total_loss(
            *[{k: torch.tensor(v) for k, v in d.items()} for d in (pred, gt)])
        assert bool(np.isfinite(float(lj))) == bool(torch.isfinite(lt)) \
            == finite, scale
        if finite:
            _check(lt.numpy(), lj, f"loss at {scale:.0e}")

