"""The port's DROID network (``models/droid_net.py``) against the JAX
package on the CPU: the same seeded flax params (``jax.eval_shape`` of
``DroidNet.init`` filled from numpy, as tests/test_torch_prior.py does)
carried by ``models/convert.droid_params_from_jax``, the same numpy
inputs.

Tolerances, f32 on both sides: the GRU, the aggregation and convex
upsampling 1e-5 absolute + 1e-5 relative per element; the encoders (14
convolutions, instance norms with flax's fast variance) 1e-5 of the
map's largest magnitude + 1e-5 relative (at fnet the port lies 7.0e-6
from a float64 run of itself, JAX 1.7e-5, on a map of magnitude 6.3);
the whole forward (3 frames of 64x64, 4 edges, ``num_steps=2``, each step two BA
iterations) 1e-4 absolute + 1e-4 relative on poses, disparities and
residuals; every parameter's gradient of mean |residual| within 1e-4 of
that tensor's largest entry plus 1e-6 of the largest over all tensors
(the bound of tests/test_torch_train_step.py) of the JAX gradient in
float64, the worst printed under ``pytest -s``.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from cut3r_slam_tpu.geometry import lie as jlie
from cut3r_slam_tpu.models import droid_net as jdn
from cut3r_slam_tpu_torch.models import droid_net as dn
from cut3r_slam_tpu_torch.models.blocks import init_random
from cut3r_slam_tpu_torch.models.convert import droid_params_from_jax

from test_torch_cut3r_train import few_threads  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
FWD = dict(atol=1e-4, rtol=1e-4)
N, H8, W8 = 3, 8, 8
H, W = 8 * H8, 8 * W8
II, JJ = np.asarray([0, 1, 1, 2]), np.asarray([1, 0, 2, 1])


def _fill(shapes, seed):
    """N(0, 1 / fan_in) kernels and N(0, 0.02) biases from numpy."""
    flat = flatten_dict(unfreeze(shapes["params"]), sep="/")
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(flat):
        shp = flat[k].shape
        z = rng.standard_normal(shp)
        out[k] = (z / math.sqrt(math.prod(shp[:-1])) if k.endswith("kernel")
                  else 0.02 * z).astype(np.float32)
    return out


def _tree(flat):
    return {"params": unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                      for k, v in flat.items()})}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 255, (H + 8, W + 8, 3))
    for _ in range(2):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3.0
    images = np.stack([tex[4 * i:4 * i + H, 2 * i:2 * i + W]
                       for i in range(N)]).astype(np.float32)
    xi = np.zeros((N, 6), np.float32)
    xi[:, 0] = np.arange(N) * 0.04
    xi[:, 4] = np.arange(N) * 0.01
    poses = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    disps = (0.5 + 0.05 * rng.standard_normal((N, H8, W8))).astype(
        np.float32)
    intr = np.tile([W8 * 1.2, W8 * 1.2, W8 / 2, H8 / 2], (N, 1)).astype(
        np.float32)
    return poses, images, disps, intr


@pytest.fixture(scope="module")
def nets():
    poses, images, disps, intr = _inputs()
    shapes = jax.eval_shape(
        lambda k: jdn.DroidNet().init(
            k, jnp.asarray(poses), jnp.asarray(images), jnp.asarray(disps),
            jnp.asarray(intr), jnp.asarray(II), jnp.asarray(JJ),
            jnp.ones(4), num_steps=1, fixedp=1),
        jax.random.PRNGKey(0))
    flat = _fill(shapes, 0)
    net = dn.DroidNet(device="cpu")
    net.load_state_dict(droid_params_from_jax(flat), strict=True)
    return flat, net


def _sub(flat, prefix):
    return _tree({k[len(prefix) + 1:]: v for k, v in flat.items()
                  if k.startswith(prefix + "/")})


def _nchw(x):
    return torch.tensor(np.ascontiguousarray(np.asarray(x).transpose(
        0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_droid_params_from_jax(nets):
    """Every flax kernel lands in its Conv2d as OIHW, every bias as is; the
    nested tree (with or without its ``params`` level) and the flat dict
    give the same state_dict, which covers the port's model exactly."""
    flat, net = nets
    sd = droid_params_from_jax(flat)
    assert set(sd) == set(net.state_dict())
    assert len(sd) == len(flat)
    for k, v in flat.items():
        name = k.replace("/", ".").replace(".kernel", ".weight")
        want = v.transpose(3, 2, 0, 1) if k.endswith("kernel") else v
        np.testing.assert_array_equal(sd[name].numpy(), want)
    tree = _tree(flat)
    for alt in (tree, tree["params"]):
        sd2 = droid_params_from_jax(alt)
        assert set(sd2) == set(sd)
        for k in sd:
            assert torch.equal(sd2[k], sd[k]), k


@pytest.mark.parametrize("which", ["fnet", "cnet"])
def test_basic_encoder(nets, which):
    flat, net = nets
    _, images, _, _ = _inputs(1)
    x = (images / 255.0 - 0.5) / 0.25
    mod = jdn.BasicEncoder(128, "instance") if which == "fnet" else \
        jdn.BasicEncoder(256, "none")
    want = mod.apply(_sub(flat, which), jnp.asarray(x))
    got = getattr(net, which)(_nchw(x))
    want = np.asarray(want)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_conv_gru_and_graph_agg(nets):
    flat, net = nets
    rng = np.random.default_rng(2)
    h = np.tanh(rng.normal(size=(4, H8, W8, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(4, H8, W8, 320)), 0).astype(np.float32)
    want = jdn.ConvGRU(128).apply(_sub(flat, "update/gru"), jnp.asarray(h),
                                  jnp.asarray(inp))
    got = net.update.gru(_nchw(h), _nchw(inp))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)

    ii = np.asarray([0, 2, 2, 0])          # frame 1 has no edge
    eta_j, up_j = jdn.GraphAgg().apply(_sub(flat, "update/agg"),
                                       jnp.asarray(h), jnp.asarray(ii), 3)
    eta, up = net.update.agg(_nchw(h), torch.tensor(ii), 3)
    np.testing.assert_allclose(eta.detach().numpy(), np.asarray(eta_j), **TOL)
    np.testing.assert_allclose(_nhwc(up), np.asarray(up_j), **TOL)


def test_cvx_upsample():
    """The JAX mask (N, h, w, 9 * 64) channel-last is the port's
    (N, 9 * 64, h, w), channel k * 64 + f."""
    rng = np.random.default_rng(3)
    data = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    mask = rng.normal(size=(2, 5, 6, 9 * 64)).astype(np.float32)
    want = np.asarray(jdn.cvx_upsample(jnp.asarray(data), jnp.asarray(mask)))
    got = dn.cvx_upsample(_nchw(data), _nchw(mask))
    assert got.shape == (2, 3, 40, 48)
    np.testing.assert_allclose(_nhwc(got), want, **TOL)


def test_grad_clip_backward():
    g = torch.tensor([float("nan"), -1.0, -0.004, 0.0, 0.02, 3.0])
    x = torch.zeros(6, requires_grad=True)
    dn.grad_clip(x).backward(g)
    np.testing.assert_array_equal(
        x.grad.numpy(),
        np.float32([0.0, -0.01, -0.004, 0.0, 0.01, 0.01]))
    _, vjp = jax.vjp(jdn.grad_clip, jnp.zeros(6))
    np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(g.numpy()))[0]),
                                  x.grad.numpy())


def _jax_loss(flat, ins, dtype=jnp.float32):
    """(loss, (poses, disps, residual)), gradients of the JAX DroidNet at
    ``num_steps=2``, fixedp 1, params and inputs in ``dtype``."""
    poses, images, disps, intr = (jnp.asarray(x, dtype) for x in ins)
    params = jax.tree.map(lambda v: v.astype(dtype), _tree(flat))

    def loss(params):
        p, d, r = jdn.DroidNet().apply(
            params, poses, images, disps, intr, jnp.asarray(II),
            jnp.asarray(JJ), jnp.ones(4, dtype), 2, 1)
        return jnp.abs(r).mean(), (p, d, r)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))(params)


def test_forward_and_gradients_match_jax(nets):
    """A whole forward at ``num_steps=2`` (fixedp 1) against the JAX
    forward, and the gradient of mean |residual| with respect to every
    parameter tensor against ``jax.grad`` of the same loss run in float64
    (``jax.enable_x64``): the JAX f32 gradients of the first fnet layers lie
    2e-3 to 4e-3 of their largest entry from the float64 ones (rounding
    through the instance norms' fast variance), the port's 4e-6."""
    flat, net = nets
    ins = _inputs(0)
    (jl, (jp, jd, jr)), _ = _jax_loss(flat, ins)
    with jax.enable_x64(True):
        (jl64, _), jg = _jax_loss(flat, ins, jnp.float64)
        jflat = {k: np.asarray(v) for k, v in
                 flatten_dict(unfreeze(jg["params"]), sep="/").items()}
    net.zero_grad()
    poses, images, disps, intr = (torch.tensor(x) for x in ins)
    p, d, r = net(poses, images, disps, intr, torch.tensor(II),
                  torch.tensor(JJ), torch.ones(4), num_steps=2, fixedp=1)
    loss = r.abs().mean()
    loss.backward()
    assert r.shape == (4, H8, W8, 2)
    for got, want, what in ((p, jp, "poses"), (d, jd, "disps"),
                            (r, jr, "residual")):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   err_msg=what, **FWD)
    for ref in (jl, jl64):
        assert abs(loss.item() - float(ref)) <= 1e-4 * abs(float(ref))

    gmax = max(float(np.abs(v).max()) for v in jflat.values())
    assert gmax > 0
    params = dict(net.named_parameters())
    worst, worst_k = 0.0, None
    for k, want in jflat.items():
        name = k.replace("/", ".").replace(".kernel", ".weight")
        if k.endswith("kernel"):
            want = want.transpose(3, 2, 0, 1)
        g = params[name].grad       # None: upmask_conv, unused by forward
        got = g.numpy() if g is not None else np.zeros(want.shape)
        err = float(np.abs(got - want).max())
        bound = 1e-4 * float(np.abs(want).max()) + 1e-6 * gmax
        if err / bound > worst:
            worst, worst_k = err / bound, name
        assert err <= bound, (name, err, bound)
    print(f"worst gradient tensor {worst_k}: {worst:.3f} of its bound")


def test_residual_falls_over_sgd_steps():
    """As tests/test_droid_convergence.py: from seeded random weights, four
    SGD steps on mean |residual| over a shifted two-frame pair lower it
    (gradients reach the update network through GRU, BA and lookups)."""
    rng = np.random.default_rng(1)
    tex = rng.uniform(0, 255, (H + 8, W + 8, 3)).astype(np.float32)
    for _ in range(2):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3.0
    images = torch.tensor(np.stack([tex[:H, :W], tex[4:H + 4, 4:W + 4]]))
    d = 0.5 + 0.1 * rng.standard_normal((H8, W8))
    disps = torch.tensor(np.stack([d, d]), dtype=torch.float32)
    intr = torch.tensor([W8 * 1.2, W8 * 1.2, W8 / 2, H8 / 2]).expand(2, 4)
    from cut3r_slam_tpu_torch.geometry.lie import se3_exp, se3_identity
    poses = torch.stack([se3_identity(),
                         se3_exp(torch.tensor([0.05, 0, 0, 0, 0, 0]))])
    ii, jj, ev = torch.tensor([0, 1]), torch.tensor([1, 0]), torch.ones(2)
    net = init_random(dn.DroidNet(device="cpu"),
                      torch.Generator().manual_seed(0))

    def loss():
        net.zero_grad()
        _, _, r = net(poses, images, disps, intr, ii, jj, ev, num_steps=2,
                      fixedp=1)
        out = r.abs().mean()
        out.backward()
        return out.item()

    losses = [loss()]
    assert np.isfinite(losses[0])
    trained = [p for p in net.parameters() if p.grad is not None]
    assert sum(float(p.grad.abs().sum()) for p in trained) > 0
    for _ in range(4):
        with torch.no_grad():
            for p in trained:
                p -= 1e-4 * p.grad
        losses.append(loss())
    assert losses[-1] < losses[0], losses
