"""How far each package's f32 gradients lie from a float64 oracle, per
parameter tensor, at ``CUT3RConfig.tiny()`` on one procedural batch (V=2,
B=1, 32x48), from one numpy draw through ``models/convert.params_from_jax``.

The oracle is the port in float64 (the model computes in float64
throughout when its weights are float64). It is checked per tensor
against the JAX step in float64: ``jax.enable_x64(True)``, float64 params
and batch, and, for this test only, the JAX model's float32 islands
raised to float64 (``jnp.float32`` in its model modules, and
``jax.nn.dot_product_attention``, whose softmax is always float32,
replaced by the explicit form). On every tensor that JAX step must lie at
least 10x closer to the oracle than the JAX package's f32 step, so an op
that the port got wrong in f32 and f64 alike shows. Each package's f32
gradient is read as tests/test_torch_train_step.py reads it: Adam's first
moment after one ``make_train_step`` step (clipped by the global norm,
times 1 - b1). Per tensor, the distance is the norm of the difference
over (the oracle tensor's norm + 1e-6 of the largest tensor's); tensors
whose oracle lies below that floor are zero to rounding and left out. The
port must lie within 3x the JAX package's distance + 1e-6 on every
tensor. ``pytest -s`` prints both packages' worst tensors.

All four runs take one branch at every ReLU of the heads: the oracle
records its masks (``heads.ReluBranches``) and the port's f32 run and
both JAX runs replay them (the JAX heads' ``nn.relu`` shadowed for this
test only). A pre-activation within rounding of zero would otherwise
flip one element's gradient path in one run and shift every tensor
upstream of it by ~1e-5, far beyond f32 rounding; the test prints how
many elements replayed against their own sign and the smallest margin
|x| / max |x| met, so a check that sits on a kink shows.

The port's f32 rounding on the CPU depends on the intra-op thread count
(oneDNN partitions its convolutions' reductions by thread; at 8 threads
208 tensors lie beyond 3x, at 2 threads three of the pose retriever's
one-query read, at 1, 3 and 4 threads none), so the module runs on one
thread: the reproducible configuration.
"""
import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from cut3r_slam_tpu.models import CUT3R as JCUT3R, CUT3RConfig as JConfig
from cut3r_slam_tpu.models import (blocks as JB, cut3r as JC, heads as JH,
                                   patch_embed as JP, rope as JR)
from cut3r_slam_tpu.train import train_step as JS
from cut3r_slam_tpu_torch.models.heads import ReluBranches
from cut3r_slam_tpu_torch.train import train_step as TS

from test_torch_cut3r_train import (jax_params, jax_tiny_params,
                                    torch_from_flat)
from test_torch_train_step import OPT, adam_mu_jax, procedural_batches

FLOOR = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    batch = procedural_batches(str(tmp_path_factory.mktemp("scenes")), 2, 1,
                               seed=0)[0]
    return jax_tiny_params(seed=1), batch


def port_mu(flat, batch, dtype, branches=None):
    """The port's Adam first moment after one step; ReLUs recorded or
    replayed by ``branches`` (a ``ReluBranches``) when given."""
    tm = torch_from_flat(flat).to(dtype)
    opt = TS.make_optimizer(tm.parameters(), **OPT)
    b = {k: (v.astype(np.float64) if dtype == torch.float64
             and v.dtype == np.float32 else v) for k, v in batch.items()}
    if branches is None:
        TS.make_train_step(tm, opt)(b)
    else:
        with branches:
            TS.make_train_step(tm, opt)(b)
    return {n: opt.state[p]["mu"].double() for n, p in tm.named_parameters()}


class JaxReplay:
    """``nn.relu`` for the JAX heads following recorded port masks (NCHW,
    in call order) while a step is traced: ``x * mask``."""

    def __init__(self, masks):
        self.masks = [np.transpose(m.numpy(), (0, 2, 3, 1)) for m in masks]
        self.calls = 0

    def __call__(self, x):
        m = self.masks[self.calls]
        assert m.shape == x.shape, (self.calls, m.shape, x.shape)
        self.calls += 1
        return x * jnp.asarray(m, x.dtype)


@contextlib.contextmanager
def replaying(masks):
    """The JAX heads' ReLUs replay ``masks`` inside the block; yields the
    ``JaxReplay`` (its ``calls``)."""
    replay = JaxReplay(masks)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(JH, "nn", _Shadow(JH.nn, relu=replay))
        yield replay


def jax_step(flat, batch, x64):
    """The JAX train step lowered (traced) at these inputs, and its
    arguments."""
    cfg = JConfig.tiny()
    if x64:
        cfg = dataclasses.replace(cfg, compute_dtype=jnp.float64)
    tx = JS.make_optimizer(**OPT)
    if x64:
        params = {"params": unflatten_dict({
            tuple(k.split("/")): jnp.asarray(v.astype(np.float64))
            for k, v in flat.items()})}
        b = {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32
                            else v) for k, v in batch.items()}
    else:
        params = jax_params(flat)
        b = {k: jnp.asarray(v) for k, v in batch.items()}
    args = (params, tx.init(params), b)
    return jax.jit(JS.make_train_step(JCUT3R(cfg), tx)).lower(*args), args


def first_moment(compiled, args):
    _, opt_state, _ = compiled(*args)
    return {k: v.double() for k, v in adam_mu_jax(opt_state).items()}


def jax_mu(flat, batch, x64):
    lowered, args = jax_step(flat, batch, x64)
    return first_moment(lowered.compile(), args)


class _Shadow:
    """A module seen with some of its attributes replaced."""

    def __init__(self, mod, **over):
        self._mod, self._over = mod, over

    def __getattr__(self, name):
        return self._over.get(name, getattr(self._mod, name))


def _attention_f64(q, k, v, scale):
    """``jax.nn.dot_product_attention`` (layout B, T, N, H) without its
    float32 softmax."""
    s = jnp.einsum("btnh,bsnh->bnts", q, k) * scale
    return jnp.einsum("bnts,bsnh->btnh", jax.nn.softmax(s, -1), v)


def jax_mu_all_f64(flat, batch, monkeypatch):
    """The JAX step under x64 with the model's float32 islands raised to
    float64 (module globals shadowed for this call; no file changes)."""
    with monkeypatch.context() as m, jax.enable_x64(True):
        for mod in (JB, JC, JH, JP, JR):
            m.setattr(mod, "jnp", _Shadow(jnp, float32=jnp.float64))
        for mod in (JB, JC):
            m.setattr(mod, "jax", _Shadow(jax, nn=_Shadow(
                jax.nn, dot_product_attention=_attention_f64)))
        return jax_mu(flat, batch, x64=True)


def distances(mu, oracle):
    top = max(float(v.norm()) for v in oracle.values())
    out = {}
    for k, r in oracle.items():
        rn = float(r.norm())
        if rn > FLOOR * top:
            out[k] = float((mu[k] - r).norm()) / (rn + FLOOR * top)
    return out


def test_f32_gradients_against_the_f64_oracle(setup):
    flat, batch = setup
    rec = ReluBranches()
    oracle = port_mu(flat, batch, torch.float64, rec)
    assert all(v.dtype == torch.float64 for v in oracle.values())
    # the f32 JAX step is traced before the f64 one shadows the model's
    # globals, and compiles beside the rest
    with replaying(rec.masks) as replay:
        lowered, args = jax_step(flat, batch, x64=False)
    assert replay.calls == len(rec.masks)
    with ThreadPoolExecutor(1) as pool:
        compiled = pool.submit(lowered.compile)
        port = ReluBranches(rec.masks)
        d_port = distances(port_mu(flat, batch, torch.float32, port), oracle)
        with replaying(rec.masks) as replay:
            d_j64 = distances(jax_mu_all_f64(flat, batch, pytest.MonkeyPatch),
                              oracle)
        assert replay.calls == len(rec.masks)
        d_jax = distances(first_moment(compiled.result(), args), oracle)
    print(f"\nReLU branches: {len(rec.masks)} ReLUs, the f32 port against "
          f"the oracle's masks on {port.flips} elements; smallest margin "
          f"|x| / max|x| {rec.margin:.2e}")
    assert set(d_port) == set(d_jax) == set(d_j64) and len(d_port) > 300
    wp = max(d_port, key=d_port.get)
    wj = max(d_jax, key=d_jax.get)
    ratio = {k: d_port[k] / max(d_jax[k], 1e-12) for k in d_port}
    wr = max(ratio, key=ratio.get)
    r64 = {k: d_j64[k] / d_jax[k] for k in d_jax}
    w64 = max(r64, key=r64.get)
    print(f"\nf64 oracle, {len(d_port)} tensors: port f32 worst {wp} "
          f"{d_port[wp]:.3e} (JAX there {d_jax[wp]:.3e}); JAX f32 worst {wj} "
          f"{d_jax[wj]:.3e} (port there {d_port[wj]:.3e}); median port "
          f"{np.median(list(d_port.values())):.3e}, JAX "
          f"{np.median(list(d_jax.values())):.3e}; largest port / JAX ratio "
          f"{ratio[wr]:.2f} at {wr}; JAX in f64 vs the oracle: median "
          f"{np.median(list(d_j64.values())):.3e}, worst "
          f"{max(d_j64.values()):.3e}, at most {r64[w64]:.4f}x the JAX f32 "
          f"distance ({w64})")
    # the oracle is independent of the port's ops: the JAX step in float64
    # agrees with it far below either package's f32 rounding, per tensor
    loose = {k: (d_j64[k], d_jax[k]) for k in d_jax
             if d_j64[k] > 0.1 * d_jax[k]}
    assert not loose, loose
    far = {k: (d_port[k], d_jax[k]) for k in d_port
           if d_port[k] > 3 * d_jax[k] + 1e-6}
    print("port beyond 3x JAX + 1e-6:", far)
    assert not far, far


def test_clip_norm_of_a_large_tensor():
    """The global-norm clip of one 4 M-element gradient: after one step,
    Adam's first moment is (1 - b1) g / |g| with |g| exact to f32
    rounding (torch's f32 norm on the CPU was off by 6e-5 here, the
    scale error the oracle above found on every tensor of the port)."""
    g = torch.Generator().manual_seed(0)
    p = torch.nn.Parameter(torch.zeros(4_000_000))
    p.grad = torch.randn(4_000_000, generator=g) * 1e-3 + 1e-3
    opt = TS.make_optimizer([p], **OPT)
    opt.step()
    want = 0.1 * p.grad.double() / p.grad.double().norm()
    rel = float((opt.state[p]["mu"].double() - want).norm() / want.norm())
    assert rel < 1e-6, rel


@pytest.mark.parametrize("queries,grad,fused", [
    (1, False, False), (1, True, False), (5, True, False), (5, False, True)])
def test_attention_path_keyed_to_the_read(queries, grad, fused,
                                          monkeypatch):
    """``blocks._sdpa`` takes the fused kernel only for a read with more
    than one query that no backward runs through, on either device; both
    paths give the same values."""
    from cut3r_slam_tpu_torch.models import blocks
    calls = []
    real = blocks.F.scaled_dot_product_attention

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(blocks.F, "scaled_dot_product_attention", spy)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 3, queries, 8, generator=g).requires_grad_(grad)
    k, v = torch.randn(2, 2, 3, 7, 8, generator=g)
    out = blocks._sdpa(q, k, v, 8 ** -0.5)
    assert bool(calls) == fused
    want = torch.softmax(q @ k.transpose(-2, -1) * 8 ** -0.5, -1) @ v
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
