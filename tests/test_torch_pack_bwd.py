"""K3, the pack gather's backward (``csrc/gs_pack_bwd.cu``), on the CPU:
its plain version, its autograd Function, its input checks and its
registration. The kernel itself runs only on the card
(tests/test_torch_pack_bwd_cuda.py). This file imports no JAX.

* ``pack_backward`` (the plain version on the CPU) equals torch's
  ``index_put_`` accumulation over every entry, masked-out ones carrying
  zero, bit for bit: with holes in the mask, with every entry masked, with
  rows past the list capacity.
* ``_PackGatherFn`` on a real packed render through the plain blend gives
  the attribute rows bitwise the gradient of the plain gather
  ``raw[entry_gauss]``; the masked-out entries' cotangents are exactly
  zero.
* CPU gradient renders take ``_PackGatherFn``, as the card's do: they
  count ``render.views.grad``, launch nothing, and give the leaves
  bitwise the gradients of the plain gather ``raw[entry_gauss]`` with
  torch's indexing backward.
* ``pack_backward`` refuses malformed inputs on either device.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from cut3r_slam_tpu_torch.kernels import build
from cut3r_slam_tpu_torch.ops import gs_raster_cuda as G
from cut3r_slam_tpu_torch.ops.gs_raster import (RasterizeConfig,
                                                _bin_gaussians, _preprocess)
from cut3r_slam_tpu_torch.utils.profiling import StageTimer, attach

H, W = 32, 32
K4 = np.asarray([40.0, 40.0, W / 2, H / 2], np.float32)
CFG = RasterizeConfig(height=H, width=W, max_dup=16, max_per_tile=64,
                      chunk=32, kernel_size=0.1)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(n=80, V=2, seed=5):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                      rng.uniform(1.0, 3.0, n)], -1)
    q = rng.normal(size=(n, 4))
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    shift = np.asarray([0.03, -0.02, 0.01])
    arrs = [np.stack([means + v * shift for v in range(V)]),
            np.stack([q] * V), rng.uniform(0.02, 0.12, (n, 3)),
            rng.uniform(0.2, 0.9, n), rng.uniform(0, 1, (n, 3))]
    return [torch.tensor(np.asarray(a, np.float32)) for a in arrs]


def _case(kind, seed=0):
    """(dG, entry_gauss, entry_mask, n_rows, cap) of one shape of entries,
    masked-out rows of dG zero and masked-out slots pointing at row 0 of
    their view, as the binning leaves them."""
    g = torch.Generator().manual_seed(seed)
    V, P, nt, K, cap = (1 if kind == "one_view" else 3), 200, 12, 32, 16
    E = V * nt * K
    if kind == "past_capacity":
        # hand-built bins: 5 rows share every masked-in entry
        eg = torch.randint(0, 5, (V, nt, K), generator=g)
    else:
        # each Gaussian at most once a tile: in at most nt <= cap tiles
        eg = torch.stack([torch.stack([torch.randperm(P, generator=g)[:K]
                                       for _ in range(nt)])
                          for _ in range(V)])
    em = torch.rand(V, nt, K, generator=g) < 0.6
    if kind == "holes":
        em &= torch.rand(V, nt, K, generator=g) < 0.7
    if kind == "all_masked":
        em[:] = False
    eg = torch.where(em, eg, torch.zeros_like(eg))
    eg = (eg + (torch.arange(V) * P)[:, None, None]).reshape(-1)
    em = em.reshape(-1)
    dG = torch.randn(E, 16, generator=g) * em[:, None]
    return dG, eg, em, V * P, cap


CASES = ["plain", "holes", "all_masked", "one_view", "past_capacity"]


@pytest.mark.parametrize("kind", CASES)
def test_plain_pack_backward_is_index_put(kind):
    dG, eg, em, n_rows, cap = _case(kind)
    got = G.pack_backward(dG, eg, em, n_rows, cap)
    ref = torch.zeros(n_rows, 16).index_put_((eg,), dG, accumulate=True)
    assert torch.equal(got, ref)
    if kind == "past_capacity":
        counts = torch.bincount(eg[em], minlength=n_rows)
        assert int(counts.max()) > cap
    if kind == "all_masked":
        assert not bool(got.any())


def _packed_render(seed, use_fn):
    """One view's pack gather (through ``_PackGatherFn`` or the plain
    ``raw[entry_gauss]``), packing and plain blend on the CPU; returns the
    gradient of raw and the gather's cotangent with the entry mask."""
    means, quats, scales, opac, colors = _scene(V=1, seed=seed)
    pre = _preprocess(means, quats, scales, opac, torch.tensor(K4), CFG)
    eg, em = _bin_gaussians({k: v[0] for k, v in pre.items()}, CFG)
    raw = G._build_raw(pre, colors).reshape(-1, 16).detach() \
        .requires_grad_(True)
    gathered = G._PackGatherFn.apply(raw, eg, em, CFG.max_dup) if use_fn \
        else raw[eg]
    seen = []
    gathered.register_hook(seen.append)
    ox, oy = G._tile_origins(CFG, raw.device)
    A = G._assemble_A(gathered, ox, oy, em)
    O, dsum, mdep, T = G._blend(A, G._extent(em), True)
    g = torch.Generator().manual_seed(seed)
    loss = sum((x * torch.randn(x.shape, generator=g)).sum()
               for x in (O, dsum, T))
    (d_raw,) = torch.autograd.grad(loss, raw)
    return d_raw, seen[0], em


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_gather_fn_is_the_plain_gather_gradient(seed):
    d_fn, dG, em = _packed_render(seed, True)
    d_plain, dG_plain, _ = _packed_render(seed, False)
    assert bool(em.any()) and not bool(em.all())
    # the masked-out entries' cotangents are exactly zero
    assert not bool(dG[~em].any()) and not bool(dG_plain[~em].any())
    assert bool(dG[em].any())
    assert torch.equal(d_fn, d_plain)


def _grad_render(monkeypatch, gather):
    """The leaves, their gradients filled, of a two-view CPU render whose
    pack gather is ``gather`` in place of ``_PackGatherFn.apply``."""
    monkeypatch.setattr(G._PackGatherFn, "apply", gather)
    ts = [t.requires_grad_(True) for t in _scene()]
    out = G.rasterize_cuda_multi(*ts, torch.tensor(K4), CFG)
    (out["color"].sum() + out["depth"].sum()).backward()
    return ts


def test_cpu_render_takes_the_pack_gather_fn(monkeypatch):
    fn = G._PackGatherFn.apply
    calls = []
    launches = dict(G.LAUNCHES)
    timer = StageTimer()
    prev = attach(timer)
    try:
        ts = _grad_render(monkeypatch, lambda *a: calls.append(
            a[0].device.type) or fn(*a))
        with torch.no_grad():
            G.rasterize_cuda_multi(*[t.detach() for t in ts],
                                   torch.tensor(K4), CFG)
    finally:
        attach(prev)
    assert calls == ["cpu"]
    assert {k: v for k, v in timer.counters.items()
            if k.startswith("render.views.")} == {"render.views.grad": 2,
                                                  "render.views.nograd": 2}
    assert timer.counts["raster.pack_bwd"] == 1
    assert G.LAUNCHES == launches
    # the same render through the plain gather, torch's indexing backward
    plain = _grad_render(monkeypatch, lambda raw, eg, em, cap: raw[eg])
    for a, b in zip(ts, plain):
        assert bool(torch.isfinite(a.grad).all()) and bool(a.grad.any())
        assert torch.equal(a.grad, b.grad)


def test_build_registers_pack_bwd():
    sym, argtypes = build.SOURCES["gs_pack_bwd"]
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert sym == "gs_pack_bwd"
    assert argtypes == [P, P, P, I, LL, I, P, P, P]
    src = (build.CSRC / "gs_pack_bwd.cu").read_text()
    m = re.search(r'extern "C" int gs_pack_bwd\(([^)]*)\)', src)
    params = [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]
    assert params == ["dG", "eg", "em", "E", "n_rows", "cap", "work", "dRaw",
                      "stream"]
    assert G.LAUNCHES.get("gs_pack_bwd") is not None


def _bad(kind):
    dG, eg, em, n_rows, cap = _case("plain")
    if kind == "dG_float64":
        dG = dG.double()
    elif kind == "dG_strided":
        dG = dG.t().contiguous().t()
    elif kind == "dG_channels":
        dG = dG[:, :8].contiguous()
    elif kind == "gauss_int32":
        eg = eg.int()
    elif kind == "gauss_length":
        eg = eg[:-1].contiguous()
    elif kind == "mask_uint8":
        em = em.to(torch.uint8)
    elif kind == "mask_2d":
        em = em[:, None]
    elif kind == "cap_zero":
        cap = 0
    elif kind == "rows_negative":
        n_rows = -1
    elif kind == "mixed_devices":
        eg = eg.to("meta")
    return dG, eg, em, n_rows, cap


@pytest.mark.parametrize("kind", [
    "dG_float64", "dG_strided", "dG_channels", "gauss_int32", "gauss_length",
    "mask_uint8", "mask_2d", "cap_zero", "rows_negative", "mixed_devices"])
def test_pack_backward_refuses_malformed_inputs(kind):
    with pytest.raises(ValueError):
        G.pack_backward(*_bad(kind))
