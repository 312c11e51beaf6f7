"""K3 (``csrc/gs_pack_bwd.cu``), the pack gather's backward, on the card.
Every test needs a GPU (marker ``cuda``) and skips without one. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_pack_bwd_cuda.py -q

The kernel's dRaw must be bitwise (``torch.equal``) torch's own
accumulation ``zeros.index_put_((entry_gauss,), dG, accumulate=True)``
over every entry, which is what autograd runs for ``raw[entry_gauss]``:
both add each row's entries from +0.0 in ascending entry order, and the
kernel skips only masked-out entries, whose cotangents are exactly zero.
Shapes: the mapping's (384x512 = 768 tile rows x 512 entries, an arena of
2^18 with ~95k Gaussians alive, V = 6 and V = 1), cached bins whose fresh
validity punches holes, an all-masked render, and hand-built rows past
the list capacity.
"""
import pytest
import torch

from cut3r_slam_tpu_torch import full_f32
from cut3r_slam_tpu_torch.bench import micro_scene
from cut3r_slam_tpu_torch.ops import gs_raster_cuda as G
from cut3r_slam_tpu_torch.slam.renderer import (bin_window, render_view,
                                                render_window)
from cut3r_slam_tpu_torch.utils.profiling import StageTimer, attach

pytestmark = pytest.mark.cuda

H, W = 384, 512
ARENA = 2 ** 18
ALIVE = 95_000


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 runs only on the card")
    with full_f32():
        yield torch.device("cuda")


@pytest.fixture(scope="module")
def scene(cuda):
    """The mapping's shape: 2^18 slots, ~95k alive, 6 poses 5 cm apart."""
    params, _, w2c, K4, cfg = micro_scene(H, W, ARENA, cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    alive = torch.rand(ARENA, generator=g, device=cuda) < ALIVE / ARENA
    w2cs = w2c.repeat(6, 1, 1)
    w2cs[:, 0, 3] = 0.05 * torch.arange(6, device=cuda)
    return params, alive, w2cs, K4, cfg


def _captured(fn):
    """Run ``fn`` with ``G.pack_backward`` recording its inputs; returns
    ([(dG, entry_gauss, entry_mask, n_rows, cap, dRaw)], fn's result)."""
    seen, orig = [], G.pack_backward

    def spy(dG, eg, em, n_rows, cap):
        out = orig(dG, eg, em, n_rows, cap)
        seen.append((dG.clone(), eg.clone(), em.clone(), n_rows, cap,
                     out.clone()))
        return out
    G.pack_backward = spy
    try:
        res = fn()
    finally:
        G.pack_backward = orig
    return seen, res


def _leaves(params):
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}


def _grad_window(params, alive, w2cs, K4, cfg, bins=None):
    p = _leaves(params)
    out = render_window(p, alive, w2cs, K4, cfg, bins=bins)
    loss = out["color"].mean() + 0.1 * out["depth"].mean()
    return torch.autograd.grad(loss, list(p.values()))


def _index_put(dG, eg, n_rows):
    return torch.zeros(n_rows, dG.shape[1], device=dG.device).index_put_(
        (eg,), dG, accumulate=True)


def _check_equal(rec):
    dG, eg, em, n_rows, cap, dRaw = rec
    assert not bool(dG[~em].any()), "a masked-out entry carries a cotangent"
    ref = _index_put(dG, eg, n_rows)
    assert torch.equal(dRaw, ref), float((dRaw - ref).abs().max())
    # the same sums from the kernel again: no run-to-run difference
    assert torch.equal(G.pack_backward(dG, eg, em, n_rows, cap), dRaw)


def test_window_gradient_at_the_mapping_shape(cuda, scene):
    """(a) V = 6 at the mapping's shape: a real ``render_window`` gradient's
    packed cotangent is exactly zero on every masked-out entry, and K3's
    dRaw is torch's accumulation bit for bit; again with random cotangents
    on the masked-in entries."""
    params, alive, w2cs, K4, cfg = scene
    before = G.LAUNCHES["gs_pack_bwd"]
    seen, _ = _captured(lambda: _grad_window(params, alive, w2cs, K4, cfg))
    assert len(seen) == 1 and G.LAUNCHES["gs_pack_bwd"] == before + 1
    dG, eg, em, n_rows, cap, _ = seen[0]
    assert n_rows == 6 * ARENA and cap == cfg.max_dup == 16
    assert dG.shape == (6 * cfg.n_tiles * cfg.max_per_tile, 16)
    assert 0 < int(em.sum()) < em.numel()
    assert bool(dG[em].any())
    _check_equal(seen[0])
    g = torch.Generator(device=cuda).manual_seed(1)
    rnd = torch.randn(dG.shape, generator=g, device=cuda) * em[:, None]
    _check_equal((rnd, eg, em, n_rows, cap,
                  G.pack_backward(rnd, eg, em, n_rows, cap)))


def test_cached_bins_with_holes(cuda, scene):
    """(b) bins cached at one state, rendered after a fifth of the
    Gaussians moved behind the camera: the fresh validity masks their
    entries inside the rows."""
    params, alive, w2cs, K4, cfg = scene
    bins = bin_window(params, alive, w2cs, K4, cfg)
    moved = dict(params)
    g = torch.Generator(device=cuda).manual_seed(2)
    hide = torch.rand(ARENA, generator=g, device=cuda) < 0.2
    xyz = params["xyz"].clone()
    xyz[hide, 2] = -1.0
    moved["xyz"] = xyz
    seen, _ = _captured(lambda: _grad_window(moved, alive, w2cs, K4, cfg,
                                             bins=bins))
    em = seen[0][2].reshape(6, cfg.n_tiles, cfg.max_per_tile)
    ext = G._extent(em.reshape(-1, cfg.max_per_tile)).long()
    k = torch.arange(cfg.max_per_tile, device=cuda)
    holes = (~em.reshape(-1, cfg.max_per_tile)) & (k[None] < ext[:, None])
    assert bool(holes.any()), "no hole inside a row"
    _check_equal(seen[0])


def test_all_masked(cuda, scene):
    """(c) every entry masked out: dRaw is zero (the kernel's stores, no
    memset)."""
    params, alive, w2cs, K4, cfg = scene
    E = 6 * cfg.n_tiles * cfg.max_per_tile
    eg = torch.zeros(E, dtype=torch.long, device=cuda)
    eg = eg + (torch.arange(6, device=cuda) * ARENA).repeat_interleave(
        E // 6)
    em = torch.zeros(E, dtype=torch.bool, device=cuda)
    dG = torch.zeros(E, 16, device=cuda)
    dRaw = G.pack_backward(dG, eg, em, 6 * ARENA, cfg.max_dup)
    assert not bool(dRaw.any())
    _check_equal((dG, eg, em, 6 * ARENA, cfg.max_dup, dRaw))


def test_one_view(cuda, scene):
    """(d) V = 1 through ``render_view``."""
    params, alive, w2cs, K4, cfg = scene

    def grad():
        p = _leaves(params)
        out = render_view(p, alive, w2cs[0], K4, cfg)
        return torch.autograd.grad(out["color"].mean(), list(p.values()))
    seen, _ = _captured(grad)
    assert len(seen) == 1 and seen[0][3] == ARENA
    _check_equal(seen[0])


@pytest.mark.parametrize("heavy_rows", [1, 50, 2000])
def test_rows_past_capacity(cuda, heavy_rows):
    """(e) hand-built bins: half the entries fall on ``heavy_rows`` rows
    (tens to thousands of entries each, past the 16-slot lists), the rest
    spread over the arena; both branches of the row sum in one call."""
    g = torch.Generator(device=cuda).manual_seed(heavy_rows)
    E, n_rows = 768 * 512, 3 * ARENA
    heavy = torch.randint(0, heavy_rows, (E,), generator=g, device=cuda)
    light = torch.randint(0, n_rows, (E,), generator=g, device=cuda)
    eg = torch.where(torch.rand(E, generator=g, device=cuda) < 0.5, heavy,
                     light)
    em = torch.rand(E, generator=g, device=cuda) < 0.7
    eg = torch.where(em, eg, torch.zeros_like(eg))
    dG = torch.randn(E, 16, generator=g, device=cuda) * em[:, None]
    counts = torch.bincount(eg[em], minlength=n_rows)
    assert int(counts.max()) > 16
    dRaw = G.pack_backward(dG, eg, em, n_rows, 16)
    _check_equal((dG, eg, em, n_rows, 16, dRaw))


def test_gradient_render_counts_the_kernel(cuda):
    """One CUDA gradient render of V views: ``render.views.grad`` = V,
    ``render.views.nograd`` = V for the render without a gradient, and one
    K3 launch inside ``raster.pack_bwd``."""
    params, alive, w2c, K4, cfg = micro_scene(64, 96, 2 ** 12, cuda)
    w2cs = w2c.repeat(3, 1, 1)
    before = G.LAUNCHES["gs_pack_bwd"]
    timer = StageTimer()
    prev = attach(timer)
    try:
        _grad_window(params, alive, w2cs, K4, cfg)
        with torch.no_grad():
            render_window(params, alive, w2cs, K4, cfg)
    finally:
        attach(prev)
    assert {k: v for k, v in timer.counters.items()
            if k.startswith("render.views.")} == {"render.views.grad": 3,
                                                  "render.views.nograd": 3}
    assert timer.counts["raster.pack_bwd"] == 1
    assert G.LAUNCHES["gs_pack_bwd"] == before + 1


def test_refuses_misaligned_cotangents(cuda):
    dG = torch.zeros(64 * 16 + 1, device=cuda)[1:].view(64, 16)
    eg = torch.zeros(64, dtype=torch.long, device=cuda)
    em = torch.ones(64, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        G.pack_backward(dG, eg, em, 8, 16)
    with pytest.raises(ValueError):
        G.pack_backward(dG.clone(), eg.cpu(), em, 8, 16)
