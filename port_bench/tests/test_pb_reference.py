"""The reference against the port at tiny sizes on the CPU (both in
float32): CUT3R's forward, the training loss and AdamW, the plain
rasterizer with its gradient (fresh and reused binning), the mapper's
window and global-BA losses with their gradients, the mapper's Adam, and
the blend census on a scene counted by hand."""
import numpy as np
import pytest
import torch

from conftest import TINY
from port_bench.reference import adam as ref_adam
from port_bench.reference import cut3r as R
from port_bench.reference import map_loss as RL
from port_bench.reference import raster as RR
from port_bench.reference import train as RT
from port_bench.weights import draw_state_dict


def _close(a, b, tol):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30)) < tol


@pytest.fixture(scope="module")
def models():
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    sd = draw_state_dict(TINY, 3, "cpu", scale={
        "downstream_head.dpt_self.head.4.weight": 0.05})
    port = CUT3R(CUT3RConfig(**TINY, compute_dtype=torch.float32),
                 device="cpu")
    port.load_state_dict(sd, strict=True)
    ref = R.CUT3R(R.CUT3RConfig(**TINY))
    ref.load_state_dict(sd, strict=True)
    return port, ref


def test_cut3r_forward_matches_the_port(models):
    port, ref = models
    g = torch.Generator().manual_seed(0)
    imgs = torch.rand(3, 1, 32, 48, 3, generator=g) * 2 - 1
    with torch.no_grad():
        a = port(imgs)
        b = ref(imgs)
        fa, pa = port.encode_image(imgs[:, 0])
        fb, pb = ref.encode_image(imgs[:, 0])
        da, _ = port.decode_views(fa[:, None], pa[:, None], 32, 48,
                                  head_outputs=("self", "pose"))
        db = ref.decode_views(fb[:, None], pb[:, None], 32, 48,
                              ("self", "pose"))
    for k in b:
        assert _close(a[k], b[k], 1e-5), k
    for k in db:
        assert _close(da[k], db[k], 1e-5), k


def _batch(seed=5):
    from cut3r_slam_tpu_torch.geometry.pointmap import depth_to_pointmap
    from cut3r_slam_tpu_torch.geometry.lie import se3_exp, se3_matrix
    g = torch.Generator().manual_seed(seed)
    V, H, W = 3, 32, 48
    c2w = se3_matrix(se3_exp(0.1 * torch.randn(V, 6, generator=g)))
    depth = 1 + torch.rand(V, H, W, generator=g)
    K = torch.tensor([40.0, 40.0, 24.0, 16.0])
    pts = torch.stack([depth_to_pointmap(depth[v], K, c2w=c2w[v])
                       for v in range(V)])
    imgs = torch.rand(V, 1, H, W, 3, generator=g) * 2 - 1
    return {"imgs": imgs, "img": imgs, "pts3d": pts[:, None],
            "camera_pose": c2w[:, None],
            "valid_mask": (torch.rand(V, 1, H, W, generator=g) > 0.1)}


def test_loss_matches_the_port(models):
    from cut3r_slam_tpu_torch.train.losses import cut3r_total_loss
    port, _ = models
    b = _batch()
    with torch.no_grad():
        pred = port(b["imgs"])
    want, _ = cut3r_total_loss(pred, b)
    assert float(RT.total_loss(pred, b)) == pytest.approx(float(want),
                                                          rel=1e-6)


def test_adamw_matches_the_port():
    from cut3r_slam_tpu_torch.train.train_step import make_optimizer
    g = torch.Generator().manual_seed(1)
    p0 = {"a": torch.randn(5, 4, generator=g), "b": torch.randn(7,
                                                               generator=g)}
    pa = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    pb = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    oa = make_optimizer(list(pa.values()), warmup_steps=2, total_steps=10)
    ob = RT.AdamW(pb.items(), warmup_steps=2, total_steps=10)
    for _ in range(3):
        grads = {k: 3 * torch.randn(v.shape, generator=g)
                 for k, v in p0.items()}
        for d in (pa, pb):
            for k, v in d.items():
                v.grad = grads[k].clone()
        oa.step()
        ob.step()
    for k in p0:
        assert torch.allclose(pa[k], pb[k], rtol=0, atol=1e-7)


def _scene(P=300, seed=0):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(P, 3, generator=g) * 2 - 1
    xyz[:, 2] += 3.0
    q = torch.randn(P, 4, generator=g)
    return {"xyz": xyz, "f_dc": torch.randn(P, 3, generator=g),
            "opacity_logit": torch.randn(P, generator=g),
            "log_scales": torch.randn(P, 3, generator=g) * 0.3 - 2.5,
            "quat": q / q.norm(dim=-1, keepdim=True)}


@pytest.mark.parametrize("reuse_bins", [False, True])
def test_render_and_gradient_match_the_port(reuse_bins):
    from cut3r_slam_tpu_torch.ops.gs_raster import RasterizeConfig
    from cut3r_slam_tpu_torch.slam.renderer import bin_window, render_window
    params = _scene()
    alive = torch.ones(300, dtype=torch.bool)
    alive[::7] = False
    w2cs = torch.eye(4).repeat(2, 1, 1)
    w2cs[1, 0, 3] = 0.1
    K4 = torch.tensor([40.0, 40.0, 24.0, 16.0])
    cfg = RasterizeConfig(height=32, width=48, max_per_tile=64)
    rcfg = RR.RasterizeConfig(height=32, width=48, max_per_tile=64)
    g = torch.Generator().manual_seed(2)
    dt = 0.01 * torch.randn(2, 3, generator=g)
    dr = 0.01 * torch.randn(2, 3, generator=g)
    moved = {k: v + 0.01 * torch.randn(v.shape, generator=g)
             for k, v in params.items()} if reuse_bins else params
    bins = bin_window(params, alive, w2cs, K4, cfg, trans_deltas=dt,
                      rot_deltas=dr) if reuse_bins else None
    bins_from = [RR.camera_frame(params, alive, w2cs[v], dt[v], dr[v])
                 for v in range(2)] if reuse_bins else None
    cot = torch.randn(2, 32, 48, 3, generator=g)

    def leaves():
        return [t.clone().requires_grad_(True)
                for t in list(moved.values()) + [dt, dr]]

    la = leaves()
    out_a = render_window(dict(zip(moved, la[:5])), alive, w2cs, K4, cfg,
                          trans_deltas=la[5], rot_deltas=la[6], bins=bins)
    ga = torch.autograd.grad((out_a["color"] * cot).sum(), la)
    lb = leaves()
    out_b = RR.render_views(dict(zip(moved, lb[:5])), alive, w2cs, K4, rcfg,
                            lb[5], lb[6], bins_from=bins_from)
    gb = torch.autograd.grad((out_b["color"] * cot).sum(), lb)
    assert _close(out_a["color"], out_b["color"], 1e-5)
    assert _close(out_a["depth"], out_b["depth"], 1e-5)
    for a, b in zip(ga, gb):
        assert _close(a, b, 1e-4)


def _mapper(V, g):
    """A bare port mapper at 32x48 with V keyframes' images and depths."""
    import types
    from cut3r_slam_tpu_torch.ops.gs_raster import RasterizeConfig
    from cut3r_slam_tpu_torch.slam.mapping import (MappingBackend,
                                                   MappingConfig)
    mb = MappingBackend.__new__(MappingBackend)
    mb.cfg = MappingConfig(height=32, width=48)
    mb.K4 = torch.tensor([40.0, 40.0, 24.0, 16.0])
    mb.raster_cfg = RasterizeConfig(height=32, width=48, max_per_tile=64)
    mb.device = torch.device("cpu")
    yy = torch.arange(32.0)[:, None].expand(32, 48)
    mb.cams = types.SimpleNamespace(
        image=(torch.rand(V, 32, 48, 3, generator=g) * 255).to(torch.uint8),
        depth=(3.0 + 0.02 * yy + 0.05 * torch.rand(V, 32, 48, generator=g)))
    return mb


@pytest.mark.parametrize("kind", ["window", "gba"])
def test_mapper_losses_match_the_port(kind):
    """The plain window loss and global-BA loss, and their gradients by
    leaf, against the port's ``_window_loss`` / ``_gba_batch``."""
    from cut3r_slam_tpu_torch.geometry.pointmap import depth_to_normal
    g = torch.Generator().manual_seed(6)
    V = 3
    mb = _mapper(V, g)
    params = _scene()
    alive = torch.ones(300, dtype=torch.bool)
    alive[::7] = False
    w2cs = torch.eye(4).repeat(V, 1, 1)
    w2cs[:, 0, 3] = 0.1 * torch.arange(V)
    ex = {"a": torch.eye(3).repeat(V, 1, 1)
          + 0.01 * torch.randn(V, 3, 3, generator=g),
          "b": 0.01 * torch.randn(V, 3, generator=g)}
    vi = torch.arange(V)
    images, depths = mb._img(vi), mb._depth(vi)
    rcfg = RR.RasterizeConfig(height=32, width=48, max_per_tile=64)
    gdns = depth_to_normal(depths, mb.K4)
    if kind == "window":
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        pd = {k: torch.zeros(V, 3, requires_grad=True) for k in "tr"}
        e = {k: v.clone().requires_grad_(True) for k, v in ex.items()}
        loss = mb._window_loss(p, pd, e, alive, images, depths, w2cs,
                               torch.ones(V), None, gdns)
        names = list(p) + ["t", "r", "a", "b"]
        got = dict(zip(names, torch.autograd.grad(
            loss, list(p.values()) + [pd["t"], pd["r"], e["a"], e["b"]])))
        want_loss, want = RL.window_loss_grads(
            params, alive, w2cs, mb.K4, rcfg, images, depths, torch.ones(V),
            ex, torch.zeros(V, 3), torch.zeros(V, 3))
    else:
        loss, gp, _, _, _, gpes, _ = mb._gba_batch(
            params, alive, w2cs, ex["a"], ex["b"], vi, gdns)
        got = {**gp, **gpes}
        want_loss, want = RL.gba_loss_grads(params, alive, w2cs, mb.K4,
                                            rcfg, images, depths, ex)
    assert _close(torch.as_tensor(loss), torch.as_tensor(want_loss), 1e-5)
    m = alive[:, None]
    for k, a in got.items():
        b = want[k]
        if k in params:
            a, b = (torch.where(m if a.dim() > 1 else alive, x,
                                torch.zeros_like(x)) for x in (a, b))
        assert _close(a, b, 1e-4), k


def test_mapper_adam_matches_the_port():
    from cut3r_slam_tpu_torch.slam.mapping import Adam
    g = torch.Generator().manual_seed(4)
    p = {"x": torch.randn(6, 3, generator=g), "y": torch.randn(6,
                                                              generator=g)}
    opt = Adam(p)
    lrs = {"x": 1e-3, "y": 5e-2}
    for _ in range(2):
        opt.step(p, {k: torch.randn(v.shape, generator=g)
                     for k, v in p.items()}, lrs)
    before = {k: v.clone() for k, v in p.items()}
    m = {k: v.clone() for k, v in opt.m.items()}
    v = {k: x.clone() for k, x in opt.v.items()}
    grads = {k: torch.randn(x.shape, generator=g) for k, x in p.items()}
    want = ref_adam.adam_step(before, grads, m, v, opt.t, lrs)
    opt.step(p, grads, lrs)
    for k in p:
        assert torch.allclose(p[k], want[k], rtol=0, atol=1e-7)


def test_census_of_one_gaussian_by_hand():
    cfg = RR.RasterizeConfig(height=32, width=32, max_per_tile=8)
    means = torch.tensor([[0.0, 0.0, 2.0]])
    quats = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    scales = torch.full((1, 3), 0.05)
    opac = torch.tensor([0.9])
    K4 = torch.tensor([30.0, 30.0, 16.0, 16.0])
    rej, stop, blend = RR.blend_census(means, quats, scales, opac, K4, cfg)
    pre = RR._preprocess(means, quats, scales, opac, K4, cfg)
    eg, em = RR._bin_gaussians(pre, cfg)
    tiles = int(em.any(1).sum())
    pix = RR._pixel_grid(cfg, "cpu")[em.any(1)]
    d = pre["mean2d"][0] - pix
    c = pre["conic"][0]
    power = -0.5 * (c[0] * d[..., 0] ** 2 + c[2] * d[..., 1] ** 2) \
        - c[1] * d[..., 0] * d[..., 1]
    alpha = torch.clamp(pre["opacity"][0] * torch.exp(power), max=0.99)
    ok = int(((power <= 0) & (alpha >= RR.ALPHA_MIN)).sum())
    assert stop == 0
    assert blend == ok > 0
    assert rej + blend == tiles * 256


def test_fp8_control_rounds_the_products():
    x = torch.linspace(-3, 3, 101)
    y = R.round_fp8(x)
    assert 0 < float((y - x).abs().max()) < 0.2
    assert torch.unique(y).numel() < 101
    assert np.isclose(float(y.abs().max()), 3.0)
