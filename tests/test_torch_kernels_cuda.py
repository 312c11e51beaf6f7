"""The port's CUDA blend kernels on the card, against their plain PyTorch
versions. Every test here needs a GPU (marker ``cuda``) and skips without
one. This file imports neither JAX nor the JAX package, so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest``: the suite's conftest.py configures JAX.)

Tolerances: the kernel multiplies transmittance sequentially and the plain
version through a chunk prefix product, so outputs agree to 1e-4 except
where the T_MIN stop or the median gate sits within float rounding of its
threshold, which the small scenes here do not hit; gradients to 5e-4 of
their max (the JAX suite's gradient tolerance), channel by channel for
the packed entries (their 16 channels differ in scale by four orders).
Everything runs under ``full_f32`` (no TF32).
"""
import numpy as np
import pytest
import torch

from cut3r_slam_tpu_torch import full_f32
from cut3r_slam_tpu_torch.ops import gs_raster_cuda as G
from cut3r_slam_tpu_torch.ops.gs_raster import RasterizeConfig

pytestmark = pytest.mark.cuda

H, W = 32, 32
K4 = np.asarray([40.0, 40.0, W / 2, H / 2], np.float32)
CFG = RasterizeConfig(height=H, width=W, max_dup=16, max_per_tile=64,
                      chunk=32, kernel_size=0.1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the blend kernels run only on the "
                    "card (chip_smoke.py holds them there too)")
    with full_f32():
        yield torch.device("cuda")


def _scene(n=60, V=3, seed=3):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.4, 0.4, n),
                      rng.uniform(1.0, 3.0, n)], -1)
    q = rng.normal(size=(n, 4))
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    shift = np.asarray([0.02, -0.01, 0.03])
    arrs = [np.stack([means + v * shift for v in range(V)]),
            np.stack([q] * V), rng.uniform(0.02, 0.1, (n, 3)),
            rng.uniform(0.2, 0.9, n), rng.uniform(0, 1, (n, 3))]
    return [np.asarray(a, np.float32) for a in arrs]


def _on(arrs, device, grad=False):
    return [torch.tensor(a, device=device, requires_grad=grad) for a in arrs]


def _packed(scene, device):
    """The kernels' inputs (A, extent) on ``device``: the random 32x32
    scene packed by the renderer, or chip_smoke.staging_scene (K = 200,
    extents 0, 1, 31, 33, 97 and 200 in one launch, pixels stopping inside
    a 128-entry stage and across its end, a row of rejected entries)."""
    if scene == "small":
        return G.packed_entries(*_on(_scene(), device),
                                torch.tensor(K4, device=device), CFG)
    from chip_smoke import staging_scene
    A, ext = staging_scene()
    return torch.tensor(A, device=device), torch.tensor(ext, device=device)


SCENES = ["small", "staging"]


@pytest.mark.parametrize("scene", SCENES)
def test_forward_kernel_matches_plain(cuda, scene):
    A, ext = _packed(scene, cuda)
    before = G.LAUNCHES["gs_blend_fwd"]
    (O, d, md, T), tchk = G.blend_forward(A, ext, with_residuals=True)
    assert G.LAUNCHES["gs_blend_fwd"] == before + 1
    (O2, d2, md2, T2), tchk2 = G.blend_forward_plain(A, ext, True)
    for a, b in ((O, O2), (d, d2), (md, md2), (T, T2), (tchk, tchk2)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    fwd_only = G.blend_forward(A, ext)
    for a, b in zip(fwd_only, (O, d, md, T)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("median_cotangent", [False, True])
def test_backward_kernel_matches_plain_vjp(cuda, median_cotangent, scene):
    A, ext = _packed(scene, cuda)
    (O, d, md, T), tchk = G.blend_forward(A, ext, with_residuals=True)
    g = torch.Generator(device=cuda).manual_seed(0)
    cots = [torch.randn(x.shape, generator=g, device=cuda)
            for x in (O, d, md, T)]
    if not median_cotangent:
        cots[2].zero_()
    before = G.LAUNCHES["gs_blend_bwd"]
    dA = G.blend_backward(A, ext, tchk, T, *cots)
    assert G.LAUNCHES["gs_blend_bwd"] == before + 1
    ref = G.blend_backward_plain(A, ext, *cots)
    rel = (dA - ref).abs().amax((0, 1)) / ref.abs().amax((0, 1)).clamp(
        min=1e-12)
    assert bool((rel < 5e-4).all()), rel


def test_render_gradients_match_cpu_plain_path(cuda):
    """rasterize_cuda_multi end to end on the card (kernels) vs the same
    call on the CPU (plain blend)."""
    arrs = _scene()
    grads, outs = {}, {}
    for dev in (cuda, torch.device("cpu")):
        ts = _on(arrs, dev, grad=True)
        out = G.rasterize_cuda_multi(*ts, torch.tensor(K4, device=dev), CFG)
        (out["color"].sum() + out["depth"].sum()
         + 0.1 * out["normal"].sum()).backward()
        grads[dev.type] = [t.grad.cpu() for t in ts]
        outs[dev.type] = {k: v.detach().cpu() for k, v in out.items()}
    for k in ("color", "alpha", "depth", "normal"):
        torch.testing.assert_close(outs["cuda"][k], outs["cpu"][k],
                                   atol=1e-4, rtol=1e-4)
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert float((a - b).abs().max() / b.abs().max().clamp(min=1e-6)) \
            < 5e-4


def test_wrappers_refuse_bad_inputs(cuda):
    A, ext = G.packed_entries(*_on(_scene(), cuda),
                              torch.tensor(K4, device=cuda), CFG)
    with pytest.raises(ValueError):
        G.blend_forward(A.double(), ext)
    with pytest.raises(ValueError):
        G.blend_forward(A.transpose(1, 2), ext)
    with pytest.raises(ValueError):
        G.blend_forward(A, ext.long())
    shifted = torch.empty(A.numel() + 1, device=cuda)[1:].view(A.shape)
    shifted.copy_(A)                  # contiguous, 4 bytes off alignment
    with pytest.raises(ValueError):
        G.blend_forward(shifted, ext)
