"""The yardstick of the blend kernels, on the CPU: ``chip_smoke.blend_census``
(the (entry, pixel) pairs the kernels visit, by kind) against a brute-force
walk over each pixel, and ``chip_smoke.bound_ms`` taking the largest of its
bytes, FP32 and MUFU parts. Every kernel time in PERF.md is read against
this bound, so it is held here independently of the kernels.

The scenes are ``chip_smoke.staging_scene`` (ragged extents 0 to 200,
pixels that stop inside and across 128-entry stages, a row of rejected
entries) at seeds whose alpha / T_MIN decisions sit at least 1e-5
(relative) from their thresholds, so the float64 walk and the float32
census take the same decisions.
"""
import numpy as np
import pytest
import torch

import chip_smoke as CS
from cut3r_slam_tpu_torch.ops import gs_raster_cuda as G
from cut3r_slam_tpu_torch.ops.gs_raster import ALPHA_MIN, T_MIN


def _walk(A, ext):
    """(rejected, stopping, blended) pairs by a sequential walk over each
    pixel's entries in float64: a stopping pair ends the pixel's walk."""
    x = np.arange(G.PX) % 16.0
    y = np.arange(G.PX) // 16 * 1.0
    counts = np.zeros(3, np.int64)
    for r in range(A.shape[0]):
        T = np.ones(G.PX)
        live = np.ones(G.PX, bool)
        for e in range(ext[r]):
            q = A[r, e, 7:13].astype(np.float64)
            power = q[0] + q[1] * x + q[2] * y + q[3] * x * x \
                + q[4] * y * y + q[5] * x * y
            alpha = np.minimum(0.99, np.exp(power))
            ok = alpha >= ALPHA_MIN
            Tn = T * (1.0 - alpha)
            stop = live & ok & (Tn < T_MIN)
            blend = live & ok & ~stop
            counts += [(live & ~ok).sum(), stop.sum(), blend.sum()]
            T = np.where(blend, Tn, T)
            live &= ~stop
    return counts.tolist()


@pytest.mark.parametrize("seed", [0, 2])
def test_census_matches_per_pixel_walk(seed):
    A, ext = CS.staging_scene(seed)
    census = CS.blend_census(torch.tensor(A), torch.tensor(ext))
    walk = _walk(A, ext)
    assert census == walk
    assert min(walk) > 0          # every kind of pair occurs


@pytest.mark.parametrize("name", ["gs_blend_fwd", "gs_blend_bwd"])
@pytest.mark.parametrize("pairs, part", [
    ((0, 0, 0), 0),               # no pair: the bytes bound it
    ((10 ** 9, 0, 0), 2),         # rejected pairs: one exp on 13 FLOPs
    ((0, 0, 10 ** 9), 1),         # blended pairs: FP32
])
def test_bound_is_largest_part(name, pairs, part):
    A, ext = CS.staging_scene(0)
    A, ext = torch.tensor(A), torch.tensor(ext)
    _, tchk = G.blend_forward_plain(A, ext, with_residuals=True)
    ms, by, parts = CS.bound_ms(name, A, ext, tchk, pairs)
    assert ms == max(parts)
    assert int(np.argmax(parts)) == part
    assert by == ("bytes" if part == 0 else "operations")
