"""The port's TSDF (``cut3r_slam_tpu_torch/utils/tsdf.py``, torch on the
volume's device) against ``cut3r_slam_tpu/utils/tsdf.py`` driving the
repository's C++ core (``csrc/tsdf_core.cpp``), which that module prefers
over its numpy fallback when it is built. The core is compiled here with
``g++ -O3 -fPIC -shared`` into the test's temporary directory (never into
``csrc/``), loaded with ctypes and patched in as the JAX module's
``_NATIVE``; without ``g++`` these comparisons skip.

Three frames of the procedural scene are fused by both: the same block
set, SDF, weight and colour within 1e-6 block by block; the meshes hold
the same triangles (sorted triangle sets within 1e-5; vertex order may
differ); tests/test_torch_offline_drivers.py compares the ply files.
The port follows the core where the numpy fallback differs;
``test_numpy_fallback_differs`` pins those differences."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cut3r_slam_tpu.utils import tsdf as JT
from cut3r_slam_tpu_torch.datasets.synthscene import SynthScene
from cut3r_slam_tpu_torch.datasets.synth_replica import camera_arc
from cut3r_slam_tpu_torch.utils import tsdf as TT
from test_torch_batched_mapping import few_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64
K4 = np.array([40.0, 40.0, 31.5, 23.5], np.float32)
VOXEL = 0.05


def build_core(out_dir):
    """libtsdf_core.so in ``out_dir`` with the JAX module's argtypes."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the C++ TSDF core cannot be "
                    "built, so the reference backend is unavailable")
    so = os.path.join(str(out_dir), "libtsdf_core.so")
    subprocess.run(["g++", "-O3", "-fPIC", "-shared",
                    os.path.join(ROOT, "csrc", "tsdf_core.cpp"), "-o", so],
                   check=True)
    lib = ctypes.CDLL(so)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.tsdf_integrate_block.argtypes = [
        f32p, f32p, f32p, f32p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, f32p, f32p, f32p,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float]
    lib.marching_tets_block.restype = ctypes.c_int
    lib.marching_tets_block.argtypes = [
        f32p, f32p, ctypes.c_int, f32p, ctypes.c_float,
        ctypes.c_float, f32p, ctypes.c_int]
    return lib


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    return build_core(tmp_path_factory.mktemp("tsdf_core"))


@pytest.fixture
def native(core, monkeypatch):
    monkeypatch.setattr(JT, "_NATIVE", core)
    return core


def scene_frames(n=3, seed=0):
    """n frames of the procedural scene along the synthetic arc: f32 depth
    with sky holes (0), colour in [0, 1], f32 c2w."""
    scene = SynthScene(seed=seed)
    out = []
    for c2w in camera_arc(8, seed=seed)[::3][:n]:
        rgb, depth = scene.render(c2w, K4, H, W)
        out.append((depth, rgb.astype(np.float32) / 255.0,
                    c2w.astype(np.float32)))
    return out


def fuse_both(frames, depth_trunc=8.0):
    jv = JT.TSDFVolume(voxel_size=VOXEL, trunc=4 * VOXEL)
    tv = TT.TSDFVolume(voxel_size=VOXEL, trunc=4 * VOXEL, device="cpu")
    for depth, color, c2w in frames:
        jv.integrate(depth, color, K4, c2w, depth_trunc)
        tv.integrate(depth, color, K4, c2w, depth_trunc)
    return jv, tv


def tri_set(verts):
    """Triangles as rows of 9 coordinates, each triangle's vertices in
    sorted order, rows sorted."""
    v = np.asarray(verts, np.float64)
    rank = np.empty(len(v), np.int64)
    rank[np.lexsort(v.T[::-1])] = np.arange(len(v))
    t = v.reshape(-1, 3, 3)
    order = np.argsort(rank.reshape(-1, 3), axis=1)
    t = np.take_along_axis(t, order[..., None], 1).reshape(-1, 9)
    return t[np.lexsort(t.T[::-1])]


@pytest.mark.parametrize("depth_trunc", [8.0, 5.5])
def test_integrate_matches_core(native, depth_trunc):
    """Block by block after three frames; at 5.5 m the per-voxel
    ``depth_trunc`` reject cuts through the far wall."""
    jv, tv = fuse_both(scene_frames(), depth_trunc)
    got = tv.block_arrays()
    assert set(got) == set(jv.blocks) and len(got) > 20
    n_obs = 0
    for key, (sdf, w) in jv.blocks.items():
        g_sdf, g_w, g_col = got[key]
        np.testing.assert_allclose(g_sdf, sdf, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g_w, w, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g_col, jv.colors[key], rtol=0, atol=1e-6)
        n_obs += int((w > 0).sum())
    assert n_obs > 5000


def test_mesh_matches_core(native):
    jv, tv = fuse_both(scene_frames())
    vj, fj, cj = jv.extract_mesh(min_weight=1.0)
    vt, ft, ct = tv.extract_mesh(min_weight=1.0)
    assert len(fj) == len(ft) > 1000
    np.testing.assert_allclose(tri_set(vt), tri_set(vj), rtol=0, atol=1e-5)
    # colours: the same multiset per vertex position
    oj, ot = np.lexsort(vj.T[::-1]), np.lexsort(vt.T[::-1])
    np.testing.assert_allclose(vt[ot], vj[oj], rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.sort(ct, 0), np.sort(cj, 0), rtol=0,
                               atol=1e-6)


def test_apron_edges_skipped(native):
    """Two blocks diagonal to each other: the apron edge between them
    stays at weight 0 in both, so neither meshes across it."""
    jv = JT.TSDFVolume(voxel_size=VOXEL, trunc=4 * VOXEL)
    tv = TT.TSDFVolume(voxel_size=VOXEL, trunc=4 * VOXEL, device="cpu")
    rng = np.random.default_rng(0)
    for key in ((0, 0, 0), (1, 1, 0), (0, 0, 1), (1, 0, 0)):
        sdf = rng.uniform(-1, 1, (16,) * 3).astype(np.float32)
        w = np.ones((16,) * 3, np.float32)
        col = rng.uniform(0, 1, (16,) * 3 + (3,)).astype(np.float32)
        jv.blocks[key] = np.stack([sdf, w])
        jv.colors[key] = col
        s = tv._allocate(torch.tensor([key]))
        tv.sdf[s], tv.weight[s], tv.color[s] = (torch.tensor(sdf)[None],
                                                torch.tensor(w)[None],
                                                torch.tensor(col)[None])
    vj, _, cj = jv.extract_mesh()
    vt, _, ct = tv.extract_mesh()
    assert len(vj) == len(vt)
    np.testing.assert_allclose(tri_set(vt), tri_set(vj), rtol=0, atol=1e-5)


def test_plane():
    """tests/test_eval_tsdf.py's plane on the port alone: a fronto-parallel
    plane at z = 1 meshes near z = 1 in its colour."""
    depth = np.full((32, 32), 1.0, np.float32)
    color = np.tile(np.array([1.0, 0, 0], np.float32), (32, 32, 1))
    vol = TT.integrate_keyframes([depth], [color], np.array(
        [40.0, 40.0, 16.0, 16.0]), [np.eye(4)], voxel_size=0.05,
        device="cpu")
    verts, faces, cols = vol.extract_mesh(min_weight=0.5)
    assert len(verts) > 10 and faces.shape == (len(verts) // 3, 3)
    assert abs(np.median(verts[:, 2]) - 1.0) < 0.1
    assert cols[:, 0].mean() > 0.5


def test_numpy_fallback_differs(monkeypatch):
    """The JAX module without the core (its numpy fallback) differs from
    the core, and so from the port, by design: it truncates the projected
    pixel (the core rounds, ``(int)(x + 0.5)``), bounds it by W - 1 / H - 1
    (the core by W / H) and keeps depths beyond ``depth_trunc`` (the core
    rejects them per voxel). Held divergence of the reference's two
    backends, pinned here."""
    monkeypatch.setattr(JT, "_NATIVE", None)
    frames = scene_frames()
    jv, tv = fuse_both(frames, depth_trunc=5.5)
    got = tv.block_arrays()
    assert set(got) == set(jv.blocks)
    diff = max(float(np.abs(got[k][0] - jv.blocks[k][0]).max())
               for k in got)
    assert diff > 0.1
