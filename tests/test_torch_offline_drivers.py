"""The port's offline evaluation drivers against the repository's on the
CPU:

* ``cut3r_slam_tpu_torch.demo_test`` against ``demo_test.py``: both
  drivers' ``main`` with ``MappingBackend`` replaced by a recorder, on a
  6-frame ``synth_replica`` sequence 64 px wide; the recorded call
  sequences (keyframe images, depths and w2c, seeded pointmaps, windows,
  iteration counts) agree within 1e-6. The recorder keeps the mapping
  itself (held against the JAX package by tests/test_torch_mapping.py)
  out of this file.
* ``gaussians.npz``: a checkpoint written by either package loads in the
  other, every array equal.
* ``cut3r_slam_tpu_torch.tsdf_integrate`` against ``tsdf_integrate.py``
  (run through ``runpy`` with the repository's C++ TSDF core built into
  the test's temporary directory) on a fabricated run directory: the same
  triangles within 1e-5; ``scripts/eval_recon.py`` reads the port's
  ``mesh.ply``.
* ``run_eval``'s per-dataset table and ATE against the five JAX drivers
  (the chain end to end is tests/test_torch_run_eval.py).
"""
import json
import os
import runpy
import sys
import types

import numpy as np
import pytest
import torch

from cut3r_slam_tpu.utils import tsdf as JT
from cut3r_slam_tpu_torch import demo_test as port_demo_test
from cut3r_slam_tpu_torch import tsdf_integrate as port_tsdf
from cut3r_slam_tpu_torch.datasets.synth_replica import (
    REPLICA_K4, camera_arc, write_replica_sequence)
from cut3r_slam_tpu_torch.datasets.synthscene import SynthScene
from cut3r_slam_tpu_torch.geometry.pointmap import matrix_to_pose_vec
from test_torch_batched_mapping import few_threads  # noqa: F401 (autouse)
from test_torch_tsdf import build_core, tri_set

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (36, 64)
K4_64 = (REPLICA_K4 * np.float32(64 / 1200)).astype(np.float32)


# ---------------------------------------------------------------------------
# demo_test: the driver's calls into the mapper
# ---------------------------------------------------------------------------

def recorder(log):
    class Recorder:
        """Stands in for MappingBackend: records every call."""

        def __init__(self, cfg, K4, **kw):
            self.cfg = cfg
            self.current_window, self.initialized = [], False
            self.cams = types.SimpleNamespace(w2c={})
            log.append(("init", cfg.height, cfg.width, cfg.capacity,
                        cfg.cam_capacity, np.asarray(K4, np.float32)))

        def add_keyframe(self, idx, img, depth, w2c):
            self.cams.w2c[idx] = torch.tensor(np.asarray(w2c, np.float32))
            log.append(("add_keyframe", idx, np.asarray(img),
                        np.asarray(depth), np.asarray(w2c)))

        def seed(self, idx, pointmap, colors, mask, submap):
            log.append(("seed", idx, np.asarray(pointmap),
                        np.asarray(colors), np.asarray(mask), submap))

        def optimization(self, iters, window):
            log.append(("optimization", iters, list(window)))

        def pose_refine(self, idx):
            log.append(("pose_refine", idx, list(self.current_window)))
            h, w = self.cfg.height // 2, self.cfg.width // 2
            pm = np.random.default_rng(idx).normal(size=(h, w, 3))
            return pm.astype(np.float32), (pm[..., 2] > 0).astype(np.float32)

        def global_ba(self, iters, densify=True):
            log.append(("global_ba", iters, densify))

        def eval_view(self, k):
            return 20.0 + k
    return Recorder


def same_calls(got, want):
    assert [c[0] for c in got] == [c[0] for c in want]
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g[1:], w[1:]):
            if isinstance(b, np.ndarray):
                assert a.shape == b.shape and a.dtype == b.dtype, g[0]
                np.testing.assert_allclose(
                    a.astype(np.float64), b.astype(np.float64), rtol=0,
                    atol=1e-6 * max(1.0, float(np.abs(b).max())),
                    err_msg=g[0])
            else:
                assert a == b, (g[0], a, b)


@pytest.fixture(scope="module")
def short_seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth6"))
    return write_replica_sequence(root, n_frames=6, hw=HW, K4=K4_64)


def test_demo_test_drives_the_mapper_as_jax(short_seq, tmp_path, monkeypatch):
    import cut3r_slam_tpu.slam.mapping as JM
    import cut3r_slam_tpu_torch.slam.mapping as TM
    argv = ["--dataset", "replica", "--folder", short_seq, "--length", "6",
            "--kf_every", "2", "--target_width", "64", "--cpu",
            "--calib", str(tmp_path / "calib.txt")]
    (tmp_path / "calib.txt").write_text(" ".join(map(str, K4_64)) + "\n")
    logs = {}
    for name in ("jax", "port"):
        logs[name] = []
        out = str(tmp_path / name)
        if name == "jax":
            monkeypatch.setattr(JM, "MappingBackend", recorder(logs[name]))
            monkeypatch.setattr(sys, "argv", ["demo_test.py"] + argv
                                + ["--output", out])
            runpy.run_path(os.path.join(ROOT, "demo_test.py"))["main"]()
        else:
            monkeypatch.setattr(TM, "MappingBackend", recorder(logs[name]))
            port_demo_test.main(argv + ["--output", out])
        with open(os.path.join(out, "result.json")) as f:
            logs[name + "_result"] = json.load(f)
    same_calls(logs["port"], logs["jax"])
    kinds = [c[0] for c in logs["port"]]
    assert kinds.count("add_keyframe") == 3 and kinds.count("pose_refine") == 2
    assert kinds[-1] == "global_ba"
    rj, rt = logs["jax_result"], logs["port_result"]
    assert set(rt) == set(rj) and rt["keyframes"] == rj["keyframes"] == 3
    assert rt["frames"] == rj["frames"] == 6 and rt["psnr_kf"] == rj["psnr_kf"]
    assert abs(rt["ate_rmse_m"] - rj["ate_rmse_m"]) <= 1e-4


def test_perturb_pose_matches_jax():
    jp = runpy.run_path(os.path.join(ROOT, "demo_test.py"))["perturb_pose"]
    c2w = camera_arc(3)[1]
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(4):
        np.testing.assert_allclose(port_demo_test.perturb_pose(rt, c2w),
                                   jp(rj, c2w), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# gaussians.npz across the packages
# ---------------------------------------------------------------------------

def test_gaussians_npz_round_trip(tmp_path):
    from cut3r_slam_tpu.slam.mapping import (MappingBackend as JMB,
                                             MappingConfig as JMC)
    from cut3r_slam_tpu_torch.slam.mapping import (MappingBackend as TMB,
                                                   MappingConfig as TMC)
    H, W, cap = 16, 24, 256
    rng = np.random.default_rng(0)
    K4 = np.array([20.0, 20.0, 12.0, 8.0], np.float32)
    tm = TMB(TMC(height=H, width=W, capacity=cap, cam_capacity=4), K4,
             device="cpu")
    depth = rng.uniform(1, 2, (H, W)).astype(np.float32)
    tm.add_keyframe(1, rng.integers(0, 255, (H, W, 3), dtype=np.uint8),
                    depth, np.eye(4, dtype=np.float32))
    pm = np.stack(np.meshgrid(np.linspace(-1, 1, W // 2),
                              np.linspace(-1, 1, H // 2)) + (depth[::2, ::2],),
                  -1)
    tm.seed(1, pm, rng.uniform(0, 1, pm.shape), np.ones(pm.shape[:2], bool),
            0)
    for k in tm.adam.m:
        tm.adam.m[k] = torch.tensor(rng.normal(size=tm.adam.m[k].shape),
                                    dtype=torch.float32)
    tm.adam.t, tm.current_window, tm.initialized = 7, [1], True
    tm.save(str(tmp_path / "port.npz"))

    jm = JMB(JMC(height=H, width=W, capacity=cap, cam_capacity=4), K4)
    jm.load(str(tmp_path / "port.npz"))
    assert jm.current_window == [1] and jm.initialized
    assert int(jm.adam[2]) == 7 and int(jm.arena.alive.sum()) > 0
    jm.save(str(tmp_path / "jax.npz"))
    back = TMB(TMC(height=H, width=W, capacity=cap, cam_capacity=4), K4,
               device="cpu")
    back.load(str(tmp_path / "jax.npz"))
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert set(a.files) == set(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k].astype(a[k].dtype),
                                      err_msg=k)
    back.save(str(tmp_path / "again.npz"))
    c = np.load(tmp_path / "again.npz")
    for k in a.files:
        assert a[k].dtype == c[k].dtype, k
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)


# ---------------------------------------------------------------------------
# tsdf_integrate
# ---------------------------------------------------------------------------

def fabricated_rundir(root, n=3, hw=(48, 64)):
    """A finished run's files: traj_kf.txt, intrinsics.npy and the
    renders_kf depth / colour PNGs of the procedural scene."""
    import cv2
    H, W = hw
    K4 = np.array([40.0, 40.0, 31.5, 23.5], np.float32)
    scene = SynthScene(seed=1)
    os.makedirs(os.path.join(root, "renders_kf"))
    rows = []
    for i, c2w in enumerate(camera_arc(3 * n, seed=1)[::3]):
        rgb, depth = scene.render(c2w, K4, H, W)
        cv2.imwrite(os.path.join(root, "renders_kf", f"color_{i:05d}.png"),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(root, "renders_kf", f"depth_{i:05d}.png"),
                    np.clip(depth * 6553.5, 0, 65535).astype(np.uint16))
        rows.append([2 * i] + matrix_to_pose_vec(torch.tensor(c2w)).tolist())
    np.savetxt(os.path.join(root, "traj_kf.txt"), np.asarray(rows))
    np.save(os.path.join(root, "intrinsics.npy"), np.tile(K4, (n, 1)))
    return root


def test_tsdf_integrate_matches_jax_script(tmp_path, monkeypatch):
    monkeypatch.setattr(JT, "_NATIVE", build_core(tmp_path))
    run = fabricated_rundir(str(tmp_path / "run"))
    vols = {}
    orig = JT.TSDFVolume.save_ply

    def keep(self, path, *a, **k):
        vols["jax"] = self
        return orig(self, path, *a, **k)
    monkeypatch.setattr(JT.TSDFVolume, "save_ply", keep)
    monkeypatch.setattr(sys, "argv", [
        "tsdf_integrate.py", "--rundir", run, "--voxel", "0.05",
        "--out", str(tmp_path / "jax.ply")])
    runpy.run_path(os.path.join(ROOT, "tsdf_integrate.py"),
                   run_name="__main__")
    vols["port"] = port_tsdf.main(["--rundir", run, "--voxel", "0.05",
                                   "--cpu"])
    vj, _, _ = vols["jax"].extract_mesh()
    vt, _, _ = vols["port"].extract_mesh()
    assert len(vt) == len(vj) > 2000
    np.testing.assert_allclose(tri_set(vt), tri_set(vj), rtol=0, atol=1e-5)
    # the same ASCII ply writer: the same header, the same vertex lines
    with open(os.path.join(run, "mesh.ply")) as f:
        lt = f.read().splitlines()
    with open(tmp_path / "jax.ply") as f:
        lj = f.read().splitlines()
    n = len(vt)
    assert lt[:12] == lj[:12] and len(lt) == len(lj) == 12 + n + n // 3
    assert sorted(lt[12:12 + n]) == sorted(lj[12:12 + n])
    # scripts/eval_recon.py reads the port's mesh.ply unchanged
    load = runpy.run_path(os.path.join(ROOT, "scripts", "eval_recon.py"))[
        "load_ply_vertices"]
    got = load(os.path.join(run, "mesh.ply"))
    assert got.shape == vt.shape
    np.testing.assert_allclose(np.sort(got, 0), np.sort(vt, 0), rtol=0,
                               atol=6e-5)


# ---------------------------------------------------------------------------
# run_eval's dataset table against the five JAX drivers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["replica", "scannet", "tum", "7scenes",
                                  "scannetpp"])
def test_run_eval_table_matches_jax_drivers(name):
    """Sequences, image folder, calib / config names, ground-truth format
    and the mesh step, read from scripts/run_<name>.py."""
    import re
    from cut3r_slam_tpu_torch.run_eval import DATASETS
    path = os.path.join(ROOT, "scripts", f"run_{name}.py")
    src = open(path).read()
    ds = DATASETS[name]
    assert list(ds.sequences) == runpy.run_path(path)["SEQUENCES"]
    assert re.search(r'os\.path\.join\(args\.datadir, seq, "([^"]+)"\)',
                     src).group(1) == ds.images
    assert f'"calib/{ds.name}.txt"' in src
    assert f'"config/{ds.name}_config.yaml"' in src
    assert ('"groundtruth.txt"' in src) == (ds.gt == "tum")
    assert ('tsdf_integrate.py' in src) == ds.mesh


@pytest.mark.parametrize("name", ["replica", "tum"])
def test_run_eval_ate_matches_jax_driver(name, tmp_path, monkeypatch):
    """A finished run (its trajectory and mesh present, so neither driver
    starts a process): the same summary.json ATE from both (within 1e-6
    relative: the JAX package's alignment computes partly in f32), for the
    4x4 traj.txt and the TUM groundtruth.txt formats."""
    from cut3r_slam_tpu_torch import run_eval
    rng = np.random.default_rng(3)
    data, seq = tmp_path / "data", "s0"
    os.makedirs(data / seq)
    c2w = camera_arc(20, seed=2).astype(np.float64)
    c2w[:, :3, 3] += rng.normal(0, 0.01, (20, 3))
    if name == "tum":
        with open(data / seq / "groundtruth.txt", "w") as f:
            f.write("# timestamp tx ty tz qx qy qz qw\n")
            for i, m in enumerate(c2w):
                q = matrix_to_pose_vec(torch.tensor(m)).numpy()[3:]
                f.write(" ".join(f"{v:.6f}" for v in
                                 [1.0 + 0.1 * i, *m[:3, 3], *q]) + "\n")
    else:
        np.savetxt(data / seq / "traj.txt", c2w.reshape(20, 16))
    rows = [[t] + list(2.0 * c2w[t, :3, 3] + 0.5 + rng.normal(0, 0.02, 3))
            + [0, 0, 0, 1] for t in (0, 2, 5, 9, 14, 19)]
    outs = {}
    for pkg in ("jax", "port"):
        out = tmp_path / pkg
        os.makedirs(out / seq)
        np.savetxt(out / seq / "traj_kf.txt", np.asarray(rows))
        (out / seq / "mesh.ply").write_text("ply\n")
        argv = ["--datadir", str(data), "--output", str(out),
                "--sequences", seq]
        if pkg == "jax":
            monkeypatch.setattr(sys, "argv", ["run.py"] + argv)
            runpy.run_path(os.path.join(ROOT, "scripts", f"run_{name}.py"),
                           run_name="__main__")
        else:
            run_eval.main(["--dataset", name] + argv)
        with open(out / "summary.json") as f:
            outs[pkg] = json.load(f)[seq]
    assert np.isfinite(outs["port"]["ate_rmse_m"])
    np.testing.assert_allclose(outs["port"]["ate_rmse_m"],
                               outs["jax"]["ate_rmse_m"], rtol=1e-6)
    assert ("mesh_ply" in outs["port"]) == ("mesh_ply" in outs["jax"])
