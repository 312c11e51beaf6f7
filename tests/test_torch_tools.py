"""The port's host tools against the repository's JAX-side ones, on the
same files: ``cut3r_slam_tpu_torch.pose_convert`` against
``pose_convert.py`` (tq -> matrix, matrix -> tq, ``--invert``, a round
trip; within 1e-6), and ``cut3r_slam_tpu_torch.generate_synth_scenes``
against ``scripts/generate_synth_scenes.py`` (the written tree at 1 scene x
3 views of 48x64: the same files, every PNG and .npy byte for byte, every
.npz array byte for byte; the .npz archives themselves carry their write
time)."""
import os
import pathlib
import runpy
import sys

import numpy as np
import pytest

import pose_convert as jax_pc
from cut3r_slam_tpu_torch import generate_synth_scenes, pose_convert
from test_torch_batched_mapping import few_threads  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _trajectory(n=5, seed=0):
    """Rows [t, tx, ty, tz, qx, qy, qz, qw] with unit quaternions (qw > 0)
    and the same poses as 4x4 c2w rows."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q *= np.sign(q[:, 3:])
    t = rng.uniform(-2, 2, (n, 3))
    rows = np.concatenate([np.arange(n)[:, None] * 0.5, t, q], 1)
    mats = np.tile(np.eye(4), (n, 1, 1))
    mats[:, :3, :3] = Rotation.from_quat(q).as_matrix()
    mats[:, :3, 3] = t
    return rows, mats.reshape(n, 16)


@pytest.mark.parametrize("from_fmt,to_fmt,invert", [
    ("tq", "matrix", False), ("matrix", "tq", False), ("tq", "tq", True),
    ("matrix", "matrix", True)])
def test_pose_convert_matches_jax(tmp_path, from_fmt, to_fmt, invert):
    rows, mats = _trajectory()
    src = tmp_path / "in.txt"
    np.savetxt(src, rows if from_fmt == "tq" else mats)
    outs = {}
    for name, tool in (("jax", jax_pc), ("port", pose_convert)):
        got = tool.load(str(src), from_fmt)
        tool.save(str(tmp_path / f"{name}.txt"), got, to_fmt, invert)
        outs[name] = np.loadtxt(tmp_path / f"{name}.txt")
    assert outs["port"].shape == outs["jax"].shape
    np.testing.assert_allclose(outs["port"], outs["jax"], atol=1e-6)


def test_pose_convert_round_trip_and_cli(tmp_path, capsys):
    """tq -> matrix -> tq through the CLI gives the trajectory back, and
    inverting twice is the identity."""
    rows, mats = _trajectory(seed=1)
    np.savetxt(tmp_path / "tq.txt", rows)
    pose_convert.main(["--input", str(tmp_path / "tq.txt"), "--output",
                       str(tmp_path / "m.txt"), "--to_fmt", "matrix"])
    np.testing.assert_allclose(np.loadtxt(tmp_path / "m.txt"), mats,
                               atol=1e-6)
    pose_convert.main(["--input", str(tmp_path / "m.txt"), "--output",
                       str(tmp_path / "back.txt"), "--from_fmt", "matrix"])
    back = np.loadtxt(tmp_path / "back.txt")
    np.testing.assert_allclose(back[:, 1:], rows[:, 1:], atol=1e-6)
    for src, dst in (("tq", "inv"), ("inv", "inv2")):
        pose_convert.main(["--input", str(tmp_path / f"{src}.txt"),
                           "--output", str(tmp_path / f"{dst}.txt"),
                           "--invert"])
    np.testing.assert_allclose(np.loadtxt(tmp_path / "inv2.txt"), rows,
                               atol=1e-6)
    assert "converted 5 poses" in capsys.readouterr().out


def test_one_pose_file(tmp_path):
    """A one-row tq file converts (the JAX tool fails on it)."""
    rows, mats = _trajectory(n=1, seed=2)
    np.savetxt(tmp_path / "tq.txt", rows)
    pose_convert.save(str(tmp_path / "m.txt"),
                      pose_convert.load(str(tmp_path / "tq.txt"), "tq"),
                      "matrix")
    np.testing.assert_allclose(np.loadtxt(tmp_path / "m.txt"), mats[0],
                               atol=1e-6)


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def test_synth_scene_cli_matches_jax(tmp_path, monkeypatch, capsys):
    flags = ["--n_scenes", "1", "--views", "3", "--height", "48",
             "--width", "64", "--seed", "3"]
    jroot, troot = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["generate_synth_scenes.py",
                                      "--output", str(jroot)] + flags)
    runpy.run_path(str(ROOT / "scripts" / "generate_synth_scenes.py"),
                   run_name="__main__")
    generate_synth_scenes.main(["--output", str(troot)] + flags)
    out = capsys.readouterr().out
    assert out.count("wrote 1 scenes under") == 2
    files = _tree(jroot)
    assert files == _tree(troot) and len(files) == 3 * 3 + 1
    for rel in files:
        a, b = jroot / rel, troot / rel
        if rel.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files), rel
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (rel, k)
                assert za[k].tobytes() == zb[k].tobytes(), (rel, k)
        else:
            assert a.read_bytes() == b.read_bytes(), rel
    assert os.path.isdir(troot / "scene_003_0000" / "rgb")
