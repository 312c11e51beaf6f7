"""RGB-D loaders and the Replica-layout writer of the port against
``cut3r_slam_tpu/datasets/{rgbd,synth_replica}.py`` on the CPU: a
``synth_replica`` sequence (byte-identical files at the same seed), and
fabricated TUM and ScanNet folders; every item equal (images bitwise,
depth to 0, poses to 1e-6, K4 equal)."""
import os

import numpy as np
import pytest

from cut3r_slam_tpu.datasets import rgbd as JR
from cut3r_slam_tpu.datasets import synth_replica as JS
from cut3r_slam_tpu_torch.datasets import rgbd as TR
from cut3r_slam_tpu_torch.datasets import synth_replica as TS

from test_torch_cut3r_train import few_threads  # noqa: F401

HW = (36, 64)
K4 = (JS.REPLICA_K4 * np.float32(64 / 1200)).astype(np.float32)


def same_items(got, want):
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert set(a) == set(b), (i, set(a), set(b))
        assert a["t"] == b["t"] == i
        assert a["image"].dtype == b["image"].dtype == np.uint8
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["K4"], b["K4"])
        assert a["K4"].dtype == b["K4"].dtype
        if "depth" in b:
            assert a["depth"].dtype == b["depth"].dtype
            np.testing.assert_array_equal(a["depth"], b["depth"])
        if "pose" in b:
            np.testing.assert_allclose(a["pose"], b["pose"], rtol=0,
                                       atol=1e-6)


def test_camera_arc_and_constants():
    np.testing.assert_array_equal(TS.camera_arc(7, seed=3),
                                  JS.camera_arc(7, seed=3))
    np.testing.assert_array_equal(TS.REPLICA_K4, JS.REPLICA_K4)
    assert TS.REPLICA_HW == JS.REPLICA_HW


def test_synth_replica_files_and_items(tmp_path):
    dj = JS.write_replica_sequence(str(tmp_path / "jax"), n_frames=5, hw=HW,
                                   K4=K4, seed=2)
    dt = TS.write_replica_sequence(str(tmp_path / "port"), n_frames=5,
                                   hw=HW, K4=K4, seed=2)
    files = sorted(os.path.relpath(os.path.join(r, f), dj)
                   for r, _, fs in os.walk(dj) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), dt)
                           for r, _, fs in os.walk(dt) for f in fs)
    assert len(files) == 11
    for f in files:
        with open(os.path.join(dj, f), "rb") as a, \
                open(os.path.join(dt, f), "rb") as b:
            assert a.read() == b.read(), f
    for calib in (None, [50.0, 51.0, 31.5, 17.5]):
        same_items(TR.get_dataset("replica", dt, calib),
                   JR.get_dataset("replica", dj, calib))
    item = TR.get_dataset("replica", dt)[0]
    assert item["depth"].max() > 1.0 and item["pose"].shape == (7,)


def _write_rgb(path, rng, hw=(12, 16)):
    import cv2
    cv2.imwrite(path, rng.integers(0, 255, hw + (3,), dtype=np.uint8))


def _write_depth(path, rng, hw=(12, 16)):
    import cv2
    cv2.imwrite(path, rng.integers(0, 40000, hw, dtype=np.uint16))


def _rot(rng):
    from scipy.spatial.transform import Rotation
    m = np.eye(4)
    m[:3, :3] = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
    m[:3, 3] = rng.normal(size=3)
    return m


@pytest.fixture
def scannet(tmp_path):
    """Frames named 0..11, so a lexical sort would order them wrongly."""
    rng = np.random.default_rng(0)
    root = tmp_path / "scene0000_00"
    for sub in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(root / sub)
    for i in range(12):
        _write_rgb(str(root / "color" / f"{i}.jpg"), rng)
        _write_depth(str(root / "depth" / f"{i}.png"), rng)
        np.savetxt(root / "pose" / f"{i}.txt", _rot(rng))
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 580.5, 579.25, 319.75, 240.125
    np.savetxt(root / "intrinsic" / "intrinsic_color.txt", K)
    return str(root)


@pytest.mark.parametrize("calib", [None, [500.0, 501.0, 320.0, 240.0]])
def test_scannet_matches_jax(scannet, calib):
    same_items(TR.get_dataset("scannet", scannet, calib),
               JR.get_dataset("scannet", scannet, calib))
    ds = TR.get_dataset("scannet", scannet)
    assert [os.path.basename(p) for p in ds.color_paths][:3] == \
        ["0.jpg", "1.jpg", "2.jpg"]
    assert ds.K4.tolist() == [580.5, 579.25, 319.75, 240.125]
    assert ds.depth_scale == 1000.0


def _tum(root, rng, depth_ts, with_gt=True):
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    rgb_ts = [1.0 + 0.033 * i for i in range(8)]
    with open(root / "rgb.txt", "w") as f:
        f.write("# color images\n# timestamp filename\n")
        for t in rgb_ts:
            _write_rgb(str(root / "rgb" / f"{t:.6f}.png"), rng)
            f.write(f"{t:.6f} rgb/{t:.6f}.png\n")
    with open(root / "depth.txt", "w") as f:
        f.write("# depth maps\n")
        for t in depth_ts:
            _write_depth(str(root / "depth" / f"{t:.6f}.png"), rng)
            f.write(f"{t:.6f} depth/{t:.6f}.png\n")
    if with_gt:
        with open(root / "groundtruth.txt", "w") as f:
            f.write("# timestamp tx ty tz qx qy qz qw\n")
            for k in range(30):
                q = rng.normal(size=4)
                q /= np.linalg.norm(q)
                row = [0.99 + 0.011 * k] + list(rng.normal(size=3)) + list(q)
                f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    return str(root)


@pytest.mark.parametrize("case", ["associated", "partly", "no_depth"])
def test_tum_matches_jax(tmp_path, case):
    """Nearest-timestamp association within 0.08 s: every frame paired;
    some frames beyond the window (their depth path None); no depth
    within the window at all (the sequence drops its depth)."""
    rng = np.random.default_rng(1)
    depth_ts = {"associated": [1.0 + 0.033 * i + 0.004 for i in range(8)],
                "partly": [1.0, 1.05, 1.4],
                "no_depth": [5.0, 6.0]}[case]
    root = _tum(tmp_path / "tum", rng, depth_ts)
    got, want = TR.get_dataset("tum", root), JR.get_dataset("tum", root)
    assert got.depth_paths == want.depth_paths
    if case == "no_depth":
        assert got.depth_paths == []
        same_items(got, want)
    elif case == "partly":
        assert None in got.depth_paths and any(got.depth_paths)
        assert got.poses.shape == (8, 7)
    else:
        same_items(got, want)
    np.testing.assert_array_equal(got.poses, want.poses)
    assert got.K4.tolist() == want.K4.tolist()


def test_unknown_dataset_raises():
    with pytest.raises(ValueError):
        TR.get_dataset("kitti", ".")
