"""The port's live viewer (``gui/server.py``) against the JAX package's
``ViewerServer`` on the CPU, and its wiring into ``SLAMSystem``
(``GUI.active``) and the demo driver (``--gui --gui_port``).

Both servers serve the same fake state (the same numpy arrays, as jax
arrays on one side and torch tensors on the other): every route must
answer with the same status code, the same JSON, the same splat bytes and
the same keyframe PNG. ``/api/render`` renders a seeded 32x48 map through
each package's renderer (JAX's XLA path, the port's plain path here):
the decoded images within one 8-bit level (equal here).

The port's arena is updated in place, so the server reads and renders
under ``SLAMSystem.state_lock``: a client thread hammers ``/api/render``,
``/api/splats`` and ``/api/state`` while ``SLAMSystem.run`` maps; every
response must be complete and finite, and no render may run inside a
mapping slice.
"""
import json
import struct
import threading
import urllib.error
import urllib.request

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cut3r_slam_tpu.gui.server import ViewerServer as JViewer, \
    pack_splats as jpack
from cut3r_slam_tpu.ops.gs_raster import RasterizeConfig as JRasterCfg
from cut3r_slam_tpu_torch.gui import ViewerServer, pack_splats
from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
from cut3r_slam_tpu_torch.slam.mapping import MappingBackend, MappingConfig
from cut3r_slam_tpu_torch.slam.system import SLAMSystem

from test_torch_cut3r_train import few_threads  # noqa: F401
from test_torch_slam_slice import CFG, H, K4, W, _frames

CAP, N_ALIVE = 24, 13
RH, RW = 32, 48
EYE = ",".join(str(float(v)) for v in np.eye(4).ravel())


def _arena_arrays(seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    xyz = np.concatenate([rng.uniform(-0.6, 0.6, (CAP, 2)),
                          rng.uniform(1.5, 3.0, (CAP, 1))], 1).astype(f)
    quat = rng.normal(size=(CAP, 4)).astype(f)
    return dict(alive=np.arange(CAP) < N_ALIVE, xyz=xyz,
                f_dc=rng.normal(size=(CAP, 3)).astype(f),
                opacity_logit=rng.normal(size=CAP).astype(f),
                log_scales=rng.uniform(-3.0, -1.5, (CAP, 3)).astype(f),
                quat=quat / np.linalg.norm(quat, axis=1, keepdims=True))


class _Arena:
    def __init__(self, arrays, conv):
        for k, v in arrays.items():
            setattr(self, k, conv(v))

    def params(self):
        return {k: getattr(self, k) for k in
                ("xyz", "f_dc", "opacity_logit", "log_scales", "quat")}


class _KF:
    def __init__(self, n=3, hw=(8, 12)):
        self.count = n
        self.tstamp = np.arange(64, dtype=np.int64) * 2
        self.pose = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32),
                            (64, 1))
        self.pose[:n, 0] = np.arange(n) * 0.5 + 0.1234567
        self.image = np.zeros((64,) + hw + (3,), np.uint8)
        self.image[:n] = np.random.default_rng(1).integers(
            0, 256, (n,) + hw + (3,), dtype=np.uint8)


class _Backend:
    closed_loop = {"idx_current": [2, 5], "idx_matched": [0, 1],
                   "lc_fl": []}


class _Mapper:
    pass


class _SLAM:
    def __init__(self, mapper):
        self.state_lock = threading.RLock()
        self.keyframes = _KF()
        self.backend = _Backend()
        self.mapper = mapper
        self.img_hw = (8, 12)
        self.last_t = 4


def _mapper(arena, render=None):
    m = _Mapper()
    m.arena = arena
    if render is not None:
        m.K4, m.raster_cfg = render
    return m


@pytest.fixture(scope="module")
def servers():
    """(port server, JAX server) over the same fake state without a
    renderable mapper, and the same pair with one: the port's
    ``MappingBackend`` holding the arrays, a fake with its camera and
    raster configuration on the JAX side."""
    arr = _arena_arrays()
    k4 = np.asarray([40.0, 40.0, RW / 2, RH / 2], np.float32)
    mb = MappingBackend(MappingConfig(height=RH, width=RW, capacity=CAP,
                                      cam_capacity=1), k4, device="cpu")
    for k, v in arr.items():
        getattr(mb.arena, k).copy_(torch.tensor(v))
    rc = mb.raster_cfg
    jr = (jnp.asarray(k4), JRasterCfg(height=RH, width=RW,
                                      max_per_tile=rc.max_per_tile,
                                      kernel_size=rc.kernel_size))
    made = [ViewerServer(_SLAM(_mapper(_Arena(arr, torch.tensor))), port=0),
            JViewer(_SLAM(_mapper(_Arena(arr, jnp.asarray))), port=0),
            ViewerServer(_SLAM(mb), port=0),
            JViewer(_SLAM(_mapper(_Arena(arr, jnp.asarray), jr)), port=0)]
    yield made
    for s in made:
        s.stop()


def _get(server, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}{path}", timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _decode(png):
    import cv2
    img = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_COLOR)
    return img[..., ::-1]


@pytest.mark.parametrize("path", [
    "/api/state", "/api/splats", "/api/kf_image?i=1", "/api/kf_image?i=99",
    "/api/kf_image?i=-1", "/nope", f"/api/render?w2c={EYE}",
    "/api/render?w2c=1,2,3", "/api/render"])
def test_routes_match_jax(servers, path):
    """Status, content type and body of each route as the JAX server's
    (no renderable mapper: ``/api/render`` is a 404 on both)."""
    got, want = _get(servers[0], path), _get(servers[1], path)
    assert got[:2] == want[:2], (path, got[:2], want[:2])
    if path == "/api/state":
        st = json.loads(got[2])
        assert st == json.loads(want[2])
        assert st["n_kf"] == 3 and st["n_alive"] == N_ALIVE
        assert st["loop_edges"] == [[0, 2], [1, 5]]
    else:
        assert got[2] == want[2], path
    if path.startswith("/api/kf_image?i=1"):
        assert got[2][:8] == b"\x89PNG\r\n\x1a\n"


def test_index_page(servers):
    status, ctype, body = _get(servers[0], "/")
    assert status == 200 and "text/html" in ctype
    assert b"webgl2" in body.lower() and b"cut3r_slam_tpu_torch" in body
    assert _get(servers[0], "/index.html")[2] == body


@pytest.mark.parametrize("cap", [400_000, 5])
def test_pack_splats_matches_jax(cap):
    """The 20-byte record (3 f32 xyz, 3 u8 rgb, u8 opacity, f32 scale),
    byte-equal to the JAX package's, capped at ``max_splats``."""
    arr = _arena_arrays(2)
    got = pack_splats(_Arena(arr, torch.tensor), cap)
    assert got == jpack(_Arena(arr, jnp.asarray), cap)
    (n,) = struct.unpack_from("<I", got, 0)
    assert n == min(cap, N_ALIVE) and len(got) == 4 + 20 * n


def test_render_matches_jax(servers):
    """``/api/render`` of a seeded map on both packages' renderers: the
    same PNG size, every value within one 8-bit level; the guards
    (malformed pose) stay 404."""
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.05, -0.02, 0.1]
    q = ",".join(repr(float(v)) for v in w2c.ravel())
    got = _get(servers[2], f"/api/render?w2c={q}")
    want = _get(servers[3], f"/api/render?w2c={q}")
    assert got[0] == want[0] == 200 and got[1] == want[1] == "image/png"
    a, b = _decode(got[2]).astype(int), _decode(want[2]).astype(int)
    assert a.shape == b.shape == (RH, RW, 3)
    assert a.max() > 0, "empty render"
    assert np.abs(a - b).max() <= 1, np.abs(a - b).max()
    assert _get(servers[2], "/api/render?w2c=1,2,3")[0] == 404


def _system(tmp_path, port=0, kf_every=2):
    model = CUT3R(CUT3RConfig.tiny(), device="cpu")
    model.init_random(torch.Generator().manual_seed(0))
    cfg = json.loads(json.dumps(CFG))
    cfg["Tracking"]["motion_filter"]["kf_every"] = kf_every
    cfg["GUI"] = {"active": True, "port": port, "max_splats": 10_000}
    return SLAMSystem(model, cfg, buffer=16, img_hw=(H, W),
                      output_dir=str(tmp_path), device="cpu")


def test_gui_active_serves_the_viewer(tmp_path):
    """``GUI.active`` builds ``slam.viewer`` on the configured port
    (0: a free one) with ``max_splats``; before any frame the state is
    empty and the render route has no map."""
    slam = _system(tmp_path)
    try:
        assert isinstance(slam.viewer, ViewerServer)
        assert slam.viewer.max_splats == 10_000 and slam.viewer.port > 0
        status, _, body = _get(slam.viewer, "/api/state")
        st = json.loads(body)
        assert status == 200 and st["n_kf"] == 0 and st["frame"] == -1
        assert st["img_hw"] == [H, W]
        assert _get(slam.viewer, f"/api/render?w2c={EYE}")[0] == 404
        assert _get(slam.viewer, "/api/splats")[2] == struct.pack("<I", 0)
    finally:
        slam.viewer.stop()


def test_concurrent_reads_while_mapping(tmp_path, monkeypatch):
    """A client thread requests /api/render, /api/splats and /api/state
    while ``run()`` maps, and again after: every response is complete (200
    once a mapper exists, splat bytes of 4 + 20 n, a decodable render),
    finite, and no render ran inside a mapping slice."""
    import cut3r_slam_tpu_torch.slam.renderer as R
    import cut3r_slam_tpu_torch.slam.system as S
    slam = _system(tmp_path, kf_every=1)    # a mapping event by frame 6
    in_slice = threading.Event()

    def flagged(gen):            # set while a slice runs, inside the lock
        while True:
            with slam.state_lock:
                in_slice.set()
                try:
                    v = next(gen)
                except StopIteration as e:
                    return e.value
                finally:
                    in_slice.clear()
            yield v

    inner = S._locked_slices

    def locked_slices(gen, lock):
        assert lock is slam.state_lock
        return inner(flagged(gen), lock)
    monkeypatch.setattr(S, "_locked_slices", locked_slices)
    overlaps = []
    inner_render = R.render_view

    def render_checked(*a, **k):
        if threading.current_thread() is not threading.main_thread():
            overlaps.append(in_slice.is_set())
        return inner_render(*a, **k)
    monkeypatch.setattr(R, "render_view", render_checked)

    stop = threading.Event()
    seen = {"render": 0, "splats": 0, "state": 0}
    errors = []
    K = np.asarray(K4)
    w2c = ",".join(str(float(v)) for v in np.eye(4).ravel())

    def check_all():
        st = json.loads(_get(slam.viewer, "/api/state")[2])
        assert np.isfinite(np.asarray(st["poses"], float)).all()
        seen["state"] += 1
        status, _, body = _get(slam.viewer, "/api/splats")
        (n,) = struct.unpack_from("<I", body, 0)
        assert status == 200 and len(body) == 4 + 20 * n, (status, n)
        rec = np.frombuffer(body, offset=4, dtype=[
            ("xyz", "<f4", 3), ("rgb", "u1", 3), ("opa", "u1"),
            ("scale", "<f4")])
        assert np.isfinite(rec["xyz"]).all() and np.isfinite(
            rec["scale"]).all()
        seen["splats"] += n > 0
        status, ctype, body = _get(slam.viewer, f"/api/render?w2c={w2c}")
        if slam.mapper is None:
            assert status == 404
        else:
            assert status == 200 and ctype == "image/png", (status, body)
            assert _decode(body).shape == (slam.map_hw[0], slam.map_hw[1],
                                           3)
            seen["render"] += 1

    started = threading.Event()

    def client():
        while not stop.is_set():
            started.set()
            try:
                check_all()
            except Exception as e:       # reported by the main thread
                errors.append(e)
                return

    th = threading.Thread(target=client)
    try:
        frames = _frames()[:10]
        th.start()
        for t, f in enumerate(frames):
            # each frame starts only once the client has begun a round of
            # requests, so every frame's run() overlaps one
            assert started.wait(120)
            started.clear()
            slam.run(t, f, K, last=(t == len(frames) - 1))
        stop.set()
        th.join(timeout=120)
        assert not errors, errors[0]
        during = dict(seen)
        check_all()                      # and again after run()
        assert slam.mapper is not None and during["render"] >= 2, during
        assert during["splats"] >= 1 and during["state"] >= len(frames), \
            during
        assert overlaps and not any(overlaps), overlaps
        st = json.loads(_get(slam.viewer, "/api/state")[2])
        assert st["n_kf"] == slam.keyframes.count
        assert st["n_alive"] == int(slam.mapper.arena.alive.sum())
        (n,) = struct.unpack_from("<I", _get(slam.viewer, "/api/splats")[2],
                                  0)
        assert n == st["n_alive"] > 0
    finally:
        stop.set()
        slam.viewer.stop()


def test_demo_gui_flag(tmp_path, capsys):
    """``demo --gui --gui_port 0`` with the tiny model serves the viewer
    and prints its URL; the viewer reads the finished run."""
    import cv2
    from cut3r_slam_tpu_torch import demo
    img_dir = tmp_path / "frames"
    img_dir.mkdir()
    for i, f in enumerate(_frames()[:4]):
        cv2.imwrite(str(img_dir / f"frame{i:06d}.png"), f[..., ::-1])
    calib = tmp_path / "calib.txt"
    calib.write_text(" ".join(str(float(v)) for v in K4) + "\n")
    slam, result = demo.main([
        "--imagedir", str(img_dir), "--calib", str(calib), "--cpu",
        "--tiny-model", "--target_width", str(W), "--no-mapping",
        "--no-loop", "--output", str(tmp_path / "out"), "--gui",
        "--gui_port", "0", "--ckpt", str(tmp_path / "none.pth")])
    try:
        assert slam.viewer is not None
        out = capsys.readouterr().out
        assert f"live viewer at http://127.0.0.1:{slam.viewer.port}/" in out
        st = json.loads(_get(slam.viewer, "/api/state")[2])
        assert st["n_kf"] == result["keyframes"] == slam.keyframes.count
        assert st["frame"] == 3
    finally:
        slam.viewer.stop()
