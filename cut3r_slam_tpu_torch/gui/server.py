"""HTTP state server for the live SLAM viewer (port of
``cut3r_slam_tpu/gui/server.py``: the same routes, status codes, JSON
keys and 20-byte splat record).

The server holds a reference to the live ``SLAMSystem`` and snapshots its
state on request; nothing runs when no client asks.

Endpoints
---------
/                  viewer page (WebGL2, no external assets)
/api/state         JSON: keyframe poses (7-vec [t xyz, q xyzw] c2w),
                   tstamps, loop edges, counters
/api/splats        binary splat dump: u32 count, then per splat
                   3f32 xyz | 3u8 rgb | u8 opacity | f32 scale  (20 B)
/api/kf_image?i=N  keyframe N's stored RGB as PNG
/api/render?w2c=16 a novel view rasterized on the server by the port's
                   renderer (``slam/renderer.render_view``, the tile-blend
                   kernel on the card); w2c is 16 comma-separated
                   row-major floats (CV convention: +z forward, y down)

The port's Gaussian arena is updated in place by the mapper, so unlike
the JAX package's (an immutable pytree swapped whole) it cannot be read
at any time: every snapshot and every render runs under the system's
``state_lock``, which the loop holds around each stage and mapping slice
that writes keyframe or map state. A response therefore never mixes two
mapper steps, and no render runs while a step does.
"""
from __future__ import annotations

import io
import json
import os
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .. import full_f32

__all__ = ["ViewerServer", "pack_splats"]

_HTML_PATH = os.path.join(os.path.dirname(__file__), "viewer.html")
SPLAT_FIELDS = ("xyz", "f_dc", "opacity_logit", "log_scales")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _encode_png(img_u8: np.ndarray):
    try:
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(img_u8).save(buf, format="PNG")
        return buf.getvalue()
    except ImportError:
        import cv2
        ok, png = cv2.imencode(
            ".png", cv2.cvtColor(img_u8, cv2.COLOR_RGB2BGR))
        return png.tobytes() if ok else None


def _alive_rows(arena, max_splats: int):
    """Copies of the alive slots' (xyz, f_dc, opacity_logit, log_scales),
    at most ``max_splats``."""
    idx = torch.nonzero(arena.alive)[:max_splats, 0]
    return tuple(getattr(arena, f)[idx] for f in SPLAT_FIELDS)


def _pack(rows) -> bytes:
    xyz, f_dc, opa_logit, log_scales = (_np(r) for r in rows)
    n = xyz.shape[0]
    SH_C0 = 0.28209479177387814
    rgb = np.clip((f_dc * SH_C0 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    opa = (np.clip(_sigmoid(opa_logit), 0, 1) * 255).astype(np.uint8)
    scale = np.exp(log_scales).mean(axis=1).astype("<f4")
    rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3),
                             ("opa", "u1"), ("scale", "<f4")])
    rec["xyz"], rec["rgb"], rec["opa"], rec["scale"] = \
        xyz.astype("<f4"), rgb, opa, scale
    return struct.pack("<I", n) + rec.tobytes()


def pack_splats(arena, max_splats: int = 400_000) -> bytes:
    """Serialize the alive slots of a Gaussian arena (tensors on any
    device) into the wire format; SH degree-0 colour to u8 as the PLY
    dump does (utils/viz.py)."""
    return _pack(_alive_rows(arena, max_splats))


class _Handler(BaseHTTPRequestHandler):
    server_version = "cut3r-viewer/1.0"

    @property
    def viewer(self) -> "ViewerServer":
        return self.server._viewer  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # quiet by default
        if self.viewer.verbose:
            super().log_message(fmt, *args)

    def _send(self, code: int, ctype: str, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802  (http.server API)
        try:
            url = urlparse(self.path)
            if url.path in ("/", "/index.html"):
                with open(_HTML_PATH, "rb") as f:
                    self._send(200, "text/html; charset=utf-8", f.read())
            elif url.path == "/api/state":
                body = json.dumps(self.viewer.state_dict()).encode()
                self._send(200, "application/json", body)
            elif url.path == "/api/splats":
                self._send(200, "application/octet-stream",
                           self.viewer.splats_bytes())
            elif url.path == "/api/kf_image":
                q = parse_qs(url.query)
                i = int(q.get("i", ["0"])[0])
                png = self.viewer.kf_image_png(i)
                if png is None:
                    self._send(404, "text/plain", b"no such keyframe")
                else:
                    self._send(200, "image/png", png)
            elif url.path == "/api/render":
                q = parse_qs(url.query)
                vals = [float(v) for v in
                        q.get("w2c", [""])[0].split(",") if v]
                png = (self.viewer.render_pose_png(vals)
                       if len(vals) == 16 else None)
                if png is None:
                    self._send(404, "text/plain", b"no map to render")
                else:
                    self._send(200, "image/png", png)
            else:
                self._send(404, "text/plain", b"not found")
        except BrokenPipeError:
            pass
        except Exception as e:  # never take the SLAM loop down
            try:
                self._send(500, "text/plain", repr(e).encode())
            except Exception:
                pass


class ViewerServer:
    """Serve the live state of a ``SLAMSystem`` to a browser.

    Usage::

        viewer = ViewerServer(slam, port=8080)   # daemon thread
        ...
        viewer.stop()

    ``port=0`` takes a free port (``viewer.port`` says which).
    """

    def __init__(self, slam, host: str = "127.0.0.1", port: int = 8080,
                 max_splats: int = 400_000, verbose: bool = False):
        self.slam = slam
        self.max_splats = max_splats
        self.verbose = verbose
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd._viewer = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="cut3r-viewer",
            daemon=True)
        self._thread.start()

    # ----------------------------------------------------- snapshots --
    def state_dict(self) -> dict:
        slam = self.slam
        with self.slam.state_lock:
            kf = slam.keyframes
            n = int(kf.count)
            st = {
                "n_kf": n,
                "tstamps": _np(kf.tstamp[:n]).tolist(),
                "poses": _np(kf.pose[:n]).astype(np.float32)
                .round(6).tolist(),  # (n, 7) [t xyz, q xyzw] c2w
                "img_hw": list(getattr(slam, "img_hw", (0, 0))),
                "loop_edges": [],
                "n_alive": 0,
                "frame": int(getattr(slam, "last_t", -1)),
            }
            backend = getattr(slam, "backend", None)
            if backend is not None and getattr(backend, "closed_loop", None):
                cur = backend.closed_loop.get("idx_current", [])
                mat = backend.closed_loop.get("idx_matched", [])
                st["loop_edges"] = [[int(a), int(b)]
                                    for a, b in zip(mat, cur)]
            mapper = getattr(slam, "mapper", None)
            if mapper is not None:
                st["n_alive"] = int(_np(mapper.arena.alive).sum())
        return st

    def splats_bytes(self) -> bytes:
        """The alive Gaussians, gathered under the lock (copies, so the
        transfer and the packing run after it is released)."""
        with self.slam.state_lock:
            mapper = getattr(self.slam, "mapper", None)
            if mapper is None:
                return struct.pack("<I", 0)
            rows = _alive_rows(mapper.arena, self.max_splats)
        return _pack(rows)

    def kf_image_png(self, i: int):
        with self.slam.state_lock:
            kf = self.slam.keyframes
            if not (0 <= i < int(kf.count)):
                return None
            img = _np(kf.image[i]).copy()
        return _encode_png(img)

    def render_pose_png(self, w2c16):
        """Rasterize the live map from an arbitrary camera with the port's
        renderer (``slam/renderer.render_view`` over the arena's alive
        prefix, as every mapping render: the tile-blend kernel on the
        card), in float32."""
        mapper = getattr(self.slam, "mapper", None)
        if mapper is None or not all(hasattr(mapper, a) for a in
                                     ("arena", "K4", "raster_cfg")):
            return None
        from ..slam.renderer import render_view
        with self.slam.state_lock, torch.no_grad(), full_f32():
            K4 = mapper.K4
            w2c = torch.tensor(np.asarray(w2c16, np.float32).reshape(4, 4),
                               device=K4.device)
            arena = mapper._sliced()[0]
            out = render_view(arena.params(), arena.alive, w2c, K4,
                              mapper.raster_cfg)
            img = torch.clamp(out["color"], 0.0, 1.0).cpu().numpy()
        return _encode_png((img * 255).astype(np.uint8))

    # -------------------------------------------------------- control --
    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
