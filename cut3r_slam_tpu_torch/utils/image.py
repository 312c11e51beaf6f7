"""Frame ingest and the host frame store (port of ``cut3r_slam_tpu/utils/
image.py``).

``mono_stream`` reads an image directory (optionally undistorted and
border-cropped) and yields every frame at the two resolutions of the
system with rescaled intrinsics: tracking at width ``target_w`` and a
height that is a multiple of 16, mapping at the same width and an even
height. ``prefetch_stream`` decodes ahead on a thread.
``CompressedFrameStore`` keeps every frame as JPEG bytes, which bounds
host memory on long runs. Images go through cv2.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["mono_stream", "list_images", "resize_with_intrinsics",
           "prefetch_stream", "CompressedFrameStore"]

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm")
_COLOR = ("frame", "rgb", "color")
_AUX = ("depth", "normal", "mask", "conf")


def list_images(imagedir: str):
    """The directory's images in name order. Where colour-frame names
    (frame*, rgb*, color*) sit beside auxiliary streams (depth*, normal*,
    mask*, conf*; Replica-style results folders), the colour frames only.
    The JAX package keeps the colour-named files whenever any other file
    is present, which drops real frames from a folder that mixes, say,
    rgb_*.png and img_*.png; here every such folder keeps all its
    images."""
    files = [f for f in sorted(os.listdir(imagedir))
             if f.lower().endswith(_EXTS)]
    frames = [f for f in files if f.lower().startswith(_COLOR)]
    rest = [f for f in files if not f.lower().startswith(_COLOR)]
    if frames and rest and all(f.lower().startswith(_AUX) for f in rest):
        files = frames
    return [os.path.join(imagedir, f) for f in files]


def _imread(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot read image {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    import cv2
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)


def resize_with_intrinsics(img: np.ndarray, K4: np.ndarray,
                           target_w: int = 512, multiple: int = 16
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Resize to width ``target_w`` and the height the aspect gives, cut
    down to a multiple of ``multiple``; K4 = [fx, fy, cx, cy] scaled."""
    h0, w0 = img.shape[:2]
    w1 = target_w
    h1 = int(target_w / w0 * h0) // multiple * multiple
    sx, sy = w1 / w0, h1 / h0
    K = np.asarray([K4[0] * sx, K4[1] * sy, K4[2] * sx, K4[3] * sy],
                   np.float32)
    return _resize(img, w1, h1), K


def mono_stream(imagedir: str, calib: np.ndarray, stride: int = 1,
                crop_border: int = 0, undistort: bool = False,
                start: int = 0, length: Optional[int] = None,
                target_w: int = 512) -> Iterator[Tuple]:
    """Yields (t, img, K4, img_map, K4_map, is_last); ``calib`` holds
    fx fy cx cy and optional distortion coefficients."""
    calib = np.asarray(calib, np.float64).reshape(-1)
    K4 = calib[:4].astype(np.float32)
    dist = calib[4:] if calib.size > 4 else None
    paths = list_images(imagedir)[start::stride]
    if length is not None:
        paths = paths[:length]
    n = len(paths)
    for t, path in enumerate(paths):
        img = _imread(path)
        K = K4.copy()
        if undistort and dist is not None and np.any(dist != 0):
            import cv2
            Km = np.array([[K[0], 0, K[2]], [0, K[1], K[3]], [0, 0, 1]])
            img = cv2.undistort(img, Km, dist)
        if crop_border > 0:
            c = crop_border
            img = img[c:-c, c:-c]
            K = np.asarray([K[0], K[1], K[2] - c, K[3] - c], np.float32)
        img_track, K_track = resize_with_intrinsics(img, K, target_w, 16)
        img_map, K_map = resize_with_intrinsics(img, K, target_w, 2)
        yield t, img_track, K_track, img_map, K_map, t == n - 1


def prefetch_stream(it: Iterator, depth: int = 8) -> Iterator:
    """Run ``it`` on a daemon thread into a queue of ``depth`` items, so
    decoding and resizing overlap the device loop; an exception in the
    producer is raised in the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(end)
        except BaseException as e:
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


class CompressedFrameStore:
    """Dict-like store of full frames as JPEG bytes (cv2 codec): [] get /
    set, ``in``, iteration over timestamps, len, bool."""

    def __init__(self, quality: int = 92):
        self._enc = {}
        self.quality = int(quality)

    def __setitem__(self, t, img: np.ndarray):
        import cv2
        img = np.ascontiguousarray(img)
        ok, buf = cv2.imencode(".jpg", img[..., ::-1],
                               [int(cv2.IMWRITE_JPEG_QUALITY), self.quality])
        if not ok:
            raise RuntimeError("JPEG encode failed")
        self._enc[int(t)] = np.frombuffer(buf.tobytes(), np.uint8)

    def __getitem__(self, t) -> np.ndarray:
        import cv2
        img = cv2.imdecode(self._enc[int(t)], cv2.IMREAD_COLOR)
        return np.ascontiguousarray(img[..., ::-1])

    def __contains__(self, t):
        return int(t) in self._enc

    def __iter__(self):
        return iter(self._enc)

    def __len__(self):
        return len(self._enc)

    def nbytes(self) -> int:
        return sum(a.nbytes for a in self._enc.values())
