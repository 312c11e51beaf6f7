"""Host frame store (port of ``CompressedFrameStore`` from
``cut3r_slam_tpu/utils/image.py``): every frame kept as JPEG bytes, which
bounds host memory on long runs. The ingest stream (``mono_stream``) is
not ported yet; it comes with the ``demo.py``-style entry point."""
from __future__ import annotations

import numpy as np

__all__ = ["CompressedFrameStore"]


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
