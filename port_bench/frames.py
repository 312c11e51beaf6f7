"""The SLAM cells' video and the per-frame mapping accounting (copied from
the port's benchmark driver, so that a change to the program cannot move
the yardstick)."""
from __future__ import annotations

import numpy as np

__all__ = ["synth_frames", "intrinsics", "frame_accounting"]


def synth_frames(n, H, W, seed, step=8):
    """A sliding window over a textured panorama: ``n`` overlapping
    (H, W, 3) uint8 frames, each ``step`` pixels right of the last. The
    panorama is uniform noise box-blurred twice, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    pano = rng.uniform(0, 255, (H + 16, W + step * n, 3)).astype(np.float32)
    for _ in range(2):
        pano = (pano + np.roll(pano, 1, 0) + np.roll(pano, 1, 1)
                + np.roll(pano, -1, 0) + np.roll(pano, -1, 1)) / 5.0
    pano = pano.astype(np.uint8)
    return [pano[8:8 + H, i * step:i * step + W] for i in range(n)]


def intrinsics(H, W, f_over_w=0.9):
    """[fx, fy, cx, cy] = (f W, f W, W / 2, H / 2)."""
    return np.asarray([f_over_w * W, f_over_w * W, W / 2, H / 2], np.float32)


def frame_accounting(has_viz, slices, gen_before, gen_after):
    """(mapping frame, mapping events completed) of one frame, from whether
    it started an event, the mapping slices it ran and whether an
    interleaved event was pending before and after it."""
    did_map = slices > 0 or has_viz
    done = int(has_viz and gen_before)  # the previous backlog force-drained
    if (has_viz or gen_before) and not gen_after:
        done += 1                       # this or the pending event finished
    return did_map, done
