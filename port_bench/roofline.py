"""The least time the card could take for the work a run did, from the
operations and bytes that work needs (counted from shapes and from the
reference's blend census) and the published peaks (``peaks.py``)."""
from __future__ import annotations

from port_bench.peaks import PEAK_BF16, PEAK_BYTES, PEAK_FP32
from port_bench.reference.raster import FLOPS_PER_PAIR

__all__ = ["render_ops", "render_bytes", "render_least_s", "idle_share",
           "slam_least_s"]

# floats of one Gaussian: xyz 3, f_dc 3, opacity 1, log-scales 3, quat 4
GAUSS_FLOATS = 14
# floats of a pixel's maps out: colour 3, alpha, depth, median depth,
# normal 3
MAP_FLOATS = 9


def render_ops(census, grad: bool) -> float:
    """FP32 operations of one view's blend: the (rejected, stopping,
    blended) pairs times the per-pair operations of the forward, and of
    the backward too for a gradient."""
    ops = sum(n * f for n, f in zip(census, FLOPS_PER_PAIR["forward"]))
    if grad:
        ops += sum(n * f for n, f in zip(census, FLOPS_PER_PAIR["backward"]))
    return float(ops)


def render_bytes(n_gauss: int, hw, grad: bool) -> float:
    """The Gaussians in and the maps out, once each; a gradient adds the
    colour's cotangent in and the Gaussians' gradients out."""
    px = hw[0] * hw[1]
    b = 4 * (n_gauss * GAUSS_FLOATS + px * MAP_FLOATS)
    if grad:
        b += 4 * (n_gauss * GAUSS_FLOATS + px * 3)
    return float(b)


def render_least_s(render: dict, grad: bool) -> float:
    """The mean least time of a render of the roofline's views."""
    least = [max(render_ops(c, grad) / PEAK_FP32,
                 render_bytes(render["n_gauss"], render["hw"], grad)
                 / PEAK_BYTES) for c in render["census"]]
    return sum(least) / len(least)


def idle_share(readings):
    """Per cent of the traced window in which no operation ran on the
    device, or None without a trace."""
    tr = readings.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def slam_least_s(readings):
    """The SLAM window's least time: CUT3R's encodes and decodes at the bf16
    peak plus the mapper's rendered views at the roofline views' mean
    blend operations over the FP32 peak; None where a part is unread."""
    fl, render = readings.get("flops"), readings.get("render")
    if not fl or not render:
        return None
    n = len(render["census"])
    fwd = sum(render_ops(c, False) for c in render["census"]) / n
    grad = sum(render_ops(c, True) for c in render["census"]) / n
    return ((readings["encodes"] * fl["encode"]
             + readings["decodes"] * fl["decode"]) / PEAK_BF16
            + (readings["views_fwd"] * fwd
               + readings["views_grad"] * grad) / PEAK_FP32)
