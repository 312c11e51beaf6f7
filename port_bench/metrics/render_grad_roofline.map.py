"""The render gradient's share of its roofline: ``render_view`` and the
gradient of the colour's mean (forward and backward blend operations;
the Gaussians and their gradients, the maps and the colour's cotangent)
over its time by CUDA events."""
from port_bench.roofline import render_least_s

LAYER = "render"
UNIT, SOURCE, MOVES = "%", "device_trace", "slam_fps"


def read(r):
    render = r.get("render")
    if not render or not render["census"]:
        return None
    return 100.0 * render_least_s(render, True) / render["grad_s"]
