"""The render forward's share of its roofline: the least time of
``render_view`` without gradient on the map the window left (the larger
of the blend's FP32 operations over the FP32 peak and the Gaussians in
plus the maps out over the HBM rate) over its time by CUDA events."""
from port_bench.roofline import render_least_s

LAYER = "render"
UNIT, SOURCE, MOVES = "%", "device_trace", "slam_fps"


def read(r):
    render = r.get("render")
    if not render or not render["census"]:
        return None
    return 100.0 * render_least_s(render, False) / render["fwd_s"]
