"""Per cent of the traced keyframe frame (after the initialisation) in
which no operation ran on the device (the union of the device operations'
intervals, ``torch.profiler``)."""
from port_bench.roofline import idle_share

LAYER = "device"
UNIT, SOURCE, MOVES = "%", "device_trace", "slam_fps"


def read(r):
    return idle_share(r)
