"""The whole window's share of the card's peak with mapping: CUT3R's
encodes and decodes over the bf16 peak plus the mapper's rendered views
over the FP32 peak, over the window's length."""
from port_bench.roofline import slam_least_s

LAYER = "whole step"
UNIT, SOURCE, MOVES = "%", "program_counter", "slam_fps"


def read(r):
    least = slam_least_s(r)
    return None if least is None else 100.0 * least / r["window_s"]
