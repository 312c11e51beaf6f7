"""The window's share of the card's peak: DroidNet's operations counted
from shapes (the encoders per encoded frame, the update operator per edge
and per window frame of every update, each new edge's correlation
product) at the float16 peak, the dense BA's matrix products at the
float32 peak, over the window's length."""
LAYER = "whole step"
UNIT, SOURCE, MOVES = "%", "program_counter", "slam_fps"


def read(r):
    least = r.get("least_s")
    if not least or not r.get("window_s"):
        return None
    return 100.0 * least / r["window_s"]
