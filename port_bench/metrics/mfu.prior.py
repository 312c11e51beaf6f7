"""The window's share of the card's peak with the monocular prior on:
DroidNet's operations and the dense BA's as ``mfu.droid`` counts them,
plus Omnidata's least time for each ``prior.keyframes`` counted in the
window (``omnidata_roofline``: convolutions at the TF32 peak, matrix
products at the float32 peak), over the window's length."""
LAYER = "whole step"
UNIT, SOURCE, MOVES = "%", "program_counter", "slam_fps"


def read(r):
    droid, prior = r.get("least_s"), r.get("prior_least_s")
    if not droid or not prior or not r.get("window_s"):
        return None
    return 100.0 * (droid + prior) / r["window_s"]
