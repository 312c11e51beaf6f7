"""The monocular prior's share of its roofline in the traced frame: the
least time of its keyframes' depth and normal forwards
(``omnidata_roofline.least_s``: the convolutions at the TF32 peak, the
matrix products at the float32 peak, the weights' bytes as a floor) over
the device time of the operations launched inside the prior's spans."""
LAYER = "prior"
UNIT, SOURCE, MOVES = "%", "device_trace", "slam_fps"


def read(r):
    t = r.get("prior_trace")
    if not t or not t["keyframes"] or not t["device_s"]:
        return None
    return 100.0 * t["least_s"] / t["device_s"]
