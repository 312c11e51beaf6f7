"""The correlation lookup's share of its roofline in the traced frame:
the least time of its lookups (the distinct window cells of every level
in the pyramid's dtype, the coordinates in and the window correlations
out, ``droid_roofline.lookup_bytes``, at the HBM rate) over the device
time of the operations launched inside ``droid.corr_lookup``."""
from port_bench.peaks import PEAK_BYTES

LAYER = "tracking"
UNIT, SOURCE, MOVES = "%", "device_trace", "slam_fps"


def read(r):
    t = r.get("droid_trace")
    if not t or not t["lookup_device_s"] or not t["lookup_bytes"]:
        return None
    return 100.0 * t["lookup_bytes"] / PEAK_BYTES / t["lookup_device_s"]
