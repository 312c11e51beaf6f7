"""Device milliseconds of a DROID update iteration: the device time of
every operation launched inside a ``droid.update`` span of the traced
frame (``torch.profiler``, each operation at its launch's host time) over
the ``droid.updates`` counted there."""
LAYER = "tracking"
UNIT, SOURCE, MOVES = "ms", "device_trace", "slam_fps"


def read(r):
    t = r.get("droid_trace")
    if not t or not t["updates"]:
        return None
    return 1e3 * t["update_device_s"] / t["updates"]
