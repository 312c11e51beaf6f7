"""Device milliseconds of a keyframe's monocular prior: the device time
of every operation launched inside a ``prior.depth``, ``prior.normal`` or
``prior.store`` span of the traced frame (``torch.profiler``, each
operation at its launch's host time) over the ``prior.keyframes``
counted there."""
LAYER = "prior"
UNIT, SOURCE, MOVES = "ms", "device_trace", "slam_fps"


def read(r):
    t = r.get("prior_trace")
    if not t or not t["keyframes"] or not t["device_s"]:
        return None
    return 1e3 * t["device_s"] / t["keyframes"]
