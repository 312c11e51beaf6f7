"""Frames completed over the window's whole time."""
UNIT, SOURCE = "frames/s", "host_clock"


def read(r):
    if not r.get("records"):
        return None
    return len(r["records"]) / r["window_s"]
