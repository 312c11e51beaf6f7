"""Views of all completed training steps over the window's whole time."""
UNIT, SOURCE = "views/s", "host_clock"


def read(r):
    if not r.get("steps"):
        return None
    return r["views"] / r["window_s"]
