"""The largest frame's latency in the window (frame start to its
return and a device synchronize)."""
UNIT, SOURCE = "s", "host_clock"


def read(r):
    if not r.get("records"):
        return None
    return max(x["s"] for x in r["records"])
