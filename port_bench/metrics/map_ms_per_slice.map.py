"""The stage timer's ``mapping`` total over the window's mapping slices."""
LAYER = "mapping"
UNIT, SOURCE, MOVES = "ms", "program_span", "slam_fps"


def read(r):
    spans = r.get("spans")
    slices = sum(x["slices"] for x in r.get("records", []))
    if not spans or "mapping" not in spans or slices == 0:
        return None
    return 1e3 * spans["mapping"] / slices
