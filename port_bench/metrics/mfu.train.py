"""The window's share of the card's bf16 peak: each completed step's
forward and backward operations, counted from CUT3R's shapes, over the
window's length."""
from port_bench.peaks import PEAK_BF16

LAYER = "trainer"
UNIT, SOURCE, MOVES = "%", "program_counter", "train_views_per_s"


def read(r):
    fl = r.get("flops")
    if not fl or not r.get("steps"):
        return None
    return 100.0 * r["steps"] * fl["train_step"] / PEAK_BF16 / r["window_s"]
