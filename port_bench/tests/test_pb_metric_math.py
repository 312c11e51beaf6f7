"""The benchmark's arithmetic on hand-made inputs: device busy time as the
union of intervals, idle gaps by host span, roofline shares from a
hand-made census, operations counted from shapes."""
import pytest

from conftest import TINY
from port_bench import flops, roofline, trace
from port_bench.peaks import PEAK_BYTES, PEAK_FP32


def test_union_of_overlapping_intervals():
    assert trace.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union_seconds([(5, 6), (0, 1), (0.5, 0.75)]) == 2
    assert trace.union_seconds([]) == 0


def test_idle_gaps_inside_the_window():
    gaps = trace.idle_gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6)
    assert gaps == [(0, 1), (3, 4), (5, 6)]


def test_reduce_busy_idle_and_labels():
    events = [("device", "k1", 1.0, 2.0), ("device", "k2", 1.5, 3.0),
              ("device", "k1", 4.0, 5.0),
              ("span", "mapping", 0.0, 6.0), ("span", "frontend", 3.0, 4.0)]
    r = trace.reduce(events, (0.0, 6.0))
    assert r["busy_s"] == pytest.approx(3.0)
    assert r["window_s"] == 6.0
    assert dict(r["device_ops"]) == {"k1": 2.0, "k2": 1.5}
    # gaps [0,1) and [5,6) open under mapping, [3,4) under frontend
    assert dict(r["idle_gaps"]) == {"mapping": 2.0, "frontend": 1.0}
    assert roofline.idle_share({"trace": r}) == pytest.approx(50.0)


def test_render_roofline_from_a_census():
    census = [[100, 10, 1000]]           # rejected, stopping, blended
    fwd_ops = 100 * 13 + 10 * 16 + 1000 * 43
    assert roofline.render_ops(census[0], False) == fwd_ops
    assert roofline.render_ops(census[0], True) == \
        fwd_ops + 100 * 13 + 10 * 16 + 1000 * 85
    render = {"census": census, "n_gauss": 10, "hw": (16, 16)}
    least = max(fwd_ops / PEAK_FP32, 4 * (10 * 14 + 256 * 9) / PEAK_BYTES)
    assert roofline.render_least_s(render, False) == pytest.approx(least)


def test_encoder_operations_from_shapes():
    """Patch embedding and every block's products, by hand."""
    H = W = 32
    N, D, P = (H // 16) * (W // 16), TINY["enc_embed_dim"], 16
    per_block = (2 * N * D * 3 * D + 2 * 2 * N * N * D + 2 * N * D * D
                 + 2 * 2 * N * D * 4 * D)
    want = 2 * N * 3 * P * P * D + TINY["enc_depth"] * per_block
    assert flops.encode_flops(TINY, H, W) == want


def test_training_counts_forward_and_backward():
    fwd = flops.decode_flops(TINY, 32, 48, 2, ("self", "cross", "rgb",
                                                "pose")) \
        + 2 * flops.encode_flops(TINY, 32, 48)
    both = flops.train_step_flops(TINY, 32, 48, 2, 1)
    assert 2.5 * fwd < both < 3.5 * fwd
