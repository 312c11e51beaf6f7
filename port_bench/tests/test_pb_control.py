"""The control: the reference put in the program's place in the precision
below the configuration's (CUT3R's products through float8, the render,
the mapper's losses and its Adam in bfloat16) comes out as not correct
through the cell's own check, where the program comes out correct. At a
tiny size on the CPU (the program's tiny CUT3R computes in float32
there); the readings at the cells' own sizes, on the card, are in
PERF.md."""
from conftest import tiny_cell
from port_bench import harness

SEED = 2 ** 34 + 5


def test_training_control_fails_the_check():
    cell = tiny_cell("train_v4")
    res = harness.driver("train_steps").calibrate(cell, SEED, "cpu",
                                                  faults=())
    assert res["program"]["correct"], res
    assert not res["control"]["correct"], res


def test_slam_control_fails_the_check():
    cell = tiny_cell("slam_map")
    drv = harness.driver("slam_stream")
    out = drv.run(cell, SEED, 1e9, False, "cpu", last_frame=23)
    assert out["check"].correct, out["check"].report()
    control = drv.controls(cell, out, "cpu")
    assert not control.correct, control.report()
