"""Everything is found by name: a configuration, a traffic mix and a
per-layer metric that exist only as new files are found and run."""
import json
import os
import shutil

import pytest

from conftest import ROOT, TINY
from port_bench import harness, run


def _new_files(tmp_path):
    """A copy of the benchmark's folder beside a BENCHMARK.json that adds
    one configuration, one mix and one metric, each a new file only."""
    root = tmp_path / "pb"
    shutil.copytree(os.path.join(ROOT, "port_bench"), root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = json.load(open(root / "configs" / "cut3r_train_512.json"))
    cfg["name"] = "cut3r_train_tiny"
    cfg["model"]["widths"].update(TINY)
    cfg["model"]["compute_dtype"] = "float32"
    cfg["hw"] = [32, 48]
    json.dump(cfg, open(root / "configs" / "cut3r_train_tiny.json", "w"))
    mix = json.load(open(root / "traffic" / "train_v4.json"))
    mix["views"] = 2
    json.dump(mix, open(root / "traffic" / "train_v2.json", "w"))
    (root / "metrics" / "steps_done.train.py").write_text(
        'LAYER = "trainer"\nUNIT, SOURCE, MOVES = "steps", '
        '"program_counter", "train_views_per_s"\n\n\n'
        'def read(r):\n    return r.get("steps")\n')
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"].append({"name": "cut3r_train_tiny", "source": "x",
                             "file": "pb/configs/cut3r_train_tiny.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "train_v2", "config":
                               "cut3r_train_tiny", "traffic": "train_v2",
                               "chips": 1, "why": "x"})
    bench["end_to_end"][2]["workloads"].append("train_v2")
    bench["per_layer"].append({"name": "steps_done.train", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "trainer",
                               "moves": "train_views_per_s",
                               "workloads": ["train_v2"]})
    path = tmp_path / "BENCHMARK.json"
    json.dump(bench, open(path, "w"))
    return str(root), str(path)


def test_a_new_config_mix_and_metric_are_found_and_run(tmp_path):
    root, path = _new_files(tmp_path)
    cell = harness.load_cell("train_v2", bench_path=path, root=root)
    assert cell.config["name"] == "cut3r_train_tiny"
    assert cell.traffic["views"] == 2
    assert [m["name"] for m in cell.per_layer] == ["steps_done.train"]
    assert {m["name"] for m in cell.end_to_end} == {"train_views_per_s",
                                                    "setup_s"}
    drv = harness.driver(cell.traffic["driver"], root=root)
    out = drv.run(cell, 11, 0.5, False, "cpu")
    got = harness.read_metrics(cell.per_layer, out["readings"], root=root)
    assert got == {"steps_done.train": {"value": float(out["attempted"]),
                                        "unit": "steps"}}
    assert out["check"].correct, out["check"].report()


def test_every_named_file_exists():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        harness.driver(cell.traffic["driver"])
        assert set(cell.traffic["limits"])
    for m in bench["per_layer"] + bench["end_to_end"]:
        if m["name"] != "setup_s":
            mod = harness.load_module(os.path.join(
                harness.ROOT, "metrics", m["name"] + ".py"), "m")
            assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
    for m in bench["per_layer"]:
        mod = harness.load_module(os.path.join(
            harness.ROOT, "metrics", m["name"] + ".py"), "m")
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


def test_result_line_has_the_contract_keys(monkeypatch):
    from port_bench.compare import Check
    monkeypatch.setattr(harness, "device_line", lambda n, b, p: {
        "platform": "gpu", "kind": "x", "count": n,
        "memory_peak_bytes": b, "power_limit_w": p})
    cell = harness.load_cell("train_v4")
    chk = Check({"loss": 1.0})
    chk.add("loss", 0.5)
    out = {"check": chk, "attempted": 3, "failed": 0, "peak": 123,
           "readings": {"steps": 3, "views": 12, "window_s": 2.0,
                        "trace": {"busy_s": 1.0, "window_s": 2.0,
                                  "device_ops": [("k", 1.0)],
                                  "idle_gaps": [("host", 1.0)]},
                        "flops": {"train_step": 1e12}}}

    class A:
        trace = 0
    line = run.result_line(cell, out, A, 12.5, 700.0)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["metrics"] == {
        "setup_s": {"value": 12.5, "unit": "s"},
        "train_views_per_s": {"value": 6.0, "unit": "views/s"}}
    assert line["device"]["memory_peak_bytes"] == 123
    A.trace = 1
    line = run.result_line(cell, out, A, 12.5, 700.0)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert set(line["metrics"]) == {"mfu.train", "device_idle.train"}
    assert line["metrics"]["device_idle.train"]["value"] == 50.0
    assert line["device"]["busy_s"] == 1.0
    assert line["checks"] == {"loss": {"value": 0.5, "limit": 1.0}}


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(ROOT)
    assert run.main(["--workload", "train_v4", "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", ["slam_map", "train_v4"])
def test_limits_name_every_compared_number(cell):
    c = harness.load_cell(cell)
    assert all(v > 0 for v in c.traffic["limits"].values())
