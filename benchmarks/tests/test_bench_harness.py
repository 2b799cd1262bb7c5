"""The harness finds its cells, configurations, mixes and metrics by name,
and BENCHMARK.json keeps to the benchmark's contract."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmarks import check, drivers, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = run.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moves and m["layer"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    c, config, traffic = run.find_cell(BENCH, cell)
    assert config["name"] == c["config"]
    assert issubclass(drivers.load(config["kind"]), drivers.Driver)
    assert traffic["batch_views"] >= 1 and traffic["loop"] == "closed"
    assert {"sgm_mismatch", "opt_gap"} <= set(config["limits"]) <= \
        set(check.NAMES)
    assert c["chips"] == 1
    assert run.metric_entries(BENCH, False) == BENCH["end_to_end"]
    assert run.metric_entries(BENCH, True) == BENCH["per_layer"]


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["end_to_end"]
                                  + BENCH["per_layer"]])
def test_each_metric_has_a_reader(name):
    assert callable(run.load_reader(name))


def test_config_files_lie_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("benchmarks/") and os.path.exists(
            os.path.join(run.ROOT, f))


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        run.find_cell(BENCH, "no.such.cell")


def test_a_new_cell_is_data_alone(tmp_path):
    """A configuration of a new kind, its driver, a mix and a metric added
    as files and entries, with no edit of the harness, are found by name."""
    root = tmp_path
    (root / "benchmarks" / "traffic").mkdir(parents=True)
    (root / "benchmarks" / "configs").mkdir()
    (root / "benchmarks" / "metrics").mkdir()
    (root / "benchmarks" / "drivers").mkdir()
    (root / "benchmarks" / "drivers" / "forward.py").write_text(
        "from benchmarks import drivers\n\n\n"
        "class Driver(drivers.Driver):\n    pass\n")
    (root / "benchmarks" / "traffic" / "batch8.json").write_text(
        json.dumps({"batch_views": 8, "loop": "closed"}))
    with open(os.path.join(run.ROOT, "benchmarks", "configs",
                           "dtu49.json")) as f:
        config = json.load(f)
    config["name"], config["kind"] = "dtu49s", "forward"
    (root / "benchmarks" / "configs" / "dtu49s.json").write_text(
        json.dumps(config))
    (root / "benchmarks" / "metrics" / "views_per_s.py").write_text(
        "def read(ctx):\n    return ctx.views / ctx.seconds\n")
    bench = {"configs": [{"name": "dtu49s",
                          "file": "benchmarks/configs/dtu49s.json"}],
             "workloads": [{"name": "dtu49s.batch8", "config": "dtu49s",
                            "traffic": "batch8", "chips": 1}],
             "end_to_end": [{"name": "views_per_s", "unit": "views/s"}],
             "per_layer": []}
    c, cfg, traffic = run.find_cell(bench, "dtu49s.batch8", root=str(root))
    assert cfg["name"] == "dtu49s" and traffic["batch_views"] == 8
    kind = drivers.load(cfg["kind"], root=str(root / "benchmarks" /
                                               "drivers"))
    assert issubclass(kind, drivers.Driver)
    (entry,) = run.metric_entries(bench, False)
    reader = run.load_reader(entry["name"], root=str(root / "benchmarks"))
    assert reader(run.Context(views=4, seconds=2.0)) == 2.0
