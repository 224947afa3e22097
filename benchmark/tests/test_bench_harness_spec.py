"""BENCHMARK.json, and the files the harness finds by its names."""

from __future__ import annotations

import json
import re
import shutil
import time

import torch

from benchmark import harness

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_keys_names_and_limits_of_the_contract():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["paths"] == ["benchmark"] and s["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= s["run_seconds"] <= 51
    cells = len(s["workloads"])
    assert 2 + 14 * cells * (s["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(1, cells // 4)
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert m["moves"] in {e["name"] for e in s["end_to_end"]}
    names = [x["name"] for x in s["configs"] + s["workloads"] + s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_file_is_found_by_name():
    s = spec()
    for w in s["workloads"]:
        c = harness.cell(s, w["name"], REPO)
        assert (c.bench / "drivers" / f"{c.config['driver']}.py").is_file()
        harness.driver(c.bench, c.config["driver"])
        assert set(c.limits) == {"state_gap", "velocity_gap", "av_vels_gap"}
        assert c.traffic["dtype"] in ("float32", "bfloat16")
        for traced in (False, True):
            for m in harness.metrics_of(s, w["name"], traced):
                assert callable(harness.reader(c.bench, m["name"]))
        assert {m["name"] for m in harness.metrics_of(s, w["name"], False)} >= {"mlups", "setup_s"}
        assert harness.metrics_of(s, w["name"], True)


def test_a_new_config_cell_and_metric_are_new_files_only(root):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files (and entries of BENCHMARK.json) run with no edit to a file
    the benchmark has."""
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "small3.json").read_text())
    cfg.update(nz=6, ny=8, nx=8, steps=8)
    (bench / "configs" / "new3.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "back_to_back.f32.json").read_text())
    (bench / "traffic" / "new_mix.json").write_text(json.dumps(traffic))
    shutil.copy(bench / "limits" / "small3.f32.json", bench / "limits" / "new3.new_mix.json")
    (bench / "metrics" / "jobs_in_window.py").write_text(
        "def read(ctx):\n    return ctx.jobs\n")
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "new3", "source": "test", "file": "benchmark/configs/new3.json",
                         "reduced": [], "why": "test"})
    s["workloads"].append({"name": "new3.new_mix", "config": "new3", "traffic": "new_mix",
                           "chips": 1, "why": "test"})
    s["per_layer"].append({"name": "jobs_in_window", "unit": "jobs", "better": "higher",
                           "source": "program_counter", "layer": "runner", "moves": "mlups"})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    result = harness.run(root, "new3.new_mix", 7, 0.2, True, torch.device("cpu"),
                         time.perf_counter())
    assert result["correct"] and result["metrics"]["jobs_in_window"]["value"] >= 1
    result = harness.run(root, "new3.new_mix", 7, 0.2, False, torch.device("cpu"),
                         time.perf_counter())
    assert set(result["metrics"]) == {"mlups", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"

