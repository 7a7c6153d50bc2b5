"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its file: a cell, configuration, traffic mix or per-layer
metric is added with new files and new entries alone."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "perfbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(b["command"]) <= 32
    assert all(line(word) for word in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for path in b["paths"]:
        assert PATH.match(path) and not path.startswith("/") \
            and ".." not in path.split("/")
        assert os.path.isdir(os.path.join(ROOT, path))
    assert b["command"][1].startswith(b["paths"][0] + "/")


def test_run_seconds_fits_a_full_check():
    seconds = bench()["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    runs = 2 + 14 * 24
    assert runs * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", bench()["configs"],
                         ids=lambda e: e["name"])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and line(entry["source"])
    assert line(entry["why"])
    assert entry["file"] == "perfbench/configs/{}.json".format(
        entry["name"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    assert len(entry["reduced"]) <= 16
    assert all(NAME.match(key) for key in entry["reduced"])
    assert "assumed" in config
    assert any(w["config"] == entry["name"] for w in bench()["workloads"])


@pytest.mark.parametrize("entry", bench()["workloads"],
                         ids=lambda e: e["name"])
def test_cell_resolves(entry):
    b = bench()
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] in (1, 4) and line(entry["why"])
    assert entry["config"] in {c["name"] for c in b["configs"]}
    with open(os.path.join(HERE, "traffic",
                           entry["traffic"] + ".json")) as f:
        mode = json.load(f)["mode"]
    assert os.path.isfile(os.path.join(HERE, "modes", mode + ".py"))
    with open(os.path.join(HERE, "limits", entry["name"] + ".json")) as f:
        limits = json.load(f)
    assert limits and all(v >= 0 for v in limits.values())
    reported = [m["name"] for m in b["end_to_end"]
                if entry["name"] in m.get("workloads", [entry["name"]])]
    assert "setup_s" in reported and len(reported) >= 2
    assert any(entry["name"] in m["workloads"] for m in b["per_layer"])


def test_names_are_unique_and_four_chip_cells_few():
    b = bench()
    for group in ("configs", "workloads"):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


@pytest.mark.parametrize("metric", bench()["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    cells = {w["name"] for w in bench()["workloads"]}
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert set(metric.get("workloads", [])) <= cells


@pytest.mark.parametrize("metric", bench()["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_has_its_reader(metric):
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    assert set(metric) == {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and line(metric["layer"])
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    moves = [m for m in b["end_to_end"] if m["name"] == metric["moves"]]
    assert moves and moves[0]["name"] != "setup_s"
    for cell in metric["workloads"]:
        assert cell in cells
        assert cell in moves[0].get("workloads", [cell])
    assert os.path.isfile(os.path.join(HERE, "metrics",
                                       metric["name"] + ".py"))
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_layers_named_alike():
    layers = {}
    for metric in bench()["per_layer"]:
        layers.setdefault(metric["layer"].lower(), set()).add(
            metric["layer"])
    assert all(len(spellings) == 1 for spellings in layers.values())


def test_harness_reads_nothing_of_the_jax_benchmarks():
    for folder, _, files in os.walk(HERE):
        for name in files:
            if name.endswith(".py") and "tests" not in folder:
                with open(os.path.join(folder, name)) as f:
                    text = f.read()
                for word in ("benchmarks/", "bench.py", "BENCH_"):
                    assert word not in text, (name, word)
