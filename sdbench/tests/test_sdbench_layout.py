"""The benchmark's files are found by name and keep to the contract's
characters, keys and cross-references."""

import json
import os
import re

import pytest

from sdbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["sdbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][1] == "sdbench/run.py"
    assert os.path.isfile(os.path.join(ROOT, BENCH["command"][1]))


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS \
        + [m["name"] for m in BENCH["end_to_end"]] + METRICS
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] == 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.workload["name"] == cell
    assert os.path.isfile(os.path.join(ROOT, "sdbench", "entries",
                                       f"{c.workload['entry']}.py"))
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
    entry = [w for w in BENCH["workloads"] if w["name"] == cell][0]
    assert entry["why"] == c.workload["why"]
    assert entry["traffic"] == c.workload["traffic"]


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    entry = [c for c in BENCH["configs"] if c["name"] == config][0]
    assert entry["file"] == f"sdbench/configs/{config}.json"
    body = json.load(open(os.path.join(ROOT, entry["file"])))
    assert body["name"] == config
    assert body["reduced"] == entry["reduced"] == []
    assert os.path.isdir(os.path.join(ROOT, body["instance"]))
    # the instance's files are pinned by their hashes
    assert harness.instance_dir(body) == os.path.join(ROOT, body["instance"])
    assert set(body["instance_sha256"]) == {
        f"{config}.{e}" for e in ("cor", "sto", "tim")}
    assert any(w["config"] == config for w in BENCH["workloads"])


def test_changed_instance_refused(tmp_path):
    body = json.load(open(os.path.join(ROOT, "sdbench/configs/ssn.json")))
    for fname in body["instance_sha256"]:
        src = os.path.join(ROOT, body["instance"], fname)
        (tmp_path / fname).write_bytes(open(src, "rb").read())
    harness.instance_dir(dict(body, instance=str(tmp_path)))
    with open(tmp_path / "ssn.sto", "a") as f:
        f.write("* one more line\n")
    with pytest.raises(ValueError):
        harness.instance_dir(dict(body, instance=str(tmp_path)))


@pytest.mark.parametrize("metric", METRICS)
def test_metric_readers_found_by_name(metric):
    mod = harness.load_metric(metric)
    entry = [m for m in BENCH["per_layer"] if m["name"] == metric][0]
    assert mod.LAYER == entry["layer"]
    assert mod.UNIT == entry["unit"]
    assert mod.SOURCE == entry["source"]
    # a quantity split by the end-to-end metric it moves shares a reader
    assert harness.quantity(entry["moves"], {mod.MOVES}) == mod.MOVES
    assert mod.BETTER == entry["better"]
    # a reader that finds nothing to read returns nothing
    assert mod.read({}) is None


def test_unknown_cell_refused():
    with pytest.raises(ValueError):
        harness.load_cell("no.such_cell")
    with pytest.raises(ValueError):
        harness.load_cell("../BENCHMARK")
