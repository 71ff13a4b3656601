"""The harness finds each configuration, traffic mix and per-layer metric
by name as a file of its own, and BENCHMARK.json names only what exists,
within the contract's limits."""
import json
import re
import shutil

import pytest

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return harness.benchmark()


def test_lists_files_of_each_kind():
    assert harness.names("configs") == ["popc_membrane", "water_pme"]
    assert harness.names("traffic") == ["dhfr_size-r100", "npt-r50"]
    assert set(harness.names("metrics")) == {
        "report_ms", "host_issue_ms_per_step", "rebuilds_per_1k_steps",
        "kernels_per_step", "device_idle_share", "nonbonded_tiles.roofline",
        "pme_kernels.roofline"}


def test_a_new_file_is_found_by_name(tmp_path, monkeypatch):
    """A traffic mix and a metric added as files, with no other edit."""
    copy = tmp_path / "mdbench"
    shutil.copytree(harness.HERE, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "*.npz"))
    (copy / "traffic" / "extra.json").write_text(json.dumps(
        {"ensemble": "nvt", "report_interval": 10}))
    (copy / "metrics" / "extra_metric.py").write_text(
        "def read(data):\n    return 42.0\n")
    monkeypatch.setattr(harness, "HERE", copy)
    assert "extra" in harness.names("traffic")
    assert harness.load("traffic", "extra")["report_interval"] == 10
    assert harness.load("metrics", "extra_metric").read({}) == 42.0


def test_benchmark_names_only_what_exists(spec):
    configs = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        assert w["config"] in configs
        assert w["traffic"] in harness.names("traffic")
        assert w["chips"] == 1
    for m in spec["per_layer"]:
        assert m["name"] in harness.names("metrics")
        assert callable(harness.load("metrics", m["name"]).read)
    for c in spec["configs"]:
        loaded = harness.load("configs", c["name"])
        assert "mdbench/configs/%s.json" % c["name"] == c["file"]
        assert loaded["reduced"] == c["reduced"]
        assert all(k in loaded for k in c["reduced"])
        for key in ("inputs", "reference"):
            assert (harness.HERE / loaded[key]).is_file()


def test_contract_limits(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    entries = (spec["configs"] + spec["workloads"] + spec["end_to_end"]
               + spec["per_layer"])
    assert len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in spec["workloads"]]
    reports = {m["name"]: set(m.get("workloads", cells))
               for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        # each cell that reads the metric reports what it moves
        assert set(m.get("workloads", cells)) <= reports[m["moves"]], m
    assert 1 <= spec["run_seconds"] <= 51
