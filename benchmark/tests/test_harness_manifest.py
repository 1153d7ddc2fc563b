"""``BENCHMARK.json`` keeps to the contract's shapes, and every name it gives
has its files."""

from __future__ import annotations

import json
import re

from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_names_and_units():
    _check_shapes(manifest())


def _check_shapes(m: dict):
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for metric in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
    for metric in m["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names


def test_pending_entries_keep_the_same_shapes():
    """The left-out cells' entries are ready to be added as they stand."""
    pending = json.loads((ROOT / "benchmark" / "pending_entries.json").read_text())
    merged = manifest()
    for key in ("workloads", "end_to_end", "per_layer"):
        merged[key] = merged[key] + pending[key]
    _check_shapes(merged)
    _check_files(merged)


def test_every_name_has_its_files():
    _check_files(manifest())


def _check_files(m: dict):
    configs = {c["name"]: c for c in m["configs"]}
    e2e = {x["name"] for x in m["end_to_end"]}
    for c in m["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in m["workloads"]:
        assert w["config"] in configs
        cell = json.loads((ROOT / "benchmark" / "cells" / f"{w['name']}.json").read_text())
        assert (ROOT / "benchmark" / "traffic" / f"{cell['kind']}.py").exists()
    cells = {w["name"] for w in m["workloads"]}
    for metric in m["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").exists()
        assert metric["moves"] in e2e and set(metric["workloads"]) <= cells
        assert LINE.match(metric["layer"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    m = manifest()
    for w in m["workloads"]:
        e2e = [x["name"] for x in m["end_to_end"] if w["name"] in x.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in x["workloads"] for x in m["per_layer"])
