"""A new configuration, cell and per-layer metric are added by adding files
and their entries in ``BENCHMARK.json``, with no edit to any other file."""

from __future__ import annotations

import json
import shutil

from benchmark.tests.conftest import run_cell


def test_new_files_are_found_by_name(tiny_root, capsys):
    bench = tiny_root / "benchmark"
    shutil.copy(bench / "configs" / "gtcrn_micro-serve-bf16.json",
                bench / "configs" / "gtcrn_micro-serve-bf16-b.json")
    cfg = json.loads((bench / "configs" / "gtcrn_micro-serve-bf16-b.json").read_text())
    cfg["name"] = "gtcrn_micro-serve-bf16-b"
    (bench / "configs" / "gtcrn_micro-serve-bf16-b.json").write_text(json.dumps(cfg))
    (bench / "cells" / "serve-light.json").write_text(json.dumps({
        "kind": "saturate", "batch": 8, "cohorts": 2, "pool_hops": 4, "sample_streams": 2,
        "warm_rounds": 1, "trace_seconds": 0.2, "limits": {"rel_err_max": 0.05}}))
    (bench / "metrics" / "serve.traced_steps.py").write_text(
        "def read(t):\n    return t.counters.get('steps') or None\n")
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "gtcrn_micro-serve-bf16-b", "source": "https://example.org",
                         "file": "benchmark/configs/gtcrn_micro-serve-bf16-b.json",
                         "reduced": [], "why": "a copy"})
    m["workloads"].append({"name": "serve-light", "config": "gtcrn_micro-serve-bf16-b",
                           "traffic": "saturate-2x8", "chips": 1, "why": "small"})
    next(x for x in m["end_to_end"] if x["name"] == "stream_capacity")["workloads"].append(
        "serve-light")
    m["per_layer"].append({"name": "serve.traced_steps", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "cohort scheduler",
                           "moves": "stream_capacity", "workloads": ["serve-light"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(m))

    plain = run_cell(tiny_root, "serve-light", capsys)
    assert plain["correct"] and set(plain["metrics"]) == {"stream_capacity", "setup_s"}
    traced = run_cell(tiny_root, "serve-light", capsys, trace=1)
    assert traced["correct"] and traced["metrics"]["serve.traced_steps"]["value"] > 0
    assert traced["metrics"]["serve.traced_steps"]["unit"] == "steps"


def test_a_missing_cell_gives_no_result(tiny_root, capsys):
    from benchmark import run

    (tiny_root / "benchmark" / "cells" / "serve-paced.json").unlink()
    assert run.main(["--workload", "serve-paced", "--seed", "1", "--seconds", "1"],
                    device="cpu", root=tiny_root) == 2
    assert capsys.readouterr().out == ""


def test_no_card_gives_no_result(tiny_root, capsys, monkeypatch):
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "serve-saturate", "--seed", "1", "--seconds", "1"],
                    root=tiny_root) == 2
    assert capsys.readouterr().out == ""
