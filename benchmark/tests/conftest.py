"""Fixtures of the benchmark's tests: a copy of the benchmark with tiny cells,
run on the CPU through the kernels' plain versions."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

# each cell cut to what a CPU test run holds; the drivers and checks are the
# cells' own
TINY = {
    "serve-saturate": {"batch": 16, "cohorts": 2, "sample_streams": 4, "trace_seconds": 0.2},
    "serve-paced": {"batch": 16, "cohorts": 2, "sample_streams": 4, "trace_seconds": 0.2},
    "train-dns3": {"pairs": 6, "crop_s": 1, "batch": 2, "num_workers": 2, "trace_seconds": 0.2},
    "offline-enhance": {"short_clips": 3, "short_s": [0.5, 1.0], "long_clips": 1, "long_s": 2.0,
                        "trace_seconds": 0.2},
}


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A checkout holding ``BENCHMARK.json`` with the entries of
    ``benchmark/pending_entries.json`` added, and ``benchmark/`` with every
    cell cut to :data:`TINY`."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    pending = json.loads((ROOT / "benchmark" / "pending_entries.json").read_text())
    for key in ("workloads", "end_to_end", "per_layer"):
        manifest[key] = pending[key] + manifest[key]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, cut in TINY.items():
        f = tmp_path / "benchmark" / "cells" / f"{name}.json"
        cell = json.loads(f.read_text())
        cell.update(cut)
        f.write_text(json.dumps(cell))
    return tmp_path


def run_cell(root: Path, name: str, capsys, seed: int = 3_000_000_019, trace: int = 0,
             seconds: float = 0.3, control: int = 0) -> dict:
    """Run one cell on the CPU; its result line."""
    from benchmark import run

    capsys.readouterr()
    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace), "--control", str(control)], device="cpu", root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def cuda():
    """Skip unless a CUDA device is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
