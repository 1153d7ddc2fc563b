"""On the card: each cell's control fails its own check, at a size a test run
holds (the served cells cut to 2 × 512 streams, the others at their own
size; the readings at every cell's own size come from ``--control 1`` runs).  The
control is the plain reference put in the program's place and computed in the
precision below the configuration's: float8 storage for the bf16 served
configuration, TF32 for the float32 one.

    python -m pytest benchmark/tests -m cuda
"""

from __future__ import annotations

import json

import pytest

from benchmark.run import main
from benchmark.tests.conftest import ROOT

SMALL = {"serve-saturate": {"batch": 512, "cohorts": 2},
         "serve-paced": {"batch": 512, "cohorts": 2},
         "train-dns3": {},  # the cell's own size: 2 GB and seconds on the card
         "offline-enhance": {}}


def _run(root, name, capsys) -> dict:
    cell = json.loads((ROOT / "benchmark" / "cells" / f"{name}.json").read_text())
    cell.update(SMALL[name])
    (root / "benchmark" / "cells" / f"{name}.json").write_text(json.dumps(cell))
    capsys.readouterr()
    assert main(["--workload", name, "--seed", "2147483659", "--seconds", "1", "--control", "1"],
                root=root) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return out, cell["limits"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["serve-saturate", "serve-paced", "offline-enhance"])
def test_served_and_offline_controls_fail(tiny_root, capsys, cuda, name):
    out, limits = _run(tiny_root, name, capsys)
    readings = out["notes"]["readings"]
    assert out["correct"]
    assert readings["control_rel_err_max"] > limits["rel_err_max"]


@pytest.mark.cuda
def test_training_control_and_half_batch_fault_fail(tiny_root, capsys, cuda):
    out, limits = _run(tiny_root, "train-dns3", capsys)
    readings = out["notes"]["readings"]
    assert out["correct"]
    for low in ("control_tf32", "fault_half_batch"):
        assert any(readings[low][k] > limits[k] for k in limits), low
