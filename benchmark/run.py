"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is looked up by name in
``BENCHMARK.json``; its configuration is ``benchmark/configs/<config>.json``,
its traffic parameters ``benchmark/cells/<cell>.json``, whose ``kind`` names
the driver ``benchmark/traffic/<kind>.py``; each per-layer metric is read by
``benchmark/metrics/<metric>.py``.  A new cell, configuration or metric is
added by adding those files and its entry, with no other edit.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` (with ``--trace 1``) and, last, ``checks``: each number
compared with its limit.  The checks are also the last lines on standard
error.  Exits 2 without a result when no CUDA device is present (or fewer
than the cell asks for), when a file of the cell is missing, or when JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()  # set-up is timed from here: imports and CUDA init count

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "gtcrn_micro_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`
    (compared whole: ``gtcrn_micro_tpu_torch`` is not ``gtcrn_micro_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class CellFiles:
    """A cell's entry and files, found by its name."""

    def __init__(self, root: Path, workload: str):
        manifest = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise FileNotFoundError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = cells[workload]
        self.manifest = manifest
        conf = {c["name"]: c for c in manifest["configs"]}[self.entry["config"]]
        self.config = json.loads((root / conf["file"]).read_text())
        self.dir = root / "benchmark"
        self.cell = json.loads((self.dir / "cells" / f"{workload}.json").read_text())
        self.driver = self.dir / "traffic" / f"{self.cell['kind']}.py"
        if not self.driver.exists():
            raise FileNotFoundError(self.driver)
        end = {m["name"] for m in manifest["end_to_end"]
               if "workloads" not in m or workload in m["workloads"]}
        self.end_to_end = [m for m in manifest["end_to_end"] if m["name"] in end]
        self.per_layer = [m for m in manifest["per_layer"]
                          if workload in m.get("workloads", [workload] if m["moves"] in end
                                               else [])]

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py", f"bench_metric_{metric}").read


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def result(files: CellFiles, outcome, trace_on: bool, device, count: int) -> dict:
    import torch

    units = {m["name"]: m["unit"] for m in files.manifest["end_to_end"] + files.manifest["per_layer"]}
    if trace_on:
        vals = {}
        for m in files.per_layer:
            v = files.reader(m["name"])(outcome.trace)
            if v is not None:
                vals[m["name"]] = v
    else:
        vals = dict(outcome.metrics, setup_s=outcome.setup_s)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": count, "memory_peak_bytes": outcome.memory_peak_bytes}
    out = {"correct": all(c.ok for c in outcome.checks), "attempted": outcome.attempted,
           "failed": outcome.failed,
           "metrics": {k: {"value": v, "unit": units[k]} for k, v in vals.items()},
           "device": dev}
    if trace_on:
        dev.update(busy_s=outcome.trace.busy_s, window_s=outcome.trace.window_s)
        out["breakdown"] = {"device_ops": outcome.trace.top_ops(),
                            "idle_gaps": outcome.trace.idle_gaps()}
    out["notes"] = outcome.notes
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return out


def main(argv=None, device=None, root=None) -> int:
    """Run the cell; returns the exit code.  ``device``: run there without
    the look for a card (tests on the CPU); ``root``: the checkout."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the control and the planted faults (calibration)")
    ns = ap.parse_args(argv)
    root = Path(root or os.getcwd())
    try:
        files = CellFiles(root, ns.workload)
    except (FileNotFoundError, KeyError, json.JSONDecodeError) as e:
        print(f"benchmark: cell {ns.workload!r} not found: {e}", file=sys.stderr)
        return 2
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))

    import torch

    chips = files.entry["chips"]
    device_given = device
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: the cell needs {chips} CUDA device(s), {n} present",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
        print(f"# card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
              file=sys.stderr, flush=True)
    device = torch.device(device)

    from benchmark.harness import Ctx

    ctx = Ctx(seed=ns.seed, seconds=ns.seconds, trace=bool(ns.trace), device=device,
              config=files.config, cell=files.cell, control=bool(ns.control),
              started=STARTED if device_given is None else time.perf_counter())
    driver = load_module(files.driver, f"bench_traffic_{files.cell['kind']}")
    outcome = driver.run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 2
    out = result(files, outcome, bool(ns.trace), device, chips)
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
