"""The reference-scale traversal's driver and snapshot
(``gtcrn_micro_tpu_torch/scripts/ref_scale_run.py``,
``ref_scale_snapshot.py``) held against the root scripts they port, which
are loaded by path.

- ``base_config`` at its defaults is the root script's recipe, verbatim.
- On a synthetic run directory (metrics past the warmup knee with a
  re-logged seam and a line cut short by a kill, whole checkpoints, one
  partial ``<step>/state.pt.tmp``, the best score, a driver log), the port's
  snapshot equals the root snapshot on every key but two recorded
  divergences: ``snapshot_unix`` (the clock) and
  ``checkpoint_steps_on_disk``, where the port counts whole checkpoints only
  (ROADMAP C); ``summarize`` agrees with it on the keys they share.
- With no ``logs/metrics.jsonl`` yet, the root snapshot raises
  ``FileNotFoundError``; the port writes a summary with
  ``final_logged_step`` 0 and exits 0.
- The driver for real on the CPU at a tiny horizon (1 s clips, batch 2,
  warmup 4, SIGKILL at step 5, ``log_every`` 1): one seam, the lr peak at
  step 4, the checkpoints and the best.
"""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

from gtcrn_micro_tpu_torch.scripts import ref_scale_run, ref_scale_snapshot
from gtcrn_micro_tpu_torch.train.scheduler import warmup_cosine_lr

ROOT = Path(__file__).resolve().parent.parent
EXP = "exp/ref_scale_2026-01-01-00h00m"


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_scripts_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synthetic_run(root: Path, metrics: bool = True) -> Path:
    """A run killed at logged step 25,300 and resumed from its checkpoint at
    25,000 (which re-logged 25,050-25,200), then killed again mid-line."""
    d = root / EXP
    ck = d / "checkpoints"
    for s in (24000, 25000, 26000):
        (ck / str(s)).mkdir(parents=True)
        (ck / str(s) / "state.pt").write_bytes(b"")
    (ck / "27000").mkdir()
    (ck / "27000" / "state.pt.tmp").write_bytes(b"")  # a SIGKILL during the save
    (ck / "best" / "25000").mkdir(parents=True)
    (ck / "best" / "25000" / "state.pt").write_bytes(b"")
    (ck / "best_score.json").write_text(json.dumps({"best_score": 2.5, "best_step": 25000}))
    if metrics:
        steps = list(range(24800, 25350, 50)) + list(range(25050, 25250, 50))
        lines = [json.dumps({"step": s, "time": 1.0 + i, "train_loss": 40.0 - i * 0.25,
                             "lr": warmup_cosine_lr(s)}) for i, s in enumerate(steps)]
        lines.insert(5, json.dumps({"step": 25000, "time": 5.5, "val_loss": 30.0,
                                    "val_score": 2.5, "epoch": 20}))
        lines.append('{"step": 25250, "ti')  # cut short by the kill
        (d / "logs").mkdir(parents=True)
        (d / "logs" / "metrics.jsonl").write_text("\n".join(lines) + "\n")
    return d


def _driver_log(path: Path) -> Path:
    path.write_text("corpus already present\nlaunch fresh run\n"
                    "  t=    100s run=1 step=25300 rss=  3.1 GB\n"
                    "SIGKILL (intentional seam) at logged step 25300\n"
                    "relaunch 2: resuming from checkpoint step 25000\n")
    return path


def _snapshots(tmp_path, monkeypatch, root, log):
    jsnap = _jax_script("ref_scale_snapshot")
    monkeypatch.setattr(sys, "argv", ["ref_scale_snapshot.py", "--root", str(root),
                                      "--driver-log", str(log), "--out", str(tmp_path / "jax")])
    assert jsnap.main() == 0
    assert ref_scale_snapshot.main(["--root", str(root), "--driver-log", str(log),
                                    "--out", str(tmp_path / "port")]) == 0
    return [json.loads((tmp_path / w / "summary.json").read_text()) for w in ("jax", "port")]


def test_base_config_is_the_root_recipe(tmp_path):
    jrun = _jax_script("ref_scale_run")
    assert ref_scale_run.base_config(str(tmp_path)) == jrun.base_config(str(tmp_path))
    assert (ref_scale_run.STEPS_PER_EPOCH, ref_scale_run.TOTAL_EPOCHS) == (
        jrun.STEPS_PER_EPOCH, jrun.TOTAL_EPOCHS)


def test_snapshot_and_summarize_equal_the_root_snapshot(tmp_path, monkeypatch):
    root = tmp_path / "run"
    d = _synthetic_run(root)
    log = _driver_log(tmp_path / "driver.log")
    want, got = _snapshots(tmp_path, monkeypatch, root, log)
    assert set(want) <= set(got)
    for k in want:
        if k == "snapshot_unix":
            continue
        if k == "checkpoint_steps_on_disk":  # the partial 27000 is not a checkpoint
            assert want[k] == [24000, 25000, 26000, 27000] and got[k] == [24000, 25000, 26000]
            continue
        assert got[k] == want[k], k
    assert got["final_logged_step"] == 25300 and got["lr_peak"][0] == 25000
    (seam,) = got["seam_continuity"]
    assert seam["resumed_at_step"] == 25050
    for name in ("metrics.jsonl", "driver_events.log"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()

    s = ref_scale_run.summarize(str(root))
    for k in ("exp_dir", "seam_continuity", "best", "lr_at_25000"):
        assert s[k] == want[k], k
    assert s["final_step"] == want["final_logged_step"]
    assert s["lr_peak_step"] == want["lr_peak"][0] == 25000
    assert s["lr_at_24950"] < s["lr_at_25000"] and s["lr_at_27500"] is None
    # the root driver's resume point counts every digit directory
    assert _jax_script("ref_scale_run").latest_ckpt_step(str(root)) == 27000
    assert max(ref_scale_run.checkpoint_steps(str(d))) == 26000


def test_snapshot_without_metrics(tmp_path, monkeypatch):
    root = tmp_path / "run"
    _synthetic_run(root, metrics=False)
    log = tmp_path / "absent.log"
    jsnap = _jax_script("ref_scale_snapshot")
    monkeypatch.setattr(sys, "argv", ["ref_scale_snapshot.py", "--root", str(root),
                                      "--driver-log", str(log), "--out", str(tmp_path / "jax")])
    with pytest.raises(FileNotFoundError):
        jsnap.main()
    assert ref_scale_snapshot.main(["--root", str(root), "--driver-log", str(log),
                                    "--out", str(tmp_path / "port")]) == 0
    got = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert got["final_logged_step"] == 0 and got["n_metric_records"] == 0
    assert got["lr_peak"] is None and got["seam_continuity"] == []
    assert got["best"] == {"best_score": 2.5, "best_step": 25000}
    assert not (tmp_path / "port" / "metrics.jsonl").exists()
    # no run at all: both say so and return 1
    monkeypatch.setattr(sys, "argv", ["ref_scale_snapshot.py", "--root", str(tmp_path / "none"),
                                      "--out", str(tmp_path / "jax2")])
    assert jsnap.main() == 1
    assert ref_scale_snapshot.main(["--root", str(tmp_path / "none"),
                                    "--out", str(tmp_path / "port2")]) == 1


def test_traversal_at_a_tiny_horizon_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the trainer's process, beside other tests
    root = tmp_path / "ref"
    rc = ref_scale_run.main(["--root", str(root), "--kill-at-step", "5", "--device", "cpu"],
                            clips=8, seconds=1.0, warmup=4, epochs=3, steps_per_epoch=4,
                            log_every=1, poll_s=0.05)
    out = capsys.readouterr().out
    assert rc == 0 and "SIGKILL (intentional seam)" in out
    s = json.loads((root / "summary.json").read_text())
    assert s["restarts"] == 1 and len(s["seam_continuity"]) == 1
    (seam,) = s["driver_seams"]
    assert seam["resumed_from_ckpt_step"] == 4 and 5 <= seam["killed_at_logged_step"] < 8
    assert s["seam_continuity"][0]["resumed_at_step"] == 5
    assert s["lr_peak_step"] == 4 and s["lr_at_3"] < s["lr_at_4"]
    lr = dict((r["step"], r["lr"]) for r in ref_scale_run.read_metrics(s["exp_dir"]) if "lr" in r)
    assert [lr[k] for k in (1, 2, 3, 4)] == sorted({lr[k] for k in (1, 2, 3, 4)})
    assert s["final_step"] == 12 and s["checkpoint_steps_on_disk"] == [4, 8, 12]
    assert s["best"] is not None and (root / "run2.yaml").exists()
    assert ref_scale_run.base_config(str(root), clips=8, steps_per_epoch=4)[
        "train_dataloader"]["batch_size"] == 2
