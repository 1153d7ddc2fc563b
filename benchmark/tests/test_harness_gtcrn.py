"""The GTCRN cell (``offline-gtcrn-long``) on the CPU at a tiny size: found
by name, reporting its metrics, correct when sound, and not correct under
each fault planted in GTCRN's recurrent layers (a TRA whose GRU does not
carry its hidden state from frame to frame, the intra GRU's backward
direction dropped, the LayerNorm taken over the channels only)."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.tests.conftest import run_cell

CELL = "offline-gtcrn-long"
TINY = {"short_clips": 2, "short_s": [0.5, 1.0], "long_clips": 1, "long_s": 1.5,
        "trace_seconds": 0.2}


@pytest.fixture
def root(tiny_root):
    f = tiny_root / "benchmark" / "cells" / f"{CELL}.json"
    cell = json.loads(f.read_text())
    cell.update(TINY)
    f.write_text(json.dumps(cell))
    return tiny_root


def test_cell_reports_its_metrics(root, capsys):
    plain = run_cell(root, CELL, capsys)
    assert plain["correct"] and set(plain["metrics"]) == {"offline_audio_x", "setup_s"}
    assert plain["checks"]["rel_err_max"]["value"] < 1e-5
    traced = run_cell(root, CELL, capsys, trace=1)
    assert traced["correct"]
    # on the CPU the trace holds no device operations, so only the padding
    # counter's reader finds something to read there; on a card they all
    # report (PERF.md)
    assert "offline.pad_frames_pct" in traced["metrics"]
    assert set(traced["metrics"]) <= {
        "gtcrn.mfu_pct", "gtcrn.rnn_busy_pct", "gtcrn.idle_rnn_pct", "offline.idle_pct",
        "offline.idle_read_pct", "offline.idle_batch_pct", "offline.idle_launch_pct",
        "offline.pad_frames_pct"}


def test_a_program_without_gtcrn_fails_at_once(root, capsys, monkeypatch):
    from benchmark import run
    from gtcrn_micro_tpu_torch.models import registry

    monkeypatch.delitem(registry._REGISTRY, "gtcrn")
    with pytest.raises(KeyError):
        run.main(["--workload", CELL, "--seed", "1", "--seconds", "0.3"], device="cpu",
                 root=root)
    assert capsys.readouterr().out == ""


def _fault(monkeypatch, fault: str) -> None:
    from gtcrn_micro_tpu_torch.nn import blocks, core

    if fault == "tra_state_not_carried":
        orig = core.GRU.forward

        def forward(self, ctx, x, h=None):
            if self.hidden_size != 16:  # the TRAs' GRUs are the only ones of 16 units
                return orig(self, ctx, x, h)
            N, S, _ = x.shape
            y, _ = orig(self, ctx, x.reshape(N * S, 1, x.shape[-1]))
            return y.reshape(N, S, -1), y[:, 0].reshape(N, S, -1)[:, -1]

        monkeypatch.setattr(core.GRU, "forward", forward)
    elif fault == "intra_backward_dropped":
        orig = core.GRU.forward

        def forward(self, ctx, x, h=None):
            y, hn = orig(self, ctx, x, h)
            if self.bidirectional:
                H = self.hidden_size
                y = torch.cat([y[..., :H], torch.zeros_like(y[..., H:])], dim=-1)
            return y, hn

        monkeypatch.setattr(core.GRU, "forward", forward)
    else:  # layer_norm_over_channels
        def forward(self, x):
            mean = x.mean(dim=-1, keepdim=True)
            var = (x - mean).square().mean(dim=-1, keepdim=True)
            return (x - mean) * torch.rsqrt(var + self.eps) * self.gamma + self.beta

        monkeypatch.setattr(blocks.LayerNorm, "forward", forward)


@pytest.mark.parametrize("fault", ["tra_state_not_carried", "intra_backward_dropped",
                                   "layer_norm_over_channels"])
def test_gtcrn_faults_are_caught(root, capsys, monkeypatch, fault):
    _fault(monkeypatch, fault)
    out = run_cell(root, CELL, capsys)
    assert not out["correct"], out["checks"]


def test_work_counter_gives_gtcrns_counts():
    """The useful multiply-adds of a frame (work.py's way) and the dense
    count the port's ``utils/complexity`` takes (``tests/test_torch_gtcrn.py``
    holds the dense count to it)."""
    from benchmark import work_gtcrn

    assert work_gtcrn.frame_macs() == 362_236
    assert work_gtcrn.frame_macs(dense=True) == 451_664
