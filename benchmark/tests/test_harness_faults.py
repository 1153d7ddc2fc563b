"""Each cell, driven through the rest of a run on the CPU with its timed path
broken underneath, comes out not correct: once for each fault the cell can
have (a step that returns its state unchanged; half of the batch left out;
an answer altered where it is produced).  One chip, so no exchange between
chips to leave out."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests.conftest import run_cell

SERVED = ("serve-saturate", "serve-paced")


def _serve_fault(monkeypatch, fault: str) -> None:
    from gtcrn_micro_tpu_torch import serve

    orig = serve.CohortServer.step

    def step(self, cohort, frame):
        if fault == "state_unchanged":
            saved = [{k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
                     for s in self._states[cohort]]
            out = orig(self, cohort, frame)
            for s, old in zip(self._states[cohort], saved):
                for k, v in old.items():
                    if torch.is_tensor(v):
                        s[k].copy_(v)
                    else:
                        s[k] = v
            return out
        out = orig(self, cohort, frame)
        if fault == "half_batch":
            out[out.shape[0] // 2:] = 0
        else:
            out[:, :16] = -out[:, :16]
        return out

    monkeypatch.setattr(serve.CohortServer, "step", step)


@pytest.mark.parametrize("cell", SERVED)
def test_served_cells_are_correct_when_sound(tiny_root, capsys, cell):
    assert run_cell(tiny_root, cell, capsys)["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", SERVED)
def test_served_faults_are_caught(tiny_root, capsys, monkeypatch, cell, fault):
    _serve_fault(monkeypatch, fault)
    assert not run_cell(tiny_root, cell, capsys)["correct"]


def _train_fault(monkeypatch, fault: str) -> None:
    from gtcrn_micro_tpu_torch.train import trainer

    if fault == "state_unchanged":
        monkeypatch.setattr(trainer.Adam, "step", lambda self: None)
        return
    orig = trainer.make_train_step

    def make(*args, **kwargs):
        step = orig(*args, **kwargs)

        def broken(noisy, clean):
            if fault == "half_batch":
                half = noisy.shape[0] // 2
                return step(noisy[:half], clean[:half])
            return step(noisy, clean) * 1.01

        return broken

    monkeypatch.setattr(trainer, "make_train_step", make)


def test_training_is_correct_when_sound(tiny_root, capsys):
    assert run_cell(tiny_root, "train-dns3", capsys)["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_training_faults_are_caught(tiny_root, capsys, monkeypatch, fault):
    _train_fault(monkeypatch, fault)
    assert not run_cell(tiny_root, "train-dns3", capsys)["correct"]


def _offline_fault(monkeypatch, fault: str) -> None:
    from gtcrn_micro_tpu_torch.eval import infer
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro

    if fault == "half_batch":
        orig_apply = GTCRNMicro.apply

        def apply(self, spec, *a, **k):
            out = orig_apply(self, spec, *a, **k)
            half = (spec.shape[0] + 1) // 2
            return torch.cat([out[:half], spec[half:]])

        monkeypatch.setattr(GTCRNMicro, "apply", apply)
        return
    orig = infer.enhance_wavs

    def enhance(*a, **k):
        out = orig(*a, **k)
        for y in out.values():
            y[:256] = -y[:256]
        return out

    monkeypatch.setattr(infer, "enhance_wavs", enhance)


def test_offline_is_correct_when_sound(tiny_root, capsys):
    assert run_cell(tiny_root, "offline-enhance", capsys)["correct"]


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_offline_faults_are_caught(tiny_root, capsys, monkeypatch, fault):
    _offline_fault(monkeypatch, fault)
    assert not run_cell(tiny_root, "offline-enhance", capsys)["correct"]
