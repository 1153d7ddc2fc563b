"""The TF-GridNet cell (``offline-tfgridnet-long``) on the CPU at a small
size (D 8, H 8, 2 heads, n_fft 32, 2 blocks; clips of 30-70 frames, two of
other lengths in one padded batch): found by name, reporting its metrics,
correct when sound, and not correct under each fault planted in the masks
that keep bucket padding out of a clip (the attention's key mask dropped,
the GroupNorm's statistics taken over the padding); its work counts held to
the port's ``utils/complexity``; its readers on planted traces."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.tests.conftest import run_cell

CELL = "offline-tfgridnet-long"
TINY = {"short_clips": 2, "short_s": [0.03, 0.05], "long_clips": 1, "long_s": 0.07,
        "batch_size": 2, "trace_seconds": 0.2}
SMALL = {"n_fft": 32, "hop_len": 16, "win_len": 32, "n_freqs": 17, "n_layers": 2,
         "lstm_hidden_units": 8, "attn_n_head": 2, "attn_approx_qk_dim": 68,
         "attn_qk_channels": 4, "emb_dim": 8}
SIZES = dict(n_freqs=17, emb_dim=8, hidden=8, emb_ks=4, n_head=2, qk_dim=4, n_layers=2)


@pytest.fixture
def root(tiny_root):
    for sub, name, cut in (("cells", CELL, TINY), ("configs", "tfgridnet-f32", SMALL)):
        f = tiny_root / "benchmark" / sub / f"{name}.json"
        d = json.loads(f.read_text())
        d.update(cut)
        f.write_text(json.dumps(d))
    return tiny_root


def test_cell_reports_its_metrics(root, capsys):
    plain = run_cell(root, CELL, capsys)
    assert plain["correct"] and set(plain["metrics"]) == {"offline_audio_x", "setup_s"}
    assert plain["checks"]["rel_err_max"]["value"] < 1e-5
    traced = run_cell(root, CELL, capsys, trace=1)
    assert traced["correct"]
    # on the CPU the trace holds no device operations: only the padding
    # counter's reader finds something to read; on a card all report
    assert "offline.pad_frames_pct" in traced["metrics"]
    assert set(traced["metrics"]) <= {
        "tfgridnet.mfu_pct", "tfgridnet.attn_kernel_busy_pct", "tfgridnet.attn_roofline",
        "offline.idle_pct", "offline.idle_read_pct", "offline.idle_batch_pct",
        "offline.idle_launch_pct", "offline.pad_frames_pct", "offline.graph_frames_pct"}


def test_a_program_without_tfgridnet_fails_at_once(root, capsys, monkeypatch):
    from benchmark import run
    from gtcrn_micro_tpu_torch.models import registry

    monkeypatch.delitem(registry._REGISTRY, "tfgridnet")
    with pytest.raises(KeyError):
        run.main(["--workload", CELL, "--seed", "1", "--seconds", "0.3"], device="cpu",
                 root=root)
    assert capsys.readouterr().out == ""


def _fault(monkeypatch, fault: str) -> None:
    from gtcrn_micro_tpu_torch.nn import blocks

    if fault == "key_mask_dropped":
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def attention(q, k, v, attn_mask=None, **kw):
            return sdpa(q, k, v, **kw)

        monkeypatch.setattr(blocks.tF, "scaled_dot_product_attention", attention)
    else:  # statistics_over_padding
        orig = blocks.MaskedGroupNorm.forward

        def forward(self, x, frames=None):
            y = orig(self, x)
            if frames is None:
                return y
            live = torch.arange(x.shape[1])[None] < frames[:, None]
            return torch.where(live[:, :, None, None], y, 0.0)

        monkeypatch.setattr(blocks.MaskedGroupNorm, "forward", forward)


@pytest.mark.parametrize("fault", ["key_mask_dropped", "statistics_over_padding"])
def test_mask_faults_are_caught(root, capsys, monkeypatch, fault):
    _fault(monkeypatch, fault)
    out = run_cell(root, CELL, capsys)
    assert not out["correct"], out["checks"]


def test_work_counts_hold_to_the_ports_complexity():
    """``frame_macs`` at the published widths, and at a small size against
    ``utils/complexity``'s count of the forward over a clip of T frames,
    which runs the full-band BiLSTM and its transposed conv over T - 3
    windows a bin where ``frame_macs`` counts one a frame."""
    from benchmark import work_tfgridnet as w
    from benchmark.reference import tfgridnet as ref
    from gtcrn_micro_tpu_torch.models.tfgridnet import TFGridNet, TFGridNetConfig
    from gtcrn_micro_tpu_torch.utils.complexity import macs

    assert w.frame_macs(0) == 1_020_212_928
    assert w.frame_macs(7501) - w.frame_macs(0) == 49_536 * 7501
    assert w.attn_flops(1) == 99_072
    assert w.call_macs([3, 5]) == 3 * w.frame_macs(3) + 5 * w.frame_macs(5)
    small = {k: v for k, v in SMALL.items() if k not in ("win_len", "n_freqs", "attn_qk_channels")}
    c = ref.Config(**small)
    model = TFGridNet.from_params(ref.init_params(3, "cpu", c), config=TFGridNetConfig(**small),
                                  device="cpu")
    T, F, D, H, k = 20, 17, 8, 8, 4
    lacks = 2 * F * (k - 1) * (2 * 4 * H * (D * k + H) + 2 * H * D * k)
    assert macs(model.apply, torch.zeros(1, F, T, 2)) == T * w.frame_macs(T, **SIZES) - lacks
    assert w.sizes_of({**SMALL, "emb_ks": 4}) == SIZES


def _reader(name):
    from pathlib import Path

    from benchmark.run import load_module

    path = Path(__file__).resolve().parents[1] / "metrics" / f"{name}.py"
    return load_module(path, f"test_metric_{name}").read


def _trace(t0, t1, device_ops=(), counters=None, values=None, config=None):
    from benchmark.trace import Trace

    from benchmark.tests.conftest import ROOT

    published = json.loads((ROOT / "benchmark" / "configs" / "tfgridnet-f32.json").read_text())
    t = Trace(config or published, {})
    t.t0, t.t1, t.device_ops = t0, t1, list(device_ops)
    t.counters.update(counters or {})
    t.values.update(values or {})
    return t


ATTN = "fmha_cutlassF_f32_aligned_32x128_gmem_sm80(PyTorchMemEffAttention::AttentionKernel<float>)"


def test_mfu_reader_counts_the_clips_own_frames():
    from benchmark import work, work_tfgridnet

    t = _trace(0, 2_000_000_000, [("k", 0, 10)], {"calls": 3}, {"clip_frames": [2501, 7501]})
    want = 100 * 2 * work_tfgridnet.call_macs([2501, 7501]) * 3 / 2.0 / work.PEAK_FLOPS["f32"]
    assert _reader("tfgridnet.mfu_pct")(t) == pytest.approx(want)
    assert _reader("tfgridnet.mfu_pct")(_trace(0, 10, [("k", 0, 10)], {"calls": 0})) is None


def test_attention_readers_read_its_kernel_by_name(monkeypatch):
    from benchmark import work, work_tfgridnet
    from gtcrn_micro_tpu_torch.utils import profiling
    from gtcrn_micro_tpu_torch.utils.profiling import Recorded

    # busy [0, 30) conv, [40, 70) attention, [60, 90) gemm, [150, 160) attention
    t = _trace(0, 1_000_000, [("conv", 0, 30), (ATTN, 40, 70), ("gemm", 60, 90),
                              (ATTN, 150, 160)])
    assert _reader("tfgridnet.attn_kernel_busy_pct")(t) == pytest.approx(100 * 40 / 90)
    assert _reader("tfgridnet.attn_kernel_busy_pct")(_trace(0, 200, [("conv", 0, 30)])) is None
    monkeypatch.setattr(profiling, "recorded",
                        lambda: Recorded([], {"infer.frame_pairs": 4 * 4096 ** 2}))
    want = 100 * work_tfgridnet.attn_flops(4 * 4096 ** 2) / 40e-9 / work.PEAK_FLOPS["f32"]
    assert _reader("tfgridnet.attn_roofline")(t) == pytest.approx(want)
    assert _reader("tfgridnet.attn_roofline")(_trace(0, 200, [("conv", 0, 30)])) is None
    monkeypatch.setattr(profiling, "recorded", lambda: Recorded([], {}))
    assert _reader("tfgridnet.attn_roofline")(t) is None
