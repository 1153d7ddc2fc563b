"""The TF-Locoformer cell (``offline-tflocoformer-long``) on the CPU at a
small size (C 16, FFN 24, 2 heads of 8, n_fft 32, 2 blocks; clips of 30-70
frames, two of other lengths in one padded batch): found by name, reporting
its metrics, correct when sound, and not correct under each fault planted
in what keeps bucket padding out of a clip or in the rotary positions (the
time path's key mask dropped, the padded frames not zeroed before the time
path's first FFN, the rotary pairs taken as halves); its work counts held
to the port's ``utils/complexity``; its readers on planted traces."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.tests.conftest import run_cell

CELL = "offline-tflocoformer-long"
TINY = {"short_clips": 2, "short_s": [0.03, 0.05], "long_clips": 1, "long_s": 0.07,
        "batch_size": 2, "trace_seconds": 0.2}
SMALL = {"n_fft": 32, "hop_len": 16, "win_len": 32, "n_freqs": 17, "n_layers": 2,
         "emb_dim": 16, "num_groups": 4, "n_heads": 2, "attention_dim": 16,
         "ffn_hidden_dim": 24, "conv1d_kernel": 4}
SIZES = dict(n_freqs=17, emb_dim=16, ffn_hidden=24, kernel=4, attention_dim=16, n_layers=2)


@pytest.fixture
def root(tiny_root):
    for sub, name, cut in (("cells", CELL, TINY), ("configs", "tflocoformer-f32", SMALL)):
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
        "tflocoformer.mfu_pct", "tflocoformer.attn_kernel_busy_pct",
        "tflocoformer.attn_roofline", "offline.idle_pct", "offline.idle_read_pct",
        "offline.idle_batch_pct", "offline.idle_launch_pct", "offline.pad_frames_pct",
        "offline.graph_frames_pct"}


def test_a_program_without_tflocoformer_fails_at_once(root, capsys, monkeypatch):
    from benchmark import run
    from gtcrn_micro_tpu_torch.models import registry

    monkeypatch.delitem(registry._REGISTRY, "tflocoformer")
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
    elif fault == "padding_into_the_ffn":
        def forward(self, x, table, frames=None):
            # the block as it is, but the stream reaches the first FFN as
            # the frequency path left it past each row's frames
            keep = lambda y: y  # noqa: E731
            if frames is not None:
                live = (torch.arange(x.shape[1]) < frames[:, None])[:, :, None]
                keep = lambda y: torch.where(live, y, 0.0)  # noqa: E731
            x = keep(x + self.ffn[1](self.ffn_norm[1](x)))
            x = keep(x + self.attn(self.attn_norm(x), table, frames))
            return x + self.ffn[0](self.ffn_norm[0](x))

        monkeypatch.setattr(blocks.LocoformerBlock, "forward", forward)
    else:  # rope_halves
        def rope(x, table):
            half = x.shape[-1] // 2
            a, b = x[..., :half], x[..., half:]
            turn = table.view(table.shape[0], *[1] * (x.dim() - 3), table.shape[1])
            cos, sin = turn.real, turn.imag
            return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)

        monkeypatch.setattr(blocks, "rope", rope)


@pytest.mark.parametrize("fault", ["key_mask_dropped", "padding_into_the_ffn", "rope_halves"])
def test_faults_are_caught(root, capsys, monkeypatch, fault):
    _fault(monkeypatch, fault)
    out = run_cell(root, CELL, capsys)
    assert not out["correct"], out["checks"]


def test_work_counts_hold_to_the_ports_complexity():
    """``frame_macs`` at the published widths, and at a small size against
    ``utils/complexity``'s count of the forward over a clip of T frames,
    which runs each FFN's convs over the S + 3 positions of its padded
    sequence where ``frame_macs`` counts S."""
    from benchmark import work_tflocoformer as w
    from benchmark.reference import tflocoformer as ref
    from gtcrn_micro_tpu_torch.models.tflocoformer import TFLocoformer, TFLocoformerConfig
    from gtcrn_micro_tpu_torch.utils.complexity import macs

    assert w.frame_macs(0) == 1_953_699_840
    assert w.frame_macs(7501) - w.frame_macs(0) == 198_144 * 7501
    assert w.attn_flops(1, 0) == 396_288 and w.attn_flops(0, 1) == 51_121_152
    assert w.call_macs([3, 5]) == 3 * w.frame_macs(3) + 5 * w.frame_macs(5)
    small = {k: v for k, v in SMALL.items() if k not in ("win_len", "n_freqs")}
    c = ref.Config(**small)
    model = TFLocoformer.from_params(ref.init_params(3, "cpu", c),
                                     config=TFLocoformerConfig(**small), device="cpu")
    T, F, C, H, k, L = 20, 17, 16, 24, 4, 2
    ffn = 3 * H * C * k
    extra = L * 2 * (k - 1) * ffn * (T + F)  # two FFNs a sequence, T along F, F along T
    assert macs(model.apply, torch.zeros(1, F, T, 2)) == T * w.frame_macs(T, **SIZES) + extra
    assert w.sizes_of(SMALL) == SIZES


def _reader(name):
    from pathlib import Path

    from benchmark.run import load_module

    path = Path(__file__).resolve().parents[1] / "metrics" / f"{name}.py"
    return load_module(path, f"test_metric_{name}").read


def _trace(t0, t1, device_ops=(), counters=None, values=None):
    from benchmark.tests.conftest import ROOT
    from benchmark.trace import Trace

    published = json.loads((ROOT / "benchmark" / "configs" / "tflocoformer-f32.json").read_text())
    t = Trace(published, {})
    t.t0, t.t1, t.device_ops = t0, t1, list(device_ops)
    t.counters.update(counters or {})
    t.values.update(values or {})
    return t


ATTN = "fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel<float>)"


def test_mfu_reader_counts_the_clips_own_frames():
    from benchmark import work, work_tflocoformer

    t = _trace(0, 2_000_000_000, [("k", 0, 10)], {"calls": 3}, {"clip_frames": [2501, 7501]})
    want = 100 * 2 * work_tflocoformer.call_macs([2501, 7501]) * 3 / 2.0 / work.PEAK_FLOPS["f32"]
    assert _reader("tflocoformer.mfu_pct")(t) == pytest.approx(want)
    assert _reader("tflocoformer.mfu_pct")(_trace(0, 10, [("k", 0, 10)], {"calls": 0})) is None


def test_attention_readers_read_its_kernels_by_name(monkeypatch):
    from benchmark import work, work_tflocoformer
    from gtcrn_micro_tpu_torch.utils import profiling
    from gtcrn_micro_tpu_torch.utils.profiling import Recorded

    # busy [0, 30) gemm, [40, 70) attention, [60, 90) gemm, [150, 160) attention
    t = _trace(0, 1_000_000, [("gemm", 0, 30), (ATTN, 40, 70), ("gemm", 60, 90),
                              (ATTN, 150, 160)])
    assert _reader("tflocoformer.attn_kernel_busy_pct")(t) == pytest.approx(100 * 40 / 90)
    assert _reader("tflocoformer.attn_kernel_busy_pct")(_trace(0, 200, [("g", 0, 30)])) is None
    counters = {"infer.frame_pairs": 4 * 4096 ** 2, "infer.frames_computed": 4 * 4096}
    monkeypatch.setattr(profiling, "recorded", lambda: Recorded([], counters))
    flops = work_tflocoformer.attn_flops(4 * 4096 ** 2, 4 * 4096)
    assert flops == 396_288 * 4 * 4096 ** 2 + 51_121_152 * 4 * 4096
    want = 100 * flops / 40e-9 / work.PEAK_FLOPS["f32"]
    assert _reader("tflocoformer.attn_roofline")(t) == pytest.approx(want)
    assert _reader("tflocoformer.attn_roofline")(_trace(0, 200, [("g", 0, 30)])) is None
    monkeypatch.setattr(profiling, "recorded", lambda: Recorded([], {}))
    assert _reader("tflocoformer.attn_roofline")(t) is None
