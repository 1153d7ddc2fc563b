"""The port's spans and counters (``utils/profiling.span``, ``count``,
``recorded``) in the served step and the offline entry point, and the
benchmark's per-layer readers of them, on the CPU.

Spans record only under ``torch.profiler``; each is also a range of the
profiler's trace, and both carry the profiler's clock (Unix nanoseconds), so
a span lies within 50 us of its range.  The readers are held to hand-made
traces and records.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.run import load_module
from benchmark.trace import Trace
from gtcrn_micro_tpu_torch.dsp.stft import StftConfig
from gtcrn_micro_tpu_torch.eval.infer import FS, enhance_wavs
from gtcrn_micro_tpu_torch.io.wav import write_wav
from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params
from gtcrn_micro_tpu_torch.ops.fused_step import LayoutGTCRNMicro
from gtcrn_micro_tpu_torch.serve import CohortServer
from gtcrn_micro_tpu_torch.utils import profiling
from gtcrn_micro_tpu_torch.utils.profiling import Recorded, Span

ROOT = Path(__file__).resolve().parent.parent
CLOCK_NS = 50_000
STEP_PARTS = ("serve.stft", "serve.model", "serve.istft")


@pytest.fixture
def record():
    profiling.clear()
    yield
    profiling.clear()


def _profiled(fn, acts=(ProfilerActivity.CPU,)):
    """The host events of ``fn()`` under ``torch.profiler``."""
    with profile(activities=list(acts)) as prof:
        fn()
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() != torch.autograd.DeviceType.CUDA]


def _assert_on_the_profilers_clock(spans, events) -> int:
    """Each span within CLOCK_NS of the profiler's range of the same name,
    matched in order of start; returns the largest offset in ns."""
    worst = 0
    for name in {s.name for s in spans}:
        ours = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        theirs = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                        if e.name() == name)
        assert len(ours) == len(theirs), name
        for (a, b), (x, y) in zip(ours, theirs):
            worst = max(worst, abs(a - x), abs(b - y))
            assert abs(a - x) < CLOCK_NS and abs(b - y) < CLOCK_NS, (name, a - x, b - y)
    return worst


def _wavs(root, lengths) -> list:
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate(lengths):
        paths.append(str(root / f"clip_{i:03d}.wav"))
        write_wav(paths[-1], (rng.standard_normal(n) * 0.1).astype(np.float32), FS)
    return paths


def test_off_records_nothing_and_opens_no_range(record, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a range was opened with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    assert not torch.autograd._profiler_enabled() and not profiling.tracing()
    assert profiling.span("a") is profiling.span("b", request=3)
    with profiling.span("a"), profiling.span("b"):
        profiling.count("c", 5)
    assert profiling.recorded() == Recorded([], {})


@pytest.mark.parametrize("dft,shards", [("mxu", 1), ("fft", 1), ("mxu", 2)])
def test_served_step_spans(record, dft, shards):
    params = init_params(torch.Generator().manual_seed(0), device="cpu")
    model = LayoutGTCRNMicro(params, dtype=torch.float32, device="cpu")
    place = {"mesh": ["cpu"] * shards} if shards > 1 else {"device": "cpu"}
    srv = CohortServer(model, params, batch=4, n_cohorts=2, dtype=torch.float32, mode="audio",
                       dft=dft, **place)
    x = torch.randn((4, 256), generator=torch.Generator().manual_seed(1)) * 0.3
    srv.step(0, x)  # off: nothing recorded
    assert profiling.recorded().spans == []
    events = _profiled(lambda: [srv.step(c, x) for c in (0, 1, 0)])
    spans = profiling.recorded().spans
    roots = [i for i, s in enumerate(spans) if s.name == "serve.cohort_step"]
    assert [spans[i].request for i in roots] == [(0, 1), (1, 0), (0, 2)]
    assert all(spans[i].parent is None for i in roots)
    for i in roots:
        kids = [s for s in spans if s.parent == i]
        assert [s.name for s in kids] == list(STEP_PARTS) * shards
        assert all(s.request == spans[i].request for s in kids)
        assert all(spans[i].start_ns <= s.start_ns <= s.end_ns <= spans[i].end_ns for s in kids)
    assert len(spans) == 3 * (1 + 3 * shards)
    _assert_on_the_profilers_clock(spans, events)


class _Identity:
    """A model stand-in for ``enhance_wavs``: its output is its input, at
    GTCRN-Micro's STFT (the attributes the entry point reads of a model)."""

    device, dtype = torch.device("cpu"), torch.float32
    stft_config, window, causal, scale_by_std = StftConfig(), "sqrt_hann", True, False

    def apply(self, spec):
        return spec


def test_enhance_wavs_counts_the_offline_cells_frames(record, tmp_path):
    cell = json.loads((ROOT / "benchmark" / "cells" / "offline-enhance.json").read_text())
    lengths = ([int(FS * s) for s in np.linspace(*cell["short_s"], cell["short_clips"])]
               + [int(FS * cell["long_s"])] * cell["long_clips"])
    paths = _wavs(tmp_path, lengths)
    call = lambda: enhance_wavs(_Identity(), paths, batch_size=cell["batch_size"],  # noqa: E731
                                device="cpu", progress=False)
    plain = call()
    events = _profiled(call)
    rec = profiling.recorded()
    # frame pairs: rows x bucket frames squared, 7 x 128^2 + 25 x 256^2 + 16 x 1,024^2
    assert rec.counters == {"infer.frames": 15_530, "infer.frames_computed": 23_680,
                            "infer.frame_pairs": 18_530_304}
    assert sum(len(x) // 256 + 1 for x in plain.values()) == 15_530
    spans = rec.spans
    (root,) = [i for i, s in enumerate(spans) if s.name == "infer.call"]
    names = [s.name for s in spans if s.parent == root]
    # the headers, then each batch read, assembled and enqueued before the
    # batch ahead of it is trimmed
    batch = ["infer.read", "infer.batch", "infer.forward"]
    assert names == ["infer.read"] + batch + (batch + ["infer.batch"]) * 6 + ["infer.batch"]
    assert len(spans) == 2 + 4 * 7 and {s.request for s in spans} == {spans[root].request}
    _assert_on_the_profilers_clock(spans, events)


def test_cpu_enhance_wavs_counts_no_graphed_frames(record, tmp_path):
    """Off a card no batch runs as a graph: neither graph counter appears, so
    ``offline.graph_frames_pct`` reads nothing there."""
    paths = _wavs(tmp_path, [FS, FS * 2])
    with profile(activities=[ProfilerActivity.CPU]):
        enhance_wavs(_Identity(), paths, device="cpu", progress=False)
    counters = profiling.recorded().counters
    assert counters["infer.frames_computed"] == 64 + 128  # one wav in each bucket
    assert not {"infer.frames_graphed", "infer.graph_captures"} & set(counters)
    assert _reader("offline.graph_frames_pct")(_trace(0, 1)) is None


# the model spans that open on the CPU (as on a card at a shape's first pass
# and its capture, never under replay): each block's, once a block a batch
MODEL_SPANS = {
    "tfgridnet": (dict(n_fft=32, hop_len=16, n_layers=2, lstm_hidden_units=8, attn_n_head=2,
                       attn_approx_qk_dim=68, emb_dim=8),
                  ("tfgridnet.intra", "tfgridnet.inter", "tfgridnet.attn")),
    "tflocoformer": (dict(n_fft=32, hop_len=16, n_layers=2, emb_dim=16, num_groups=4,
                          n_heads=2, attention_dim=16, ffn_hidden_dim=24),
                     ("tflocoformer.freq", "tflocoformer.time")),
}


@pytest.mark.parametrize("name", sorted(MODEL_SPANS))
def test_model_spans_open_on_the_cpu(record, tmp_path, name):
    """A model's block spans inside ``infer.forward``, in block order, each
    within CLOCK_NS of its profiler range."""
    from gtcrn_micro_tpu_torch.models.registry import get_model

    widths, names = MODEL_SPANS[name]
    model = get_model(name, device="cpu", **widths)
    paths = _wavs(tmp_path, [16 * 40, 16 * 55])  # one batch of two rows
    events = _profiled(lambda: enhance_wavs(model, paths, batch_size=2, device="cpu",
                                            progress=False))
    spans = profiling.recorded().spans
    (forward,) = [i for i, s in enumerate(spans) if s.name == "infer.forward"]
    assert [s.name for s in spans if s.parent == forward] == list(names) * widths["n_layers"]
    _assert_on_the_profilers_clock(spans, events)


@pytest.mark.cuda
def test_spans_on_the_cards_clock(record, tmp_path):
    """On the card: the served step over B2 and the offline call over the
    layered model record their spans within CLOCK_NS of the profiler's
    ranges, and no range has a copy among the device's operations (where the
    benchmark's trace would count it as device time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro

    dev = torch.device("cuda", 0)
    params = init_params(torch.Generator().manual_seed(0), device=dev)
    srv = CohortServer(None, params, batch=1024, n_cohorts=2, mode="audio", device=dev)
    x = (torch.randn((1024, 256), generator=torch.Generator().manual_seed(1)) * 0.3).to(dev)
    model = GTCRNMicro.from_params(params, device=dev)
    paths = _wavs(tmp_path, [FS * 2, FS * 3, FS * 10])

    def work():
        for i in range(40):
            srv.step(i % 2, x)
        torch.cuda.synchronize()
        enhance_wavs(model, paths, device=dev, progress=False)

    work()  # kernels built and loaded
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        work()
    events = list(prof.profiler.kineto_results.events())
    spans = profiling.recorded().spans
    assert len(spans) == 40 * 4 + 2 + 4 * 3
    on_device = {e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CUDA}
    assert not on_device & {s.name for s in spans}
    host = [e for e in events if e.device_type() != torch.autograd.DeviceType.CUDA]
    print(f"worst offset of a span from its profiler range: "
          f"{_assert_on_the_profilers_clock(spans, host)} ns over {len(spans)} spans")


# -- the benchmark's readers --------------------------------------------------


def _reader(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", f"test_metric_{name}").read


def _trace(t0, t1, device_ops=()):
    t = Trace({}, {})
    t.t0, t.t1, t.device_ops = t0, t1, list(device_ops)
    return t


def _rec(monkeypatch, spans, counters=None):
    monkeypatch.setattr(profiling, "recorded", lambda: Recorded(spans, counters or {}))


def _step(n, at, request):
    """One served step at ``at`` ns, its spans from index ``n`` (children
    first, as they close): 1,000 ns, of which the STFT takes 200, the model
    400 and the iSTFT 200."""
    return [Span("serve.stft", at + 100, at + 300, n + 3, request),
            Span("serve.model", at + 300, at + 700, n + 3, request),
            Span("serve.istft", at + 700, at + 900, n + 3, request),
            Span("serve.cohort_step", at, at + 1000, None, request)]


def test_serve_readers_split_the_steps_host_time(monkeypatch):
    late = _step(8, 50_000, (0, 1))  # after the window: not counted
    _rec(monkeypatch, _step(0, 1_000, (0, 0)) + _step(4, 3_000, (1, 0)) + late)
    t = _trace(0, 10_000)
    assert _reader("serve.host_dsp_ms")(t) == pytest.approx(400e-6)
    assert _reader("serve.host_model_ms")(t) == pytest.approx(400e-6)
    assert _reader("serve.host_glue_ms")(t) == pytest.approx(200e-6)
    assert _reader("serve.host_dsp_ms")(_trace(20_000, 40_000)) is None
    _rec(monkeypatch, [])
    assert _reader("serve.host_glue_ms")(t) is None


def _call(n, at):
    """One offline call at ``at`` ns, its spans from index ``n``, 100 ns long:
    read [0, 10), the call's own [10, 30) (a copy back), batch [30, 50),
    forward [50, 80), the call's own [80, 100)."""
    return [Span("infer.read", at, at + 10, n + 3, n + 3),
            Span("infer.batch", at + 30, at + 50, n + 3, n + 3),
            Span("infer.forward", at + 50, at + 80, n + 3, n + 3),
            Span("infer.call", at, at + 100, None, n + 3)]


def test_offline_readers_split_idle_time_over_the_spans(monkeypatch):
    _rec(monkeypatch, _call(0, 0) + _call(4, 500))  # the second call is after the window
    # busy [0, 5) and [60, 100): one gap runs [5, 60) through read, the call,
    # batch and into forward
    t = _trace(0, 200, [("k", 0, 5), ("k", 60, 90), ("k", 85, 100)])
    assert _reader("offline.idle_read_pct")(t) == pytest.approx(100 * 5 / 200)
    assert _reader("offline.idle_batch_pct")(t) == pytest.approx(100 * 20 / 200)
    assert _reader("offline.idle_launch_pct")(t) == pytest.approx(100 * 10 / 200)
    idle = 100 * (1 - t.busy_s / t.window_s)  # offline.idle_pct: the call's own and the rest
    assert idle == pytest.approx(100 * (55 + 100) / 200)
    assert _reader("offline.idle_launch_pct")(_trace(300, 450, [("k", 300, 310)])) is None
    assert _reader("offline.idle_read_pct")(_trace(0, 200)) is None  # nothing on the device


def test_pad_frames_reader(monkeypatch):
    _rec(monkeypatch, [], {"infer.frames": 15_530, "infer.frames_computed": 23_680})
    assert _reader("offline.pad_frames_pct")(_trace(0, 1)) == pytest.approx(34.4172, abs=1e-4)
    _rec(monkeypatch, [])
    assert _reader("offline.pad_frames_pct")(_trace(0, 1)) is None


@pytest.mark.parametrize("graphed,want", [(23_680, 100.0), (0, 0.0), (None, None)])
def test_graph_frames_reader(monkeypatch, graphed, want):
    counters = {"infer.frames": 15_530, "infer.frames_computed": 23_680}
    if graphed is not None:
        counters["infer.frames_graphed"] = graphed
    _rec(monkeypatch, [], counters)
    assert _reader("offline.graph_frames_pct")(_trace(0, 1)) == want
