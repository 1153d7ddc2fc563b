"""``eval/infer.enhance_wavs`` on the card, where each batch shape runs as a
replay of a CUDA graph, against the same call's eager path (``_enhance``
with no graphs), for each model class the entry point takes.

Marked ``cuda``: they need an NVIDIA GPU and skip elsewhere.  Run them on a
GPU host with ``python -m pytest --noconftest tests/test_torch_infer_cuda.py``.
Tolerance: relative 1e-6 a clip; a replay runs the kernels the eager path
launches, in the same order.
"""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gtcrn_micro_tpu_torch.eval import infer
from gtcrn_micro_tpu_torch.io.wav import write_wav
from gtcrn_micro_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

# 16 kHz wavs in the 128-, 256- and 1,024-frame buckets (two batches of the
# 128s at batch 3) and one at 8 kHz, which sends its batch to the card as
# float32
LENGTHS = [(24000, 16000), (30000, 16000), (31000, 16000), (20000, 16000),
           (50000, 16000), (160000, 16000), (14000, 8000)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    out = []
    for i, (n, fs) in enumerate(LENGTHS):
        t = np.arange(n) / fs
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t) + 0.05 * rng.standard_normal(n)
        out.append(str(root / f"w{i}.wav"))
        write_wav(out[-1], x, fs)
    return out


def _model(kind: str, dev):
    gen = torch.Generator().manual_seed(0)
    if kind == "gtcrn":
        from gtcrn_micro_tpu_torch.models.gtcrn import GTCRN, init_params

        return GTCRN.from_params(init_params(gen, device=dev), device=dev)
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, init_params

    model = GTCRNMicro.from_params(init_params(gen, device=dev), device=dev)
    if kind == "gtcrn_micro":
        return model
    from gtcrn_micro_tpu_torch.dsp.stft import sqrt_hann_window, stft
    from gtcrn_micro_tpu_torch.quant.ptq import make_quantized_model

    audio = torch.randn((4, 256 * 64), generator=torch.Generator().manual_seed(1)) * 0.3
    return make_quantized_model(model, stft(audio.to(dev), sqrt_hann_window(512, device=dev)))


def _eager(model, paths, dev):
    return infer._enhance(model, paths, 3, dev, False, None)


def _graphed(model, paths, dev):
    return infer.enhance_wavs(model, paths, batch_size=3, device=dev, progress=False)


def _assert_close(got, want, paths):
    for p in paths:
        assert got[p].shape == want[p].shape, p
        err = np.linalg.norm(got[p] - want[p]) / np.linalg.norm(want[p])
        assert err <= 1e-6, (p, err)


@pytest.mark.parametrize("kind", ["gtcrn_micro", "gtcrn", "quantized"])
def test_graphed_matches_eager_and_captures_once(dev, paths, kind):
    model = _model(kind, dev)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):  # the captures, counted
        first = _graphed(model, paths, dev)
    counters = profiling.recorded().counters
    shapes = set(infer._GRAPHS[model].replays)
    # 128 frames x 3 int16 and x 2 float32 (the 8 kHz wav's batch), 256 x 1, 1,024 x 1
    assert counters["infer.graph_captures"] == len(shapes) == 4
    # each shape's one batch ran as it came, its graph captured behind it
    assert counters["infer.frames_graphed"] == 0
    _assert_close(first, _eager(model, paths, dev), paths)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        again = _graphed(model, paths, dev)
    counters = profiling.recorded().counters
    profiling.clear()
    assert "infer.graph_captures" not in counters
    assert counters["infer.frames_graphed"] == counters["infer.frames_computed"]
    assert set(infer._GRAPHS[model].replays) == shapes
    for p in paths:
        np.testing.assert_array_equal(again[p], first[p])


def test_weights_changed_in_place_show(dev, paths):
    model = _model("gtcrn_micro", dev)
    before = _graphed(model, paths, dev)
    with torch.no_grad():
        for p in model.decoder.parameters():
            p.mul_(1.25)
    after = _graphed(model, paths, dev)
    assert any(not np.array_equal(after[p], before[p]) for p in paths)
    _assert_close(after, _eager(model, paths, dev), paths)


def test_weights_moved_are_captured_anew(dev, paths):
    model = _model("gtcrn_micro", dev)
    _graphed(model, paths, dev)
    old = infer._GRAPHS[model]
    with torch.no_grad():
        for p in model.decoder.parameters():
            p.data = p.data * 1.25  # new storage: the old graphs read the old one
    got = _graphed(model, paths, dev)
    assert infer._GRAPHS[model] is not old
    _assert_close(got, _eager(model, paths, dev), paths)


def test_graphs_are_freed_with_the_model(dev, paths):
    model = _model("gtcrn", dev)
    _graphed(model, paths, dev)
    graphs = weakref.ref(infer._GRAPHS[model])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    del model
    gc.collect()
    assert graphs() is None
    assert torch.cuda.memory_allocated(dev) < held


def test_calls_from_two_threads_on_one_model(dev, paths):
    model = _model("gtcrn_micro", dev)
    want = _graphed(model, paths, dev)
    got = [None, None]

    def call(i):
        got[i] = _graphed(model, paths, dev)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for out in got:
        for p in paths:
            np.testing.assert_array_equal(out[p], want[p])


def test_tfgridnet_replays_one_shape_at_other_lengths(dev, tmp_path):
    """TF-GridNet (not causal: each row carries its own length into the
    graph) at a small size: two batches of one shape whose clips differ in
    length, the second a replay of the first's graph, and a second call that
    replays both; each clip equals that clip enhanced alone."""
    from benchmark.reference import tfgridnet as ref
    from gtcrn_micro_tpu_torch.models.tfgridnet import TFGridNet, TFGridNetConfig

    small = dict(n_fft=32, hop_len=16, n_layers=2, lstm_hidden_units=8, attn_n_head=2,
                 attn_approx_qk_dim=68, emb_dim=8)
    model = TFGridNet.from_params(ref.init_params(11, dev, ref.Config(**small)),
                                  config=TFGridNetConfig(**small), device=dev)
    _replays_one_shape_at_other_lengths(model, dev, tmp_path)


def test_tflocoformer_replays_one_shape_at_other_lengths(dev, tmp_path):
    """TF-Locoformer (not causal; its residual stream along time zeroed past
    each row's length in the graph) as TF-GridNet above."""
    from benchmark.reference import tflocoformer as ref
    from gtcrn_micro_tpu_torch.models.tflocoformer import TFLocoformer, TFLocoformerConfig

    small = dict(n_fft=32, hop_len=16, n_layers=2, emb_dim=16, num_groups=4, n_heads=2,
                 attention_dim=16, ffn_hidden_dim=24)
    model = TFLocoformer.from_params(ref.init_params(11, dev, ref.Config(**small)),
                                     config=TFLocoformerConfig(**small), device=dev)
    _replays_one_shape_at_other_lengths(model, dev, tmp_path)


def _replays_one_shape_at_other_lengths(model, dev, tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    for i, frames in enumerate((20, 45, 33, 60)):  # every one in the 64-frame bucket
        paths.append(str(tmp_path / f"t{i}.wav"))
        write_wav(paths[-1], 0.2 * rng.standard_normal(16 * frames + 5), 16000)
    alone = {}
    for p in paths:
        alone.update(_eager(model, [p], dev))
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        first = infer.enhance_wavs(model, paths, batch_size=2, device=dev, progress=False)
    counters = profiling.recorded().counters
    profiling.clear()
    assert counters["infer.graph_captures"] == 1
    assert counters["infer.frames_graphed"] == 2 * 64  # the second batch, a replay
    again = _graphed(model, paths[::-1], dev)
    for p in paths:
        for got in (first[p], again[p]):
            err = np.linalg.norm(got - alone[p]) / np.linalg.norm(alone[p])
            assert err <= 1e-5, (p, err)
