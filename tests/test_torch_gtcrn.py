"""GTCRN on the port's layered path (``models/gtcrn.py`` over ``nn/core.py``
and ``nn/blocks.py``), held on the CPU to the plain reference
``benchmark/reference/gtcrn_dpgrnn.py`` (every GRU written out as its cell)
at B = 2 and T = 24 frames, with seeded weights and BatchNorm statistics
from speech-like clips; and GTCRN-Micro's tree and state left as they were.

Tolerances: 1e-5 relative.  Port and reference compute in float32 and
differ only in the order of their sums (measured 2-3e-7), and a streamed
frame differs from the offline forward only in how cuDNN's sequence and
the one-step GRU cell order theirs; 1e-5 leaves room for a platform's
other summation order, and every planted fault reads above 1e-2.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import gtcrn as ref_micro
from benchmark.reference import gtcrn_dpgrnn as ref
from benchmark.run import load_module
from benchmark.trace import Trace
from gtcrn_micro_tpu_torch.models import gtcrn as gtcrn_mod
from gtcrn_micro_tpu_torch.models.gtcrn import GTCRN, RING_PERIOD
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, flatten, init_params
from gtcrn_micro_tpu_torch.nn.blocks import GRNN
from gtcrn_micro_tpu_torch.nn.core import GRU, Ctx
from gtcrn_micro_tpu_torch.utils import profiling
from gtcrn_micro_tpu_torch.utils.profiling import Recorded, Span

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TOL = 1e-5


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def P():
    return ref.init_params(7, CPU)


@pytest.fixture(scope="module")
def model(P):
    return GTCRN.from_params(ref.nest(P), device="cpu")


@pytest.fixture(scope="module")
def spec():
    return torch.randn(2, 257, 24, 2, generator=torch.Generator().manual_seed(1))


def test_tree_is_the_references_and_the_published_size(P):
    ours = flatten(gtcrn_mod.init_params(torch.Generator().manual_seed(0), device="cpu"))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in P.items()}
    trainable = sum(v.numel() for k, v in P.items() if ref.is_trainable(k))
    erb = P["erb.bm_w"].numel() + P["erb.bs_w"].numel()
    assert trainable == 23_669
    assert trainable + erb == 48_245  # upstream's 48.2 K counts the frozen ERB filters


@pytest.mark.parametrize("training", [False, True])
def test_apply_matches_the_reference(P, model, spec, training):
    with torch.no_grad():
        got = model.apply(spec, training=training)
        want = ref.forward(P, spec, training=training)
    if training:
        (got, stats), (want, ref_stats) = got, want
        for path in ("encoder/en0/bn", "decoder/de1/depth_bn", "decoder/de4/bn"):
            np.testing.assert_allclose(stats[f"{path}/batch_var"],
                                       ref_stats[path.replace("/", ".")][1], rtol=TOL)
    assert _rel(got, want) < TOL
    assert _rel(got, spec) > 0.1  # the mask is far from the identity


def test_streamed_frames_match_apply(model, spec):
    """One frame a step from zero state: 24 frames, so the 10-frame rings of
    the d = 5 convs wrap twice; every GRU carries its hidden state."""
    with torch.no_grad():
        want = model.apply(spec)
    state = model.init_state(2)
    assert {k for k in state if k.endswith("/h")} == (
        {f"{s}/tra/h" for s in ("encoder/en2", "encoder/en3", "encoder/en4", "decoder/de0",
                                "decoder/de1", "decoder/de2")} | {"dpgrnn1/h", "dpgrnn2/h"})
    assert state["dpgrnn1/h"].shape == (2, 33, 16) and state["encoder/en4/tra/h"].shape == (2, 16)
    assert state["encoder/en4/depth_conv/ring"].shape == (2, 10, 33, 16)
    assert state["decoder/de0/depth_conv/ring"].shape == (2, 10, 33, 16)
    got, state = model.scan_frames(state, spec)
    assert state["step"] == 24
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("T,ring", [(2, True), (4, True), (8, True), (3, False)])
def test_chunks_match_apply(model, spec, T, ring):
    """Ring chunks of 2 and 4 frames cross the 10-frame rings' end (read and
    written by index); of 8, the d = 5 convs keep shift context; shift state
    takes any chunk."""
    n = 24 // T * T
    with torch.no_grad():
        want = model.apply(spec[:, :, :n])
    state = model.init_state(2, ring=ring)
    outs = []
    for t in range(0, n, T):
        y, state = model.step(state, spec[:, :, t:t + T])
        outs.append(y)
    assert _rel(torch.cat(outs, dim=2), want) < TOL
    if ring:
        assert state["step"] == n % RING_PERIOD


@pytest.mark.parametrize("T", [2, 4])
def test_tensor_counter_indexes_rings_as_the_int_counter(model, spec, T):
    """An exported program's counter is a 0-d tensor: its chunks read and
    write the 10-frame rings' slabs across the ring's end (start 8, T = 4:
    slots 8, 9, 0, 1) exactly as the int counter's do."""
    n = 24 // T * T
    outs = {}
    for kind in (int, torch.tensor):
        state = model.init_state(2)
        state["step"] = kind(0)
        ys = []
        for t in range(0, n, T):
            y, state = model.step(state, spec[:, :, t:t + T])
            ys.append(y)
        assert int(state["step"]) == n % RING_PERIOD
        outs[kind] = (torch.cat(ys, dim=2), state)
    (y_int, s_int), (y_tensor, s_tensor) = outs[int], outs[torch.tensor]
    assert torch.equal(y_tensor, y_int)
    assert all(torch.equal(s_tensor[k], s_int[k]) for k in s_int if k != "step")


def test_ring_counter_runs_modulo_80(model, spec):
    state = model.init_state(1)
    for _ in range(81):
        _, state = model.step(state, spec[:1, :, :1])
    assert RING_PERIOD == 80 and state["step"] == 1


def test_grouped_bidirectional_gru_matches_the_written_out_cell():
    """GRNN (two GRUs of 4 units a direction over halves of 16 channels)
    against the reference's cell loop, and a GRU's one-step path (the cell)
    against its sequence path (cuDNN on a card) frame by frame."""
    torch.manual_seed(3)
    grnn = GRNN(16, 8, bidirectional=True)
    x = torch.randn(5, 33, 16)
    with torch.no_grad():
        got, _ = grnn(Ctx(), x)
    P = {f"rnn{g}.{k}": v.detach() for g in (1, 2)
         for k, v in getattr(grnn, f"rnn{g}").named_parameters()}
    want = torch.cat([ref.gru(P, f"rnn{g}", x[..., 8 * (g - 1):8 * g], reverse=r)
                      for g in (1, 2) for r in (False, True)], dim=-1)
    assert got.shape == (5, 33, 16) and _rel(got, want) < TOL

    gru = GRU(8, 16)
    seq = torch.randn(3, 12, 8)
    h0 = torch.randn(3, 16)
    with torch.no_grad():
        y_seq, h_seq = gru(Ctx(), seq, h0)
        h, steps = h0, []
        for s in range(12):
            y, h = gru(Ctx(), seq[:, s:s + 1], h)
            steps.append(y)
    assert _rel(torch.cat(steps, dim=1), y_seq) < TOL and _rel(h, h_seq) < TOL
    assert torch.equal(y_seq[:, -1], h_seq)


def test_gtcrn_micro_tree_and_state_are_unchanged():
    """GTCRN-Micro's 342 leaves keep their paths (its reference's tree) and
    its ring state keeps its 20 keys and the mod-16 counter."""
    micro = GTCRNMicro.from_params(init_params(device="cpu"), device="cpu")
    paths = set(flatten(micro.params()))
    want = {p for p, _, _ in ref_micro.leaf_specs()} | {"erb.bm_w", "erb.bs_w"}
    assert len(paths) == 342 and paths == want
    state = micro.init_state(2)
    rings = ([f"encoder/en{i}/{m}/ring" for i in (2, 3, 4) for m in ("depth_conv", "tra")]
             + [f"decoder/de{i}/{m}/ring" for i in (0, 1, 2) for m in ("depth_conv", "tra")]
             + [f"gtcn{s}/block{j}/conv2/ring" for s in (1, 2) for j in range(4)])
    assert set(state) == set(rings) | {"step"}
    assert state["gtcn2/block3/conv2/ring"].shape == (2, 16, 33, 16)
    spec = torch.randn(2, 257, 17, 2, generator=torch.Generator().manual_seed(4))
    _, state = micro.scan_frames(state, spec)
    assert state["step"] == 1


def test_spans_record_only_under_the_profiler(model, spec):
    profiling.clear()
    try:
        with torch.no_grad():
            model.apply(spec[:1, :, :4])
        assert profiling.recorded().spans == []
        with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
            model.apply(spec[:1, :, :4])
        names = [s.name for s in profiling.recorded().spans]
        assert sorted(set(names)) == ["gtcrn.inter", "gtcrn.intra", "gtcrn.tra"]
        assert (names.count("gtcrn.intra"), names.count("gtcrn.inter"),
                names.count("gtcrn.tra")) == (2, 2, 6)
    finally:
        profiling.clear()


def test_complexity_counts_gtcrns_parameters_and_work(model):
    from benchmark import work_gtcrn
    from gtcrn_micro_tpu_torch.utils.complexity import main, model_complexity

    n_params, n_macs = model_complexity(model)
    assert n_params == 23_669
    assert n_macs == 63 * work_gtcrn.frame_macs(dense=True) == 28_454_832
    assert main(["--model", "gtcrn", "--device", "cpu"]) == (23_669, 28_454_832)


@pytest.mark.parametrize("name,cls", [("gtcrn_micro", GTCRNMicro), ("gtcrn", GTCRN)])
def test_registry_names_build_through_serve_and_the_infer_cli(tmp_path, name, cls):
    from gtcrn_micro_tpu_torch.eval import infer
    from gtcrn_micro_tpu_torch.io.wav import read_wav, write_wav
    from gtcrn_micro_tpu_torch.serve import make_backend

    init = gtcrn_mod.init_params if name == "gtcrn" else init_params
    params = init(torch.Generator().manual_seed(5), device="cpu")
    backend = make_backend("layered", params, torch.float32, "cpu", model=name)
    assert type(backend) is cls
    if name == "gtcrn":
        with pytest.raises(ValueError):
            make_backend("grid", params, torch.float32, "cpu", model=name)

    noisy = tmp_path / "noisy"
    noisy.mkdir()
    wav = (np.random.default_rng(0).standard_normal(7000) * 0.1).astype(np.float32)
    write_wav(str(noisy / "a.wav"), wav, 16000)
    ckpt = tmp_path / "params.npz"
    np.savez(ckpt, **{k.replace(".", "/"): v.numpy() for k, v in flatten(params).items()})
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"test_dataset:\n  noisy_dir: {noisy}\n"
                   f"network:\n  checkpoint: {ckpt}\n  enh_folder: {tmp_path / 'enh'}\n")
    infer.main(["-C", str(cfg), "--device", "cpu", "--model", name])
    out, _ = read_wav(str(tmp_path / "enh" / "a_enh.wav"))
    want = infer.enhance_wavs(backend, [str(noisy / "a.wav")], device="cpu", progress=False)
    np.testing.assert_allclose(out, want[str(noisy / "a.wav")], atol=1 / 32768)


def test_audio_server_matches_the_references_streamed_forward(P):
    """``CohortServer(mode="audio")`` over the layered GTCRN, 24 hops from
    zero state, against the reference's forward over the same audio."""
    from benchmark import inputs
    from gtcrn_micro_tpu_torch.serve import CohortServer, make_backend

    B, hops = 3, 24
    audio = inputs.speech_like(B, hops * 256, torch.Generator().manual_seed(2), CPU)
    model = make_backend("layered", ref.nest(P), torch.float32, "cpu", model="gtcrn")
    srv = CohortServer(model, None, batch=B, n_cohorts=1, dtype=torch.float32, mode="audio",
                       device="cpu")
    got = torch.cat([srv.step(0, audio[:, 256 * n:256 * (n + 1)]) for n in range(hops)], dim=1)
    assert _rel(got, ref.stream_enhance(P, audio)) < TOL
    srv.reset_slot(0, 1)
    assert float(srv.slot_absmax(0, 1)) == 0.0


# -- the benchmark's readers of the GTCRN spans ------------------------------


def _reader(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", f"test_metric_{name}").read


def _trace(t0, t1, device_ops=(), counters=None, config=None):
    t = Trace(config or {}, {})
    t.t0, t.t1, t.device_ops = t0, t1, list(device_ops)
    t.counters.update(counters or {})
    return t


def _call(monkeypatch):
    """One offline call [0, 100) ns: forward [10, 90) holding intra [20, 30),
    inter [30, 50) and tra [60, 70)."""
    spans = [Span("gtcrn.intra", 20, 30, 4, 5), Span("gtcrn.inter", 30, 50, 4, 5),
             Span("gtcrn.tra", 60, 70, 4, 5), Span("infer.read", 0, 10, 5, 5),
             Span("infer.forward", 10, 90, 5, 5), Span("infer.call", 0, 100, None, 5)]
    monkeypatch.setattr(profiling, "recorded", lambda: Recorded(spans, {}))


def test_rnn_readers_split_busy_and_idle_time(monkeypatch):
    _call(monkeypatch)
    # busy [25, 35), [45, 65) and [80, 100): 50 ns, of which 10 + 5 + 5 inside
    # the GRU spans; idle inside them: [20, 25), [35, 45), [65, 70) = 20 ns
    t = _trace(0, 200, [("k", 25, 35), ("k", 45, 65), ("k", 80, 100)])
    assert _reader("gtcrn.rnn_busy_pct")(t) == pytest.approx(100 * 20 / 50)
    assert _reader("gtcrn.idle_rnn_pct")(t) == pytest.approx(100 * 20 / 200)
    assert _reader("gtcrn.rnn_busy_pct")(_trace(0, 200)) is None  # nothing on the device
    monkeypatch.setattr(profiling, "recorded", lambda: Recorded([], {}))
    assert _reader("gtcrn.rnn_busy_pct")(t) is None
    assert _reader("gtcrn.idle_rnn_pct")(t) is None


def test_rnn_kernel_reader_reads_the_gru_kernel_by_name():
    """The GRU kernel's device time over the window's busy time, with or
    without the program's spans; None where no GRU kernel ran."""
    gru = "void RNN_blockPersist_fp_GRU<float, float, float, 32>(float const*, float*)"
    t = _trace(0, 200, [("conv", 0, 30), (gru, 40, 70), ("gemm", 60, 90), (gru, 150, 160)])
    assert _reader("gtcrn.rnn_kernel_busy_pct")(t) == pytest.approx(100 * 40 / 90)
    assert _reader("gtcrn.rnn_kernel_busy_pct")(_trace(0, 200, [("conv", 0, 30)])) is None
    assert _reader("gtcrn.rnn_kernel_busy_pct")(_trace(0, 200)) is None


def test_mfu_reader_counts_the_clips_own_frames():
    from benchmark import work, work_gtcrn

    t = _trace(0, 2_000_000_000, [("k", 0, 10)], {"calls": 3, "frames_per_call": 50_024},
               {"peak": "f32"})
    want = 100 * 2 * work_gtcrn.frame_macs() * 50_024 * 3 / 2.0 / work.PEAK_FLOPS["f32"]
    assert _reader("gtcrn.mfu_pct")(t) == pytest.approx(want)
    assert _reader("gtcrn.mfu_pct")(_trace(0, 10, [("k", 0, 10)], {"calls": 0})) is None
