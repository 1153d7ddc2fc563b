"""TF-GridNet on the port's layered path (``models/tfgridnet.py`` over
``nn/core.LSTM`` and ``nn/blocks.GridNetBlock``) and through the offline
entry point, held on the CPU to the plain reference
``benchmark/reference/tfgridnet.py`` (LSTMs as cell loops, each clip alone
at its own length) at a small size: D 8, H 8, 2 heads, E 4, n_fft 32 (F 17),
hop 16, 2 blocks, clips of 20-60 frames, seeded weights.

Tolerance: 1e-5 relative.  Port and reference compute in float32 and
differ in the order of their sums (measured 3-5e-7); a mask left out of
the entry point's path moves a clip by 1e-2 or more.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import tfgridnet as ref
from gtcrn_micro_tpu_torch.eval import infer
from gtcrn_micro_tpu_torch.io.wav import write_wav
from gtcrn_micro_tpu_torch.models.tfgridnet import TFGridNet, TFGridNetConfig
from gtcrn_micro_tpu_torch.nn.core import LSTM, Ctx
from gtcrn_micro_tpu_torch.utils import profiling

SMALL = dict(n_fft=32, hop_len=16, n_layers=2, lstm_hidden_units=8, attn_n_head=2,
             attn_approx_qk_dim=68, emb_dim=8)
C = ref.Config(**SMALL)
TOL = 1e-5
HOP = SMALL["hop_len"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def P():
    return ref.init_params(11, "cpu", C)


@pytest.fixture(scope="module")
def model(P):
    return TFGridNet.from_params(P, config=TFGridNetConfig(**SMALL), device="cpu")


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Five wavs of 20-60 frames: a batch of two lengths in the 64-frame
    bucket (one clip padded by a longer one), and two of one bucket shape."""
    root = tmp_path_factory.mktemp("tfgridnet_wavs")
    rng = np.random.default_rng(3)
    paths = []
    for i, n in enumerate([HOP * 20 + 5, HOP * 60 + 3, HOP * 33, HOP * 45 + 9, HOP * 27 + 11]):
        paths.append(str(root / f"c{i}.wav"))
        write_wav(paths[-1], 0.2 * rng.standard_normal(n), 16000)
    return paths


def _want(P, paths):
    from gtcrn_micro_tpu_torch.io.wav import read_wav

    return ref.offline_enhance(P, [read_wav(p)[0].astype(np.float32) for p in paths], "cpu", C)


def test_tree_is_espnets(P, model):
    assert list(model.state_dict()) == [k for k, _, _ in ref.leaf_specs(C)]
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: s for k, s, _ in ref.leaf_specs(C)}
    assert model.blocks[0].E == 4 and not model.causal and model.scale_by_std
    assert (model.stft_config.n_fft, model.stft_config.hop_len) == (32, 16)


def test_apply_matches_the_reference(P, model):
    spec = torch.randn(2, 17, 30, 2, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = model.apply(spec), ref.forward(P, spec, C)
    assert _rel(got, want) < TOL
    assert float(got[:, 0, :, 1].abs().max()) == float(got[:, -1, :, 1].abs().max()) == 0.0


def test_lengths_give_each_row_alone(P, model):
    """Rows of 30, 22 and 9 frames in one padded batch, each against the
    reference over its own frames; every frame past a row's length is zero."""
    spec = torch.randn(3, 17, 30, 2, generator=torch.Generator().manual_seed(2))
    lengths = torch.tensor([30, 22, 9])
    with torch.no_grad():
        got = model.apply(spec, lengths)
        for r, n in enumerate(lengths.tolist()):
            assert _rel(got[r : r + 1, :, :n], ref.forward(P, spec[r : r + 1, :, :n], C)) < TOL
            assert float(got[r, :, n:].abs().sum()) == 0.0


@pytest.mark.parametrize("lengths", [None, [12, 7, 3]], ids=["full", "lengths"])
def test_lstm_matches_the_cell_loop_in_both_directions(P, lengths):
    """``nn/core.LSTM`` against the reference's cell loop; with lengths each
    row's backward direction starts at the row's own last step."""
    lstm = LSTM(32, 8, bidirectional=True)
    p = "blocks.0.inter_rnn"
    lstm.load_state_dict({k[len(p) + 1 :]: v for k, v in P.items() if k.startswith(p + ".")})
    x = torch.randn(3, 12, 32, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = lstm(Ctx(), x, None if lengths is None else torch.tensor(lengths))
        for r, n in enumerate(lengths or [12] * 3):
            xr = x[r : r + 1, :n]
            want = torch.cat([ref.lstm(P, p, xr), ref.lstm(P, p, xr, reverse=True)], dim=-1)
            assert _rel(got[r : r + 1, :n], want) < TOL
            assert float(got[r, n:].abs().sum()) == 0.0


def test_enhance_wavs_matches_each_clip_alone(P, model, clips):
    """Clip 0 (21 frames) shares its batch, and the 64-frame bucket, with
    clip 1 (61 frames); every clip equals the reference of that clip alone."""
    got = infer.enhance_wavs(model, clips, batch_size=2, device="cpu", progress=False)
    for path, want in zip(clips, _want(P, clips)):
        assert got[path].shape == want.shape
        assert _rel(got[path], want) < TOL, path


def test_batches_of_one_shape_at_other_lengths(P, model, clips):
    """Two batches of the same (rows, samples) shape whose clips differ in
    length each equal their clips alone."""
    want = dict(zip(clips, _want(P, clips)))
    for pair in ([clips[2], clips[3]], [clips[4], clips[0]]):
        got = infer.enhance_wavs(model, pair, batch_size=2, device="cpu", progress=False)
        for path in pair:
            assert _rel(got[path], want[path]) < TOL, path


def test_spans_and_the_frame_pairs_counter(model, clips):
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            infer.enhance_wavs(model, clips[:3], batch_size=2, device="cpu", progress=False)
        rec = profiling.recorded()
        names = [s.name for s in rec.spans if s.name.startswith("tfgridnet.")]
        # two batches, two blocks each
        assert {n: names.count(n) for n in set(names)} == {
            "tfgridnet.intra": 4, "tfgridnet.inter": 4, "tfgridnet.attn": 4}
        # both batches fill the 64-frame bucket: 2 rows and then 1
        assert rec.counters["infer.frame_pairs"] == 2 * 64 ** 2 + 1 * 64 ** 2
        assert rec.counters["infer.frames"] == sum(n // HOP + 1 for n in (325, 963, 528))
        with torch.no_grad():
            model.apply(torch.zeros(1, 17, 8, 2))
        assert len(profiling.recorded().spans) == len(rec.spans)  # profiler off: none
    finally:
        profiling.clear()


def test_registry_name_builds_through_the_infer_cli(tmp_path, P, clips):
    from gtcrn_micro_tpu_torch.io.wav import read_wav
    from gtcrn_micro_tpu_torch.models.registry import get_model

    model = get_model("tfgridnet", device="cpu", **SMALL)
    assert type(model) is TFGridNet
    noisy = tmp_path / "noisy"
    noisy.mkdir()
    (noisy / "a.wav").write_bytes(open(clips[0], "rb").read())
    ckpt = tmp_path / "params.npz"
    np.savez(ckpt, **{k.replace(".", "/"): v.numpy() for k, v in P.items()})
    widths = "".join(f"  {k}: {v}\n" for k, v in SMALL.items())
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"test_dataset:\n  noisy_dir: {noisy}\n"
                   f"network:\n  checkpoint: {ckpt}\n  enh_folder: {tmp_path / 'enh'}\n"
                   f"network_config:\n{widths}")
    infer.main(["-C", str(cfg), "--device", "cpu", "--model", "tfgridnet"])
    out, _ = read_wav(str(tmp_path / "enh" / "a_enh.wav"))
    want = _want(P, [str(noisy / "a.wav")])[0]
    np.testing.assert_allclose(out, want, atol=1 / 32768)

