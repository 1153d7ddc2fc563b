"""TF-Locoformer on the port's layered path (``models/tflocoformer.py`` over
``nn/blocks.TFLocoformerBlock``) and through the offline entry point, held
on the CPU to the plain reference ``benchmark/reference/tflocoformer.py``
(each clip alone at its own length) at a small size: C 16, FFN 24, 2 heads
of 8, 4 groups, n_fft 32 (F 17), hop 16, 2 blocks, clips of 20-60 frames,
seeded weights; its rotary embedding and RMSGroupNorm against their
formulas, and its parameter count at the published widths.

Tolerance: 1e-5 relative.  Port and reference compute in float32 and
differ in the order of their sums (measured 3-4e-7); a mask left out of
the entry point's path moves a clip by 1e-2 or more.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import tflocoformer as ref
from gtcrn_micro_tpu_torch.eval import infer
from gtcrn_micro_tpu_torch.io.wav import read_wav, write_wav
from gtcrn_micro_tpu_torch.models.tflocoformer import TFLocoformer, TFLocoformerConfig
from gtcrn_micro_tpu_torch.nn.blocks import RMSGroupNorm
from gtcrn_micro_tpu_torch.nn.core import rope, rope_table
from gtcrn_micro_tpu_torch.utils import profiling

SMALL = dict(n_fft=32, hop_len=16, n_layers=2, emb_dim=16, num_groups=4, n_heads=2,
             attention_dim=16, ffn_hidden_dim=24)
C = ref.Config(**SMALL)
TOL = 1e-5
HOP = SMALL["hop_len"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Seeded weights, the model, and five wavs of 20-60 frames: a batch of
    two lengths in the 64-frame bucket (one clip padded by a longer one),
    and the reference's enhancement of each alone."""
    P = ref.init_params(11, "cpu", C)
    model = TFLocoformer.from_params(P, config=TFLocoformerConfig(**SMALL), device="cpu")
    root = tmp_path_factory.mktemp("tflocoformer_wavs")
    rng = np.random.default_rng(3)
    paths = []
    for i, n in enumerate([HOP * 20 + 5, HOP * 60 + 3, HOP * 33, HOP * 45 + 9, HOP * 27 + 11]):
        paths.append(str(root / f"c{i}.wav"))
        write_wav(paths[-1], 0.2 * rng.standard_normal(n), 16000)
    want = ref.offline_enhance(P, [read_wav(p)[0].astype(np.float32) for p in paths], "cpu", C)
    return P, model, paths, dict(zip(paths, want))


def test_tree_is_merls(setup):
    P, model, _, _ = setup
    assert list(model.state_dict()) == [k for k, _, _ in ref.leaf_specs(C)]
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: s for k, s, _ in ref.leaf_specs(C)}
    assert not model.causal and not model.scale_by_std and model.window == "hann"
    assert (model.stft_config.n_fft, model.stft_config.hop_len) == (32, 16)


def test_published_widths_count_its_parameters_and_work():
    """The medium model's 14,973,314 trainable parameters (the paper's
    15.0 M), with no rotary table among them; ``utils/complexity``'s count
    of its forward over 8 frames is the benchmark's frozen 1,953,699,840 +
    198,144 T a frame, plus each FFN's convs over the 3 padding positions at
    each end of a sequence (129 along time, 8 along frequency, two FFNs a
    path, six blocks)."""
    from benchmark import work_tflocoformer
    from gtcrn_micro_tpu_torch.models.registry import get_model
    from gtcrn_micro_tpu_torch.utils.complexity import macs, param_count

    model = get_model("tflocoformer", device="cpu")
    assert type(model) is TFLocoformer
    assert param_count(model.params()) == 14_973_314
    assert sum(math.prod(s) for _, s, _ in ref.leaf_specs()) == 14_973_314
    T = 8
    assert work_tflocoformer.frame_macs(T) == 1_953_699_840 + 198_144 * T
    padding = 6 * 2 * 3 * (3 * 384 * 128 * 4) * (129 + T)
    assert macs(model.apply, torch.zeros(1, 129, T, 2)) == (
        T * work_tflocoformer.frame_macs(T) + padding)


def test_apply_matches_the_reference(setup):
    P, model, _, _ = setup
    spec = torch.randn(2, 17, 30, 2, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = model.apply(spec), ref.forward(P, spec, C)
    assert _rel(got, want) < TOL
    assert float(got[:, 0, :, 1].abs().max()) == float(got[:, -1, :, 1].abs().max()) == 0.0


def test_lengths_give_each_row_alone(setup):
    """Rows of 30 and 13 frames in one padded batch, each against the
    reference over its own frames; every frame past a row's length is zero."""
    P, model, _, _ = setup
    spec = torch.randn(2, 17, 30, 2, generator=torch.Generator().manual_seed(2))
    lengths = torch.tensor([30, 13])
    with torch.no_grad():
        got = model.apply(spec, lengths)
        for r, n in enumerate(lengths.tolist()):
            assert _rel(got[r : r + 1, :, :n], ref.forward(P, spec[r : r + 1, :, :n], C)) < TOL
            assert float(got[r, :, n:].abs().sum()) == 0.0


def test_chunks_of_sequences_change_nothing(setup, monkeypatch):
    """A path over its sequences in chunks of 70 positions (four frames'
    bins, two bins' frames; row lengths split across chunks) as in one."""
    from gtcrn_micro_tpu_torch.nn import blocks

    _, model, _, _ = setup
    spec = torch.randn(3, 17, 30, 2, generator=torch.Generator().manual_seed(8))
    lengths = torch.tensor([30, 22, 9])
    with torch.no_grad():
        whole = model.apply(spec, lengths)
        monkeypatch.setattr(blocks, "LOCO_POSITIONS", 70)
        assert _rel(model.apply(spec, lengths), whole) < 1e-6


def test_enhance_wavs_matches_each_clip_alone(setup):
    """Clip 0 (21 frames) shares its batch, and the 64-frame bucket, with
    clip 1 (61 frames); every clip equals the reference of that clip alone."""
    _, model, paths, want = setup
    got = infer.enhance_wavs(model, paths, batch_size=2, device="cpu", progress=False)
    for path in paths:
        assert got[path].shape == want[path].shape
        assert _rel(got[path], want[path]) < TOL, path


@pytest.mark.parametrize("positions", [[0, 1, 7], [129, 1000, 8191]])
def test_rope_is_the_written_rotation(positions):
    """Pair i at position p turned by p 10000^(-2i / d): x'[2i] = x[2i] cos
    - x[2i + 1] sin, x'[2i + 1] = x[2i + 1] cos + x[2i] sin (interleaved
    pairs, rotary-embedding-torch's ``RotaryEmbedding(32)``), in float64."""
    d, S = 32, max(positions) + 1
    table = rope_table(S, d, "cpu")
    x = torch.randn(2, S, 3, d, generator=torch.Generator().manual_seed(5))
    got = rope(x, table)
    for p in positions:
        for i in (0, 1, 7, 15):
            a = p * 10000.0 ** (-2 * i / d)
            x0, x1 = x[:, p, :, 2 * i].double(), x[:, p, :, 2 * i + 1].double()
            want0, want1 = x0 * math.cos(a) - x1 * math.sin(a), x1 * math.cos(a) + x0 * math.sin(a)
            torch.testing.assert_close(got[:, p, :, 2 * i].double(), want0, rtol=0, atol=1e-5)
            torch.testing.assert_close(got[:, p, :, 2 * i + 1].double(), want1, rtol=0, atol=1e-5)
    assert torch.equal(got[:, 0], x[:, 0])


def test_rms_group_norm_is_its_formula():
    """Each group of 32 channels over (its L2 norm / sqrt(32) + eps), eps
    added to the RMS and not under the root, times gamma; zero stays zero."""
    norm = RMSGroupNorm(4, 128)
    with torch.no_grad():
        norm.gamma.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(6))
    x = torch.randn(3, 5, 128, generator=torch.Generator().manual_seed(7)) * 1e-4
    x[0, 0] = 0.0
    with torch.no_grad():
        got = norm(x).double()
    g = x.double().view(3, 5, 4, 32)
    rms = (g.square().sum(-1, keepdim=True) / 32).sqrt()
    want = (g / (rms + 1e-5)).view(3, 5, 128) * norm.gamma.double()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert float(got[0, 0].abs().max()) == 0.0


def test_spans_and_counters(setup):
    _, model, paths, _ = setup
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            infer.enhance_wavs(model, paths[:3], batch_size=2, device="cpu", progress=False)
        rec = profiling.recorded()
        names = [s.name for s in rec.spans if s.name.startswith("tflocoformer.")]
        # two batches, two blocks each
        assert {n: names.count(n) for n in set(names)} == {
            "tflocoformer.freq": 4, "tflocoformer.time": 4}
        assert rec.counters["infer.frame_pairs"] == 3 * 64 ** 2
        assert rec.counters["infer.frames_computed"] == 3 * 64
        with torch.no_grad():
            model.apply(torch.zeros(1, 17, 8, 2))
        assert len(profiling.recorded().spans) == len(rec.spans)  # profiler off: none
    finally:
        profiling.clear()


def test_registry_name_builds_through_the_infer_cli(tmp_path, setup):
    P, _, paths, want = setup
    noisy = tmp_path / "noisy"
    noisy.mkdir()
    (noisy / "a.wav").write_bytes(open(paths[0], "rb").read())
    ckpt = tmp_path / "params.npz"
    np.savez(ckpt, **{k.replace(".", "/"): v.numpy() for k, v in P.items()})
    widths = "".join(f"  {k}: {v}\n" for k, v in SMALL.items())
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"test_dataset:\n  noisy_dir: {noisy}\n"
                   f"network:\n  checkpoint: {ckpt}\n  enh_folder: {tmp_path / 'enh'}\n"
                   f"network_config:\n{widths}")
    infer.main(["-C", str(cfg), "--device", "cpu", "--model", "tflocoformer"])
    out, _ = read_wav(str(tmp_path / "enh" / "a_enh.wav"))
    # seeded weights: the output passes full scale, where the 16-bit wav saturates
    np.testing.assert_allclose(out, np.clip(want[paths[0]], -1, 32767 / 32768), atol=1 / 32768)
