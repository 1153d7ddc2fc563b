"""TF-Locoformer on the port's layered path (``models/tflocoformer.py`` over
``nn/blocks.TFLocoformerBlock``) and through the offline entry point, held
on the CPU to the plain reference ``benchmark/reference/tflocoformer.py``
(each clip alone at its own length) at a small size: C 16, FFN 24, 2 heads
of 8, 4 groups, n_fft 32 (F 17), hop 16, 2 blocks, clips of 20-60 frames,
seeded weights; its rotary embedding and RMSGroupNorm against their
formulas, and its parameter count at the published widths.  The FFN
kernel's routing rule (``ops/loco_ffn.takes``), its argument checks and
its packed weights: the kernel's arithmetic, restated here from its index
math in float64 over the packed stages, against the layered sub-layer in
float64 at the published widths (kernel 4, 128 channels, 384 hidden).

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
from gtcrn_micro_tpu_torch.nn.blocks import ConvSwiGLU, LocoformerBlock, RMSGroupNorm
from gtcrn_micro_tpu_torch.nn.core import rope, rope_table
from gtcrn_micro_tpu_torch.ops import loco_ffn
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


# -- the FFN kernel's route, checks and packed weights -------------------------

CUDA = torch.device("cuda")
CELL = dict(device=CUDA, dtype=torch.float32, grad=False, channels=128, hidden=384, kernel=4,
            stride=1, groups=4, contiguous=True)


@pytest.mark.parametrize("change", [
    {}, {"device": torch.device("cpu")}, {"dtype": torch.bfloat16}, {"dtype": torch.float64},
    {"grad": True}, {"channels": 16}, {"hidden": 24}, {"kernel": 3}, {"stride": 2},
    {"groups": 2}, {"contiguous": False}])
def test_ffn_kernel_takes_the_published_widths_on_a_card_without_grad(change):
    """The cell's FFN at grad off on a card, and nothing else: not the CPU,
    other dtypes, grad on (training), other widths, strides or layouts."""
    assert loco_ffn.takes(**{**CELL, **change}) == (not change)


def _ffn_pair(seed=0):
    """An RMSGroupNorm and a ConvSwiGLU at the published widths, seeded,
    with gamma and the biases away from their initial values."""
    torch.manual_seed(seed)
    norm, ffn = RMSGroupNorm(4, 128), ConvSwiGLU(128, 384, 4)
    with torch.no_grad():
        norm.gamma.uniform_(0.5, 1.5)
        ffn.conv1d.bias.uniform_(-0.5, 0.5)
        ffn.deconv1d.bias.uniform_(-0.5, 0.5)
    return norm, ffn


def test_ffn_routes_nothing_on_the_cpu():
    norm, ffn = _ffn_pair()
    x = torch.randn(2, 9, 128)
    with torch.no_grad():
        assert not loco_ffn.routes(x, norm, ffn)
    assert not loco_ffn.routes(x, norm, ffn)  # grad on


@pytest.mark.parametrize("frames", [None, [9, 4, 0]])
def test_cpu_block_is_the_layered_path_bit_for_bit(frames):
    """On the CPU the block runs its layered sub-layers as before the
    kernel, operation for operation, and launches nothing."""
    torch.manual_seed(5)
    block = LocoformerBlock(128, 384, 4, 4, 128, 4)
    x = torch.randn(3, 9, 128)
    table = rope_table(9, 32, "cpu")
    f = None if frames is None else torch.tensor(frames)
    with torch.no_grad():
        got = block(x, table, f)
        live = None if f is None else (torch.arange(9) < f[:, None])[:, :, None]

        def keep(y):
            return y if live is None else torch.where(live, y, 0.0)

        want = keep(x)
        want = keep(want + block.ffn[1](block.ffn_norm[1](want)))
        want = keep(want + block.attn(block.attn_norm(want), table, f))
        want = want + block.ffn[0](block.ffn_norm[0](want))
    assert torch.equal(got, want)
    assert block.launches == 0


def _emulate(x, norm, ffn, frames, w):
    """What csrc/loco_ffn.cu computes, from the packed stages ``w`` and with
    the kernel's own index arithmetic, in float64 but for its float32 norm
    and its TF32 splits (the three products lo hi, hi lo, hi hi; the
    activations' hi part their own bits, which the tensor cores cut to
    TF32)."""
    N, S, C = x.shape
    SP, M = S + 3, 61  # padded positions a sequence; outputs a warpgroup
    tiles = -(-N * SP // M)

    def stage(s, steps, cols):
        """B of stage s as the kernel's wgmma reads it: hi and lo tiles of
        core matrices [step kk][half h][n / 8][n % 8][i], K-major, at depth
        kk 8 + 2 i + h."""
        kk, h, ng, r, i = torch.meshgrid(
            *(torch.arange(m) for m in (steps, 2, cols // 8, 8, 4)), indexing="ij")
        rows, col = kk * 8 + 2 * i + h, ng * 8 + r
        hi, lo = (torch.zeros(steps * 8, cols, dtype=torch.float64) for _ in range(2))
        v = w[s].view(2, steps, 2, cols // 8, 8, 4).double()
        hi[rows, col], lo[rows, col] = v[0], v[1]
        return hi, lo

    def mm(a, b):
        ah = (a.float().view(torch.int32) & -0x2000).view(torch.float32)
        al = loco_ffn._tf32(a.float() - ah)
        return al.double() @ b[0] + ah.double() @ b[1] + ah.double() @ b[0]

    g = x.view(N, S, 4, 32)
    rms = torch.linalg.vector_norm(g, dim=-1, keepdim=True) * 32 ** -0.5
    normed = (g / (rms + norm.eps)).view(N, S, C) * norm.gamma
    pad = torch.zeros(N, SP, C)
    pad[:, 3:] = normed
    # padded position Q is row Q + 3: three zero rows before position 0
    xs_all = torch.cat([torch.zeros(3, C), pad.view(-1, C), torch.zeros(tiles * M + 67, C)])
    b1, b2 = ffn.conv1d.bias.double(), ffn.deconv1d.bias.double()
    conv = [[stage(c * 12 + ks, 8, 64) for ks in range(8)] for c in range(12)]
    deconv = [[stage(c * 12 + 8 + j, 4, 128) for j in range(4)] for c in range(12)]
    out_rows = []
    for t in range(tiles):
        xs = xs_all[t * M : t * M + 67]
        out = torch.zeros(64, C, dtype=torch.float64)
        hs = torch.zeros(67, 32, dtype=torch.float64)
        for c in range(12):
            acc = torch.zeros(64, 64, dtype=torch.float64)
            for ks in range(8):
                tap, c0 = ks // 2, ks % 2 * 64
                acc += mm(xs[tap : tap + 64, c0 : c0 + 64], conv[c][ks])
            # columns 0-31 the chunk's u units, 32-63 its g units
            u = acc[:, :32] + b1[c * 32 : c * 32 + 32]
            gate = acc[:, 32:] + b1[384 + c * 32 : 384 + c * 32 + 32]
            hs[:64] = u * gate * torch.sigmoid(gate)
            for j in range(4):
                out += mm(hs[3 - j : 67 - j], deconv[c][j])
        out_rows.append(out[:M])
    y = torch.cat(out_rows)[: N * SP].view(N, SP, C)[:, 3:] + b2 + x.double()
    if frames is not None:
        y = torch.where((torch.arange(S) < frames[:, None])[:, :, None], y, 0.0)
    return y


@pytest.mark.parametrize("N, S, frames", [
    (40, 5, None),            # 12 sequences a warpgroup's tile
    (3, 129, None),           # tiles across sequence ends
    (3, 129, [129, 60, 0]),   # masked past each sequence's frames
    (1, 300, [251]),          # one sequence over five tiles
])
def test_packed_weights_computed_as_the_kernel_reads_them(N, S, frames):
    """The kernel's arithmetic over :func:`ops.loco_ffn.pack`'s stages, as
    csrc/loco_ffn.cu indexes them, is the layered sub-layer (x + FFN(norm(x)),
    masked past frames) in float64 to 1e-6: a stage, tap, column, unit or
    position out of place reads 1e-1 or more."""
    norm, ffn = _ffn_pair(N + S)
    x = torch.randn(N, S, 128, generator=torch.Generator().manual_seed(S))
    f = None if frames is None else torch.tensor(frames)
    w = loco_ffn.pack(ffn.conv1d.weight, ffn.deconv1d.weight)
    assert w.shape == (144, 8192) and w.dtype == torch.float32
    with torch.no_grad():
        got = _emulate(x, norm, ffn, f, w)
        norm64, ffn64 = (m.to(torch.float64) for m in (norm, ffn))
        want = x.double() + ffn64(norm64(x.double()))
    if f is not None:
        want = torch.where((torch.arange(S) < f[:, None])[:, :, None], want, 0.0)
    assert _rel(got, want) < 1e-6


def test_tf32_split_is_hi_and_residual():
    """Each packed value is a TF32 high part (13 low bits zero, rounded to
    nearest) and a TF32 residual, together within 2^-21 of the weight."""
    v = torch.randn(4096, 2, generator=torch.Generator().manual_seed(9)) * 10.0 ** torch.randint(
        -6, 6, (4096, 1), generator=torch.Generator().manual_seed(10))
    hi = loco_ffn._tf32(v)
    lo = loco_ffn._tf32(v - hi)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((v - hi).abs() / v.abs()).max()) <= 2.0 ** -11
    assert float(((hi.double() + lo.double() - v.double()).abs() / v.abs().double()).max()) <= 2.0 ** -21


def test_packed_weights_are_kept_until_a_weight_changes():
    _, ffn = _ffn_pair()
    first = loco_ffn.packed(ffn)
    assert loco_ffn.packed(ffn) is first
    with torch.no_grad():
        ffn.deconv1d.weight.mul_(2.0)
    second = loco_ffn.packed(ffn)
    assert second is not first
    assert torch.equal(second, loco_ffn.pack(ffn.conv1d.weight, ffn.deconv1d.weight))


@pytest.mark.parametrize("case", ["cpu", "float64", "width", "layout", "frames"])
def test_ffn_kernel_refuses_what_it_does_not_take(case):
    """``run`` raises before any launch (nothing is built on this host)."""
    norm, ffn = _ffn_pair()
    x, frames = torch.randn(2, 9, 128), None
    if case == "float64":
        x = x.double()
    elif case == "width":
        x = torch.randn(2, 9, 64)
    elif case == "layout":
        x = torch.randn(9, 2, 128).transpose(0, 1)
    elif case == "frames":
        frames = torch.tensor([9, 4], dtype=torch.int32)
    with pytest.raises(ValueError):
        loco_ffn.run(x, norm, ffn, frames)
