"""The TF-Locoformer FFN kernel (``csrc/loco_ffn.cu`` through
``ops/loco_ffn.run`` and ``nn/blocks.LocoformerBlock``) against the layered
sub-layer on the card, with the same weights, at the cell's shapes: a
chunk of the frequency path (6,555 sequences of 129 bins, tiles across
sequence ends) and one of the time path (104 sequences of 8,193 frames,
2,501, 7,501 and 8,193 of them valid), each masked past the frames as the
block's first FFN is and unmasked as its last; a block over chunks; a CUDA
graph's replay against the eager launch.

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc`` and skip elsewhere.
Run them on a GPU host with ``python -m pytest --noconftest
tests/test_torch_loco_ffn_cuda.py``.

Tolerance: the kernel and the layered path (float32 SGEMMs, TF32 off) are
both compared with the sub-layer in float64 on 24 sequences spread over
the chunk, and the kernel's relative error must be within 4x of the
layered path's.  The kernel takes three TF32 products a float32 product
(about 2^-21 of each) and sums them in the tensor cores' float32, a stage
at a time; the layered path sums float32 products.  On an H100 the kernel
reads ~2.2e-7 and the layered path ~1.6e-7 at these shapes; a wrong tap,
unit, row or mask reads 1e-1 or more, one TF32 product in place of three
~2.6e-4, and a whole 512-deep sum in one accumulator ~3.8e-6.
"""

import pytest
import torch

from gtcrn_micro_tpu_torch.nn.blocks import ConvSwiGLU, LocoformerBlock, RMSGroupNorm
from gtcrn_micro_tpu_torch.ops import _build
from gtcrn_micro_tpu_torch.ops import loco_ffn

pytestmark = pytest.mark.cuda

FACTOR = 4.0
# the cell's chunks: 5 of each path over a batch of 4 x 8,193 frames
FREQ = (6555, 129, None)
TIME = (104, 8193, [2501, 7501, 8193])


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel is CUDA C++ for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pair(dev, seed=0):
    torch.manual_seed(seed)
    norm, ffn = RMSGroupNorm(4, 128), ConvSwiGLU(128, 384, 4)
    with torch.no_grad():
        norm.gamma.uniform_(0.5, 1.5)
        ffn.conv1d.bias.uniform_(-0.5, 0.5)
        ffn.deconv1d.bias.uniform_(-0.5, 0.5)
    return norm.to(dev), ffn.to(dev)


def _layered(x, norm, ffn, frames):
    y = x + ffn(norm(x))
    if frames is None:
        return y
    return torch.where((torch.arange(x.shape[1], device=x.device) < frames[:, None])[:, :, None],
                       y, 0.0)


def _inputs(dev, N, S, lens, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(N, S, 128, generator=g, device=dev)
    frames = None
    if lens is not None:
        frames = torch.tensor(lens, device=dev).repeat(-(-N // len(lens)))[:N]
        x = torch.where((torch.arange(S, device=dev) < frames[:, None])[:, :, None], x, 0.0)
    return x, frames


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_kernel_attrs_no_spills(dev):
    attrs = _build.kernel_attrs("loco_ffn")["float32"]
    assert attrs["local_bytes"] == 0, attrs
    assert attrs["smem_bytes"] <= 232_448 and attrs["ctas_per_sm"] >= 1, attrs


@pytest.mark.parametrize("shape", [FREQ, TIME], ids=["freq", "time"])
@pytest.mark.parametrize("masked", [True, False], ids=["ffn1", "ffn0"])
def test_kernel_matches_the_layered_sublayer_at_the_cells_shapes(dev, shape, masked):
    N, S, lens = shape
    norm, ffn = _pair(dev, S)
    x, frames = _inputs(dev, N, S, lens, N)
    f = frames if masked else None
    with torch.no_grad():
        got = loco_ffn.run(x, norm, ffn, f)
        want = _layered(x, norm, ffn, f)
        rows = torch.linspace(0, N - 1, 24, device=dev).long()
        norm64, ffn64 = _pair(dev, S)
        norm64, ffn64 = norm64.double(), ffn64.double()
        exact = _layered(x[rows].double(), norm64, ffn64, None if f is None else f[rows])
    k_err, l_err = _rel(got[rows], exact), _rel(want[rows], exact)
    print(f"N {N} S {S} masked {masked}: kernel {k_err:.3e}, layered {l_err:.3e} against "
          f"float64; kernel vs layered {_rel(got, want):.3e}")
    assert torch.isfinite(got).all()
    assert k_err <= FACTOR * l_err, (k_err, l_err)
    if f is not None:
        live = torch.arange(S, device=dev) < f[:, None]
        assert float(got[~live].abs().max()) == 0.0


def test_block_routes_both_ffns_and_chunks_change_nothing(dev, monkeypatch):
    """A LocoformerBlock at grad off sends both FFNs to the kernel, over
    sequences in chunks as ``TFLocoformerBlock`` runs them (sequences split
    across chunks of 300 positions); the whole agrees with the layered
    block (grad on, which the kernel does not take)."""
    from gtcrn_micro_tpu_torch.nn import blocks
    from gtcrn_micro_tpu_torch.nn.core import rope_table

    torch.manual_seed(1)
    block = LocoformerBlock(128, 384, 4, 4, 128, 4).to(dev)
    x, frames = _inputs(dev, 7, 200, [200, 37, 150, 1], 5)
    table = rope_table(200, 32, dev)
    monkeypatch.setattr(blocks, "LOCO_POSITIONS", 300)
    chunks = len(x.chunk(-(-7 * 200 // 300)))  # 4 of 2, 2, 2 and 1 sequences
    with torch.no_grad():
        got = blocks.TFLocoformerBlock._chunked(block, x, table, frames)
    assert block.launches == 2 * chunks
    with torch.enable_grad():
        want = blocks.TFLocoformerBlock._chunked(block, x, table, frames).detach()
    assert block.launches == 2 * chunks
    assert _rel(got, want) < 1e-5


def test_graph_replay_is_the_eager_launch(dev):
    """Captured once, replayed at other inputs and other frames: the same
    bits as an eager launch (frames read on the device, output from the
    graph's pool)."""
    norm, ffn = _pair(dev, 3)
    x, frames = _inputs(dev, 64, 500, [500, 123, 0, 377], 6)
    with torch.no_grad():
        loco_ffn.run(x, norm, ffn, frames)  # builds and packs before the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = loco_ffn.run(x, norm, ffn, frames)
        x2, _ = _inputs(dev, 64, 500, None, 7)
        x.copy_(x2)
        frames.copy_(torch.tensor([17, 500, 250, 0], device=dev).repeat(16))
        graph.replay()
        eager = loco_ffn.run(x, norm, ffn, frames)
    torch.cuda.synchronize()
    assert torch.equal(y, eager)
    assert float(y[3].abs().max()) == 0.0 and float(y[0, 17:].abs().max()) == 0.0
