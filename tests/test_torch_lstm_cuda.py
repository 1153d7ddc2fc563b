"""The LSTM kernel (``csrc/lstm.cu`` through ``ops/lstm.run`` and
``nn/core.LSTM``) against aten's float32 loop on the card, with the same
weights, at TF-GridNet's full-band shapes and at edge shapes.

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc`` and skip elsewhere.
Run them on a GPU host with ``python -m pytest --noconftest
tests/test_torch_lstm_cuda.py``.

Tolerance: both the kernel and aten's CUDA loop are compared with the plain
loop on the CPU (float32, the same weights and inputs; at the full-band
shapes a few rows from every group, the rows being independent), and the
kernel's relative error must be within 10x of aten's own, or 1e-6 where
aten's reads less.  All three sum the same float32 products in other
orders (aten's GEMMs split the 192-deep sums their own way, the kernel adds
column by column), and over chains of thousands of steps those roundings
grow alike in both; a wrong gate, row, step or direction reads 1e-1 or
more.
"""

import pytest
import torch

from gtcrn_micro_tpu_torch.nn.core import LSTM, Ctx
from gtcrn_micro_tpu_torch.ops import lstm as lstm_kernel

pytestmark = pytest.mark.cuda

FACTOR, FLOOR = 10.0, 1e-6
# the cell's two batches: 4 clips of 20-30 s in the 4,097-frame bucket, 4 of
# 60 s in the 8,193-frame bucket; windows = frames - 3, 129 rows a clip
CELL = {4094: [2498, 2914, 3331, 3748], 8190: [7498] * 4}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel is CUDA C++ for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer(bidirectional=True, input_size=192, seed=0):
    torch.manual_seed(seed)
    return LSTM(input_size, 192, bidirectional=bidirectional)


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _check(lstm, dev, x, lengths, rows=None):
    """Kernel and aten's CUDA loop on every row, each against the CPU loop
    on ``rows`` (all when None); returns the kernel's output."""
    gpu = LSTM(lstm.input_size, 192, bidirectional=lstm.bidirectional).to(dev)
    gpu.load_state_dict(lstm.state_dict())
    xd = x.to(dev)
    ld = None if lengths is None else lengths.to(dev)
    with torch.no_grad():
        got = gpu(Ctx(), xd, ld)
        aten = gpu.plain(xd, ld)
        torch.cuda.synchronize()
        rows = torch.arange(x.shape[0]) if rows is None else torch.tensor(rows)
        want = lstm.plain(x[rows], None if lengths is None else lengths[rows])
    assert gpu.launches == 1
    k_err, a_err = _rel(got[rows.to(dev)].cpu(), want), _rel(aten[rows.to(dev)].cpu(), want)
    assert k_err <= max(FACTOR * a_err, FLOOR), (k_err, a_err)
    if lengths is not None:  # zeros past each row's length, in both directions
        pos = torch.arange(x.shape[1], device=dev)
        past = pos[None, :] >= ld[:, None]
        assert not bool(got[past].any())
    return got


@pytest.mark.parametrize("steps", sorted(CELL))
def test_full_band_shapes(dev, steps):
    """516 rows (batch 4 x 129 bins) at the cell's lengths; rows compared
    on the CPU: the first and last of every group (7 of 74 rows) and of
    every clip."""
    lstm = _layer()
    g = torch.Generator().manual_seed(steps)
    x = torch.randn(516, steps, 192, generator=g)
    lengths = torch.tensor(CELL[steps]).repeat_interleave(129)
    rows = sorted({r for g0 in range(0, 516, 74) for r in (g0, min(g0 + 73, 515))}
                  | {r for c in range(0, 516, 129) for r in (c, c + 128)})
    _check(lstm, dev, x, lengths, rows)


@pytest.mark.parametrize("rows,steps,lengths", [
    (100, 37, [1, 37] + [17] * 98),  # rows not a multiple of a group; lengths 1 and S
    (70, 20, None),  # fewer steps than a cluster's rows; every step valid
    (3, 12, [12, 7, 3]),
    (516, 5, None),
], ids=["ragged-groups", "short", "three-rows", "full-band-rows"])
def test_edge_shapes(dev, rows, steps, lengths):
    lstm = _layer(seed=rows)
    x = torch.randn(rows, steps, 192, generator=torch.Generator().manual_seed(rows + steps))
    _check(lstm, dev, x, None if lengths is None else torch.tensor(lengths))


@pytest.mark.parametrize("lengths", [None, "ragged"])
def test_one_direction(dev, lengths):
    lstm = _layer(bidirectional=False, input_size=96)
    x = torch.randn(130, 50, 96, generator=torch.Generator().manual_seed(5))
    lens = None if lengths is None else torch.randint(1, 51, (130,),
                                                     generator=torch.Generator().manual_seed(6))
    _check(lstm, dev, x, lens)


def test_a_graph_replays_at_other_lengths(dev):
    """One capture serves batches of other lengths: the replay equals the
    layer run as it comes on the same inputs, bit for bit."""
    gpu = _layer().to(dev)
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(300, 200, 192, generator=g, device=dev)
    lengths = torch.full((300,), 200, dtype=torch.int64, device=dev)
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            gpu(Ctx(), x, lengths)  # warm-up: the build and the attribute calls
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = gpu(Ctx(), x, lengths)
        for seed in (1, 2):
            x.copy_(torch.randn(x.shape, generator=g, device=dev))
            lengths.copy_(torch.randint(1, 201, (300,), generator=g, device=dev))
            graph.replay()
            want = gpu(Ctx(), x, lengths)
            torch.cuda.synchronize()
            assert torch.equal(out, want), seed


def test_launches_count_the_full_band_only(dev):
    """TF-GridNet at its published widths, batch 4 x 300 frames: the
    full-band BiLSTM (516 rows) launches the kernel, the sub-band one (1,200
    rows: more than one resident wave) keeps aten's loop."""
    from gtcrn_micro_tpu_torch.models.tfgridnet import TFGridNet

    model = TFGridNet(device=dev)
    spec = torch.randn(4, 129, 300, 2, generator=torch.Generator().manual_seed(3)).to(dev)
    with torch.no_grad():
        y = model.apply(spec, torch.tensor([300, 250, 120, 37], device=dev))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    assert [b.inter_rnn.launches for b in model.blocks] == [1] * 6
    assert [b.intra_rnn.launches for b in model.blocks] == [0] * 6


def test_routing_on_this_card(dev):
    clusters = lstm_kernel.resident_clusters(dev)
    assert clusters >= 14, clusters  # the full-band 516 rows in one wave
    assert lstm_kernel.takes(dev, torch.float32, False, 516, 192, 192, 2, clusters)
    assert not lstm_kernel.takes(dev, torch.float32, False, 8192, 192, 192, 2, clusters)
