"""The LSTM kernel's host side on the CPU (``ops/lstm.py``, ``nn/core.LSTM``):
the routing rule, the plain path a CPU tensor takes, the wrapper's argument
checks, and the packed weights, held to torch's gates by a step-by-step
model of what each CTA of a cluster computes (its 24 units' four gates from
its slice, each row's backward chain from its own last step, zeros past its
length).  The kernel itself runs only on a card:
``tests/test_torch_lstm_cuda.py``.

Tolerance: 1e-5 relative where float32 sums are taken in another order
(measured ~1e-7)."""

from __future__ import annotations

import pytest
import torch

from gtcrn_micro_tpu_torch.nn.core import LSTM, Ctx
from gtcrn_micro_tpu_torch.ops import _build
from gtcrn_micro_tpu_torch.ops import lstm as lstm_kernel

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
F32 = torch.float32


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("device,dtype,grad,rows,inputs,hidden,dirs,clusters,want", [
    (CUDA, F32, False, 516, 192, 192, 2, 15, True),  # TF-GridNet's full band, batch 4
    (CUDA, F32, False, 8192, 192, 192, 2, 15, False),  # its sub-band chunks
    (CUDA, F32, False, 560, 192, 192, 2, 14, True),  # 7 groups of 80 a direction
    (CUDA, F32, False, 561, 192, 192, 2, 15, False),  # an eighth group: 16 clusters
    (CUDA, F32, False, 561, 192, 192, 2, 16, True),
    (CUDA, F32, False, 516, 192, 192, 2, 13, False),  # a card holding fewer clusters
    (CUDA, F32, False, 1200, 192, 192, 1, 15, True),  # one direction: 15 groups
    (CUDA, F32, False, 1, 32, 192, 2, 16, True),
    (CPU, F32, False, 516, 192, 192, 2, 16, False),
    (CUDA, torch.float64, False, 516, 192, 192, 2, 16, False),
    (CUDA, torch.bfloat16, False, 516, 192, 192, 2, 16, False),
    (CUDA, F32, True, 516, 192, 192, 2, 16, False),  # grad on: aten's loop
    (CUDA, F32, False, 516, 192, 8, 2, 16, False),  # another width
    (CUDA, F32, False, 516, 100, 192, 2, 16, False),  # inputs not a multiple of 32
    (CUDA, F32, False, 516, 224, 192, 2, 16, False),  # more inputs than it stages
])
def test_routing_is_a_function_of_device_dtype_grad_and_shape(device, dtype, grad, rows, inputs,
                                                             hidden, dirs, clusters, want):
    assert lstm_kernel.takes(device, dtype, grad, rows, inputs, hidden, dirs, clusters) is want


@pytest.fixture
def no_build(monkeypatch):
    """Any build, residency query or launch fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("reached the kernel")

    for name in ("_load", "build", "launch_lstm", "lstm_clusters"):
        monkeypatch.setattr(_build, name, refuse)


@pytest.mark.parametrize("lengths", [None, [12, 7, 3]], ids=["full", "lengths"])
def test_a_cpu_tensor_takes_the_plain_path(no_build, lengths):
    torch.manual_seed(1)
    lstm = LSTM(192, 192, bidirectional=True)
    x = torch.randn(3, 12, 192, generator=torch.Generator().manual_seed(2))
    lens = None if lengths is None else torch.tensor(lengths)
    assert not lstm_kernel.routes(x, 192, 2)
    with torch.no_grad():
        got = lstm(Ctx(), x, lens)
        want = lstm.plain(x, lens)
    assert lstm.launches == 0 and torch.equal(got, want)


def _weights(inputs=192, hidden=192, dirs=2, seed=0):
    torch.manual_seed(seed)
    return [w.detach() for w in LSTM(inputs, hidden, bidirectional=dirs == 2)._flat_weights]


@pytest.mark.parametrize("case", ["float64", "int-like lengths", "non-contiguous", "3-D",
                                  "inputs", "weights", "lengths shape", "cpu"])
def test_the_wrapper_checks_before_any_launch(no_build, case):
    x = torch.randn(4, 6, 192)
    w, lengths = _weights(), None
    if case == "float64":
        x = x.double()
    elif case == "int-like lengths":
        lengths = torch.full((4,), 6.0)
    elif case == "non-contiguous":
        x = torch.randn(6, 4, 192).transpose(0, 1)
    elif case == "3-D":
        x = x[0]
    elif case == "inputs":
        x, w = torch.randn(4, 6, 100), _weights(inputs=100)
    elif case == "weights":
        w = w[:4]
    elif case == "lengths shape":
        lengths = torch.full((5,), 6)
    with pytest.raises(ValueError):
        lstm_kernel.run(x, lengths, w, 2)


def _kernel_model(x, lengths, weights, dirs):
    """What the kernel computes, step by step, from the packed weights: CTA
    q of direction d's cluster holds w[d, q] (its units' i, f, g, o gates,
    input column by input column) and b[d, q]; row n's backward chain reads
    x at lengths[n] - 1 - s; a step past a row's length writes a zero at
    position s."""
    w, b = lstm_kernel.pack(weights, dirs)
    N, S, _ = x.shape
    H, U = lstm_kernel.HIDDEN, lstm_kernel.HIDDEN // lstm_kernel.CLUSTER
    L = torch.full((N,), S) if lengths is None else lengths
    y = torch.zeros(N, S, dirs * H)
    rows = torch.arange(N)
    for d in range(dirs):
        h, c = torch.zeros(N, H), torch.zeros(N, H)
        for s in range(int(L.max())):
            valid = s < L
            t = torch.where(valid, L - 1 - s if d else torch.full((N,), s), 0)
            xt = torch.where(valid[:, None], x[rows, t], 0.0)
            act = torch.cat([xt, h], dim=1)
            h_new = torch.empty_like(h)
            for q in range(lstm_kernel.CLUSTER):
                gates = (act @ w[d, q] + b[d, q]).view(N, U, 4)
                i, f = torch.sigmoid(gates[..., 0]), torch.sigmoid(gates[..., 1])
                g, o = torch.tanh(gates[..., 2]), torch.sigmoid(gates[..., 3])
                cq = f * c[:, q * U:(q + 1) * U] + i * g
                c[:, q * U:(q + 1) * U] = cq
                h_new[:, q * U:(q + 1) * U] = o * torch.tanh(cq)
            h = h_new
            pos = torch.where(valid, t, s)
            y[rows, pos, d * H:(d + 1) * H] = torch.where(valid[:, None], h, 0.0)
    return y


@pytest.mark.parametrize("dirs,inputs,lengths", [(2, 192, [9, 4, 1]), (2, 64, None),
                                                 (1, 32, [5, 9, 2])])
def test_packed_weights_give_torchs_layer(dirs, inputs, lengths):
    """The packed layout, stepped as the kernel steps it, is torch's LSTM:
    the plain path (aten's loop and the gathers) on the same weights."""
    torch.manual_seed(3)
    lstm = LSTM(inputs, 192, bidirectional=dirs == 2)
    x = torch.randn(3, 9, inputs, generator=torch.Generator().manual_seed(4))
    lens = None if lengths is None else torch.tensor(lengths)
    with torch.no_grad():
        got = _kernel_model(x, lens, list(lstm._flat_weights), dirs)
        want = lstm.plain(x, lens)
    assert _rel(got, want) < 1e-5


def test_pack_shapes_and_bias():
    w, b = lstm_kernel.pack(_weights(inputs=64), 2)
    assert tuple(w.shape) == (2, 8, 64 + 192, 96) and tuple(b.shape) == (2, 8, 96)
    assert w.is_contiguous() and b.is_contiguous()
    weights = _weights(inputs=64)
    # CTA 3's unit 5, gate f (1): row 192 + 3 * 24 + 5 of torch's gate-major rows
    r = 192 + 3 * 24 + 5
    assert torch.equal(w[1, 3, :64, 4 * 5 + 1], weights[4][r])
    assert torch.equal(w[1, 3, 64:, 4 * 5 + 1], weights[5][r])
    assert float(b[1, 3, 4 * 5 + 1]) == float(weights[6][r] + weights[7][r])
