"""The port's complexity counter (utils/complexity.py) and profiling helpers
(utils/profiling.py) on the CPU.

- ``model_complexity``: the parameter count equals JAX's 19,014 exactly; the
  MACs per second of audio equal JAX's jaxpr count less the products of
  JAX's one-hot channel shuffle (gtcrn_micro_tpu/nn/blocks.py:163-178, two
  (8, 16) one-hot dots per GTConv block), which the port does as an
  interleave copy: exact integers, JAX's count of the same graph taken with
  its shuffle patched to that copy in this process (the package's files are
  not touched).
- ``time_fn`` and ``trace`` run on the CPU when asked for it, and refuse
  without a card when not.
"""

import json
import os

import pytest

import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu.nn import blocks as jblocks
from gtcrn_micro_tpu.utils import complexity as jcomplexity
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, init_params
from gtcrn_micro_tpu_torch.utils import complexity, profiling


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_model_complexity_matches_jax(monkeypatch):
    jm = JModel()
    j_params, j_macs = jcomplexity.model_complexity(jm)
    # the same JAX graph with the shuffle as the port's interleave copy
    monkeypatch.setattr(jblocks.GTConvBlock, "shuffle", staticmethod(
        lambda x1, x2: jnp.stack([x1, x2], axis=-1).reshape(*x1.shape[:-1], 2 * x1.shape[-1])))
    _, j_macs_copy = jcomplexity.model_complexity(jm)
    frames = 16000 // jm.config.hop_len + 1
    assert j_macs - j_macs_copy == 6 * 2 * frames * 33 * 8 * 16  # 6 blocks, 2 one-hot dots
    model = GTCRNMicro.from_params(init_params(torch.Generator().manual_seed(0), device="cpu"),
                                   device="cpu")
    n_params, n_macs = complexity.model_complexity(model)
    assert n_params == j_params == 19014
    assert n_macs == j_macs_copy, (n_macs, j_macs, j_macs_copy)


def test_macs_counts_each_contraction():
    x = torch.zeros((2, 5, 7))
    w = torch.zeros((7, 3))
    assert complexity.macs(lambda a: a @ w, x) == 2 * 5 * 3 * 7
    assert complexity.macs(lambda a: torch.matmul(a, w), x) == 2 * 5 * 3 * 7
    assert complexity.macs(lambda a: torch.nn.functional.linear(a, w.t()), x) == 2 * 5 * 3 * 7
    assert complexity.macs(lambda a: torch.einsum("btc,cd->btd", a, w), x) == 2 * 5 * 7 * 3
    img = torch.zeros((1, 4, 6, 6))
    conv_w = torch.zeros((8, 2, 3, 3))  # groups 2: 2 input channels per group
    out_numel = 1 * 8 * 4 * 4
    assert complexity.macs(lambda a: torch.nn.functional.conv2d(a, conv_w, groups=2),
                           img) == out_numel * 2 * 3 * 3


def test_time_fn_on_the_cpu_and_refusal_without_a_card(monkeypatch):
    x = torch.ones(1000)
    calls = []

    def fn(a, scale=1.0):
        calls.append(1)
        return a * scale

    secs = profiling.time_fn(fn, x, iters=5, device="cpu", scale=2.0)
    assert secs > 0 and len(calls) == 6  # one warm-up
    assert profiling.sync(x * 3) == 3.0
    assert profiling.measure_rtt(iters=3, device="cpu") > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.time_fn(fn, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.measure_rtt()


def test_chain_seconds_on_the_cpu():
    """The scripts' timing loop: the warm calls, then ``repeats`` chains of
    ``fn(0) .. fn(n - 1)``; ordered times, no CUDA events off the card."""
    calls = []

    def fn(i):
        calls.append(i)
        return torch.full((4,), float(i))

    t = profiling.chain_seconds(fn, 4, repeats=3, rtt=0.0, warm=2)
    assert calls == [0, 1] + [0, 1, 2, 3] * 3
    assert 0 < t.min <= t.median <= t.max and t.event is None
    far = profiling.chain_seconds(fn, 2, repeats=1, rtt=10.0)
    assert far.median == far.min == far.max == 1e-9 / 2  # rtt above the chain: floored


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as path:
        y = torch.ones((64, 64)) @ torch.ones((64, 64))
    assert float(y[0, 0]) == 64.0
    assert os.path.exists(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
