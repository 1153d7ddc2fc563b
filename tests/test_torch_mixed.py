"""The port's mixed 16/8 activation precision (gtcrn_micro_tpu_torch.quant.
mixed) held against the JAX package's on the CPU.

Setup as tests/quant/test_mixed.py: ``GTCRNMicro().init(PRNGKey(0))`` and
ranges observed on 4 seeded specs of 16 frames (by the port's observer; the
same float ranges then go into both packages).  Bounds and why:

- ``compose_act_qp``: bit-identical (float32 op for op, as the port's
  ``act_qparams``);
- ``greedy_lift``: the same trails (pure Python);
- ``TracedQuantizer``: equal to the port's ``FakeQuantizer`` on the same
  table, and against JAX's at the int8 step test's tie-aware bounds
  (tests/ops/test_int8_step.py:67-72: median frame max-abs < 1e-6, worst
  < 5e-3 max|y|, every frame > 50 dB): the two forwards round float32 ties
  differently, and a value on a tie moves one quantum;
- ``make_wav_scorer``: within 0.05 dB of JAX's (such a flip moves an SNR
  in the 20-40 dB range by far less);
- mixed streaming against offline, and e16 < e_mixed < e8: the JAX tests'.
"""

import dataclasses
import statistics

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu.nn.core import Ctx as JCtx
from gtcrn_micro_tpu.quant import mixed as jmixed
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, scan_stepper
from gtcrn_micro_tpu_torch.quant import mixed
from gtcrn_micro_tpu_torch.quant.ptq import FakeQuantizer, QuantizedModel, observe_ranges

LIFT3 = {"encoder/en2/pw1/in", "gtcn2/block3/pw3/in", "decoder/de4/conv/in"}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def setup():
    jm = JModel()
    params = jm.init(jax.random.PRNGKey(0))
    model = GTCRNMicro.from_params(jax.tree.map(np.array, params), device="cpu")
    calib = np.random.default_rng(0).standard_normal((4, 257, 16, 2)).astype(np.float32) * 0.3
    ranges = observe_ranges(model, calib, batch_size=4)
    return jm, params, model, ranges


def test_compose_act_qp_bit_identical_to_jax(setup):
    *_, ranges = setup
    lifted = {"encoder/en2/pw1/in", "gtcn1/block0/pw1/in"}
    got, want = mixed.compose_act_qp(ranges, lifted), jmixed.compose_act_qp(ranges, lifted)
    assert list(got) == list(want) and len(got) == 59
    for p, q in want.items():
        assert (got[p].qmin, got[p].qmax) == (q.qmin, q.qmax) == (
            (-32768, 32767) if p in lifted else (-128, 127)), p
        np.testing.assert_array_equal(got[p].scale.numpy(), np.asarray(q.scale))
        np.testing.assert_array_equal(got[p].zero.numpy(), np.asarray(q.zero))
    # unlifted paths keep the base (e.g. learned) params object itself
    base = mixed.compose_act_qp(ranges, ())
    tweaked = {p: dataclasses.replace(q, scale=q.scale * 1.5) for p, q in base.items()}
    qp = mixed.compose_act_qp(ranges, {"decoder/de0/pw2/in"}, tweaked)
    for p in ranges:
        if p == "decoder/de0/pw2/in":
            assert qp[p].qmax == 32767
        else:
            assert qp[p] is tweaked[p]


def _stub_score(lifted):
    return 20.0 + sum({"a": 3.0, "b": 10.0, "c": 1.0}[p] for p in lifted)


@pytest.mark.parametrize("score,target,cands", [
    (_stub_score, 32.0, ["a", "b", "c"]),           # best gain first, stop at the target
    (lambda lifted: 10.0 - len(lifted), 50.0, ["a", "b"]),  # every lift hurts
])
def test_greedy_lift_trails_match_jax(score, target, cands):
    got = mixed.greedy_lift(score, cands, target_db=target, max_lift=3, log=lambda s: None)
    want = jmixed.greedy_lift(score, cands, target_db=target, max_lift=3, log=lambda s: None)
    assert got == want
    if target == 32.0:
        assert got == ({"b", "a"}, 33.0, [("b", 30.0), ("a", 33.0)])
    else:
        assert got == (set(), 10.0, [])


def _tie_bounds(ref: np.ndarray, got: np.ndarray):
    """tests/ops/test_int8_step.py:67-72 over frames (axis 2)."""
    errs = [float(np.abs(got[:, :, t] - ref[:, :, t]).max()) for t in range(ref.shape[2])]
    snrs = [10 * np.log10(np.sum(ref[:, :, t] ** 2) / max(np.sum((got - ref)[:, :, t] ** 2), 1e-30))
            for t in range(ref.shape[2])]
    assert statistics.median(errs) < 1e-6, errs
    assert max(errs) < 5e-3 * max(float(np.abs(ref).max()), 1.0), errs
    assert min(snrs) > 50, snrs


def test_traced_quantizer_matches_fake_quant_and_jax(setup):
    jm, params, model, ranges = setup
    spec = np.random.default_rng(3).standard_normal((2, 257, 12, 2)).astype(np.float32) * 0.3
    act_qp = mixed.compose_act_qp(ranges, LIFT3)
    with torch.no_grad():
        traced = model.apply(torch.from_numpy(spec),
                             quant=mixed.TracedQuantizer(mixed.qp_table(act_qp, device="cpu")))
        fake = model.apply(torch.from_numpy(spec), quant=FakeQuantizer(act_qp))
    np.testing.assert_array_equal(traced.numpy(), fake.numpy())

    def j_forward(s, tab):
        ctx = JCtx()
        ctx.quant = jmixed.TracedQuantizer(tab)
        return jm._forward(params, s, ctx)

    want = np.asarray(jax.jit(j_forward)(
        jnp.asarray(spec), jmixed.qp_table(jmixed.compose_act_qp(ranges, LIFT3))))
    _tie_bounds(want, traced.numpy())


def test_make_wav_scorer_within_005_db_of_jax(setup):
    jm, params, model, ranges = setup
    rng = np.random.default_rng(4)
    wavs = [(rng.standard_normal(8000) * 0.1).astype(np.float32) for _ in range(2)]
    score = mixed.make_wav_scorer(model, wavs, ranges, None)
    j_score = jmixed.make_wav_scorer(jm, params, wavs, ranges, None)
    for lifted in (set(), LIFT3, set(ranges)):
        got, want = score(lifted), j_score(lifted)
        assert np.isfinite(got) and abs(got - want) <= 0.05, (sorted(lifted)[:3], got, want)


def test_mixed_streaming_equals_offline(setup):
    *_, model, ranges = setup
    qm = QuantizedModel(model=model, act_qp=mixed.compose_act_qp(ranges, LIFT3))
    spec = torch.from_numpy(
        np.random.default_rng(1).standard_normal((1, 257, 8, 2)).astype(np.float32) * 0.3)
    offline = qm.apply(spec)
    stream, _ = scan_stepper(qm.step, qm.init_state(1), spec)
    assert float((stream - offline).abs().max()) < 1e-5


def test_mixed_quality_between_int8_and_int16(setup):
    *_, model, ranges = setup
    spec = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, 257, 8, 2)).astype(np.float32) * 0.3)
    with torch.no_grad():
        fp32 = model.apply(spec)

    def err(lifted):
        qm = QuantizedModel(model=model, act_qp=mixed.compose_act_qp(ranges, lifted))
        return float((qm.apply(spec) - fp32).abs().mean())

    e8, e16, e_mixed = err(set()), err(set(ranges)), err(set(list(ranges)[:30]))
    assert e16 < e_mixed < e8
