"""The port's quantization (gtcrn_micro_tpu_torch.quant: fake-quant, PTQ
ranges, the quantized model, QAT) held against the JAX package's, on the
CPU.

The same numpy params (the JAX init, PRNGKey(0)) and the seeded calibration
batch of tests/quant/test_quant.py:22-30, ``(4, 257, 16, 2) * 0.3``, go into
both; JAX activation params are carried across bit for bit
(``io.params.act_qp_from_jax``).  The JAX range observer and train step run
jitted, as the JAX package runs them; the quantized model's ``apply`` runs
eagerly (no full-model compile).

Tolerances and why:

- the fake-quant functions: bit-identical to JAX's eager functions on the
  same inputs (the same float32 operations), straight-through gradient 1;
- percentiles: within 1 float32 ulp of jitted ``jnp.percentile`` on the
  same tensors (measured 0: XLA fuses the interpolation's outer multiply-add,
  which the port emulates);
- ``observe_ranges`` against JAX's: the same 59 paths; each range within
  1e-6 of the path's largest bound (8 float32 ulps), since the two forwards
  round differently (measured: 3.1 ulps per channel, 2.0 per tensor, i.e.
  <= 6e-8 absolute);
- ``QuantizedModel.apply`` against JAX's: the bounds of
  tests/ops/test_int8_step.py:67-72 for two quantized paths, which allow a
  value that lands on a rounding tie to flip by one quantum: median error
  < 1e-6, worst < 5e-3 max|y|, SNR > 50 dB (measured: max 5.2e-6 at 16x8,
  <= 4.5e-8 otherwise, 102-136 dB);
- the quantized ring and l2_psum steps against the port's own ``apply``:
  at 16x8 < 1e-5, the bound of tests/quant/test_quant.py:98 (measured
  7.0e-6); at int8 the tie-aware bounds per frame (measured: 0 in most
  frames, 8.1e-4 where a tie flips);
- three QAT steps against JAX's: the bounds of
  tests/test_torch_train.py::test_train_steps_match_jax (loss rtol 1e-5;
  params 1e-4, biases 1.2e-3).
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu.quant import act_qparams as j_act_qparams
from gtcrn_micro_tpu.quant.ptq import QuantizedModel as JQuantizedModel
from gtcrn_micro_tpu.quant.ptq import observe_ranges as j_observe_ranges
from gtcrn_micro_tpu_torch.io.params import act_qp_from_jax
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, flatten, scan_stepper
from gtcrn_micro_tpu_torch.quant.ptq import (
    FakeQuantizer,
    QuantizedModel,
    RangeObserver,
    make_quantized_model,
    observe_ranges,
    percentiles,
    qparams_from_ranges,
)

# the modules (each package's __init__ exports a function of the same name)
jfq = importlib.import_module("gtcrn_micro_tpu.quant.fake_quant")
tfq = importlib.import_module("gtcrn_micro_tpu_torch.quant.fake_quant")


def _calib():
    rng = np.random.default_rng(0)
    return rng.standard_normal((4, 257, 16, 2)).astype(np.float32) * 0.3


def _spec(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


def _j_act_qp(ranges, bits=8):
    return {p: j_act_qparams(jnp.asarray(lo, jnp.float32), jnp.asarray(hi, jnp.float32), bits)
            for p, (lo, hi) in ranges.items()}


def _ulps(a, b):
    a, b = (np.asarray(v, np.float32).view(np.int32).astype(np.int64) for v in (a, b))
    return int(np.abs(a - b).max())


def _check_tie_bounds(want, got):
    """tests/ops/test_int8_step.py:67-72's bounds on one output."""
    err = np.abs(got - want)
    snr = 10 * np.log10(np.sum(want ** 2) / max(np.sum(err ** 2), 1e-30))
    assert np.median(err) < 1e-6, np.median(err)
    assert err.max() < 5e-3 * max(np.abs(want).max(), 1.0), err.max()
    assert snr > 50.0, snr


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this module's small tensors (the suite runs
    several workers on the host's cores), the caller's count restored."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def setup():
    jm = JModel()
    pnp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    calib = _calib()
    ranges = {pc: j_observe_ranges(jm, pnp, jnp.asarray(calib), batch_size=4, per_channel=pc)
              for pc in (False, True)}
    return jm, pnp, GTCRNMicro.from_params(pnp, device="cpu"), calib, ranges


# -- fake-quant primitives ------------------------------------------------------


def _fq_cases():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((6, 33, 16)) * 2).astype(np.float32)
    w4 = (rng.standard_normal((3, 3, 16, 16)) * 0.3).astype(np.float32)
    w2 = (rng.standard_normal((16, 8)) * 0.3).astype(np.float32)
    lo_v, hi_v = x.min(axis=(0, 1)), x.max(axis=(0, 1)) * 0.8
    return {
        "act8": (x, lambda m: m.act_qparams(np.float32(-1.7), np.float32(2.3), 8)),
        "act16": (x, lambda m: m.act_qparams(np.float32(-1.7), np.float32(2.3), 16)),
        "act8_positive_range": (x, lambda m: m.act_qparams(np.float32(0.2), np.float32(3.0), 8)),
        "act8_per_lane": (x, lambda m: m.act_qparams(lo_v, hi_v, 8)),
        "weight_hwio": (w4, lambda m: m.weight_qparams(_arr(m, w4), 3)),
        "weight_pointwise": (w2, lambda m: m.weight_qparams(_arr(m, w2), 1)),
    }


def _arr(m, v):
    return torch.from_numpy(v) if m is tfq else jnp.asarray(v)


@pytest.mark.parametrize("case", list(_fq_cases()))
def test_fake_quant_matches_jax(case):
    """Params, quantize, dequantize, fake_quant, saturation_fraction: the
    same float32 bits as JAX's; the straight-through gradient is 1."""
    x, make = _fq_cases()[case]
    jqp, tqp = make(jfq), make(tfq)
    for a, b in ((jqp.scale, tqp.scale), (jqp.zero, tqp.zero)):
        np.testing.assert_array_equal(tqp.scale.numpy().shape, np.shape(jqp.scale))
        assert np.asarray(a, np.float32).tobytes() == b.numpy().tobytes()
    assert (jqp.qmin, jqp.qmax) == (tqp.qmin, tqp.qmax)
    xj, xt = jnp.asarray(x), torch.from_numpy(x).requires_grad_()
    jq, tq = jfq.quantize(xj, jqp), tfq.quantize(xt.detach(), tqp)
    assert str(tq.dtype).split(".")[-1] == str(jq.dtype)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tfq.dequantize(tq, tqp).numpy(),
                                  np.asarray(jfq.dequantize(jq, jqp)))
    y = tfq.fake_quant(xt, tqp)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jfq.fake_quant(xj, jqp)))
    y.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))
    assert float(tfq.saturation_fraction(xt.detach(), tqp)) == float(
        jfq.saturation_fraction(xj, jqp))


def test_fake_quant_properties():
    qp = tfq.act_qparams(-1.0, 3.0)
    # zero is exactly representable (zero padding stays exact)
    assert float(tfq.fake_quant(torch.tensor(0.0), qp)) == 0.0
    # values round to within half a scale
    x = torch.linspace(-1.0, 3.0, 1001)
    assert float((tfq.fake_quant(x, qp) - x).abs().max()) <= float(qp.scale) / 2 + 1e-7
    # out-of-range values clip
    assert float(tfq.fake_quant(torch.tensor(100.0), qp)) <= 3.01


def test_int16_mode_finer_than_int8():
    x = torch.linspace(-2, 2, 4001)
    e8 = (tfq.fake_quant(x, tfq.act_qparams(-2.0, 2.0, 8)) - x).abs().max()
    e16 = (tfq.fake_quant(x, tfq.act_qparams(-2.0, 2.0, 16)) - x).abs().max()
    assert float(e16) < float(e8) / 100


def test_weight_qparams_per_channel():
    w = torch.stack([torch.ones((3, 3, 4)), 10 * torch.ones((3, 3, 4))], dim=-1)
    qp = tfq.weight_qparams(w, channel_axis=3)
    assert tuple(qp.scale.shape) == (1, 1, 1, 2)
    # each channel keeps full resolution despite the 10x range difference
    assert float((tfq.fake_quant(w, qp) - w).abs().max()) < 0.05


# -- PTQ ranges -------------------------------------------------------------------


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
def test_percentiles_match_jax(per_channel):
    rng = np.random.default_rng(3)
    for shape in ((4, 18, 129, 3), (4, 16, 33, 16), (2, 18, 8), (1, 5, 2, 3)):
        x = (rng.standard_normal(shape) * rng.uniform(0.1, 3)).astype(np.float32)
        axis = tuple(range(x.ndim - 1)) if per_channel else None
        for p in (99.99, 100.0 - 99.99, 50.0, 100.0):
            want = jax.jit(lambda a, p=p: jnp.percentile(a, p, axis=axis))(jnp.asarray(x))
            got = percentiles(torch.from_numpy(x), (p,), per_channel)[0]
            assert _ulps(got.numpy(), want) <= 1, (shape, p)


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
def test_observe_ranges_matches_jax(setup, per_channel):
    jm, pnp, tm, calib, ranges = setup
    want = ranges[per_channel]
    got = observe_ranges(tm, calib, batch_size=4, per_channel=per_channel)
    assert len(got) == 59 and set(got) == set(want)
    for k in ("encoder/en2/pw1/in", "encoder/en2/pw2/in", "gtcn1/block0/pw1/in",
              "gtcn1/block0/pw3/in", "decoder/de1/tra/gate_in", "sfe/depth_conv/in"):
        assert k in got
    for path, (lo, hi) in want.items():
        bound = max(np.abs(lo).max(), np.abs(hi).max())
        for a, b in zip((lo, hi), got[path]):
            assert np.shape(a) == np.shape(b), path
            assert np.abs(np.asarray(a, np.float32) - b).max() <= 1e-6 * bound, path
    if per_channel:
        assert np.size(got["encoder/en2/pw1/in"][1]) == 8


def test_observer_records_jax_percentiles_of_what_it_sees(setup):
    """The observer's ranges are jnp.percentile (jitted) of the tensors its
    hook receives, within 1 ulp: the forwards' rounding is the only gap to
    JAX's ranges."""
    _, _, tm, calib, _ = setup
    seen = {}

    class Recorder(RangeObserver):
        def act(self, path, x):
            seen[path] = x.numpy().copy()
            return super().act(path, x)

    obs = Recorder()
    with torch.no_grad():
        tm.apply(torch.from_numpy(calib), quant=obs)
    pct = jax.jit(lambda a: (jnp.percentile(a, 100.0 - 99.99), jnp.percentile(a, 99.99)))
    assert len(seen) == 59
    for path, x in seen.items():
        lo, hi = pct(jnp.asarray(x))
        assert _ulps(obs.ranges[path][0].numpy(), lo) <= 1, path
        assert _ulps(obs.ranges[path][1].numpy(), hi) <= 1, path


def test_qparams_from_ranges_match_jax(setup):
    """Frozen params from the same ranges: bit-identical to JAX's."""
    _, _, _, _, ranges = setup
    for bits in (8, 16):
        want = _j_act_qp(ranges[False], bits)
        got = qparams_from_ranges(ranges[False], bits)
        for k, qp in want.items():
            assert got[k].scale.numpy().tobytes() == np.asarray(qp.scale).tobytes(), k
            assert got[k].zero.numpy().tobytes() == np.asarray(qp.zero, np.float32).tobytes(), k


# -- the quantized model -------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "16x8", "per_channel", "v4"])
def test_quantized_apply_matches_jax(setup, mode):
    jm, pnp, tm, _, ranges = setup
    per_channel = mode in ("per_channel", "v4")
    jqp = _j_act_qp(ranges[per_channel], 16 if mode == "16x8" else 8)
    spec = _spec((1, 257, 8, 2), 1)
    want = np.asarray(JQuantizedModel(jm, jqp, v4=mode == "v4").apply(pnp, jnp.asarray(spec)))
    qm = QuantizedModel(tm, act_qp_from_jax(jqp, device="cpu"), v4=mode == "v4")
    got = qm.apply(torch.from_numpy(spec)).numpy()
    assert got.shape == want.shape
    _check_tie_bounds(want, got)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
def test_quantized_streaming_matches_apply(setup, bits, per_channel):
    """The quantized ring step at T=1 and the l2_psum step reproduce the
    quantized apply over 20 frames (the 16-slot ring wraps); at 16x8 the
    quantized model stays close to float32 (tests/quant/test_quant.py:79-139).
    The port's float streaming differs from its apply by ~5e-8 (the convs'
    summation order depends on the window length), where JAX's is exact: at
    16x8 that stays below the JAX test's 1e-5; at int8 a value on a rounding
    tie can flip by one quantum (ROADMAP C), so int8 is held to the tie-aware
    bounds of tests/ops/test_int8_step.py:67-72."""
    _, _, tm, calib, _ = setup
    qm = make_quantized_model(tm, calib, batch_size=4, act_bits=bits,
                              percentile=100.0 if bits == 16 else 99.99,
                              per_channel_acts=per_channel)
    spec = torch.from_numpy(_spec((2, 257, 20, 2), 2))
    off = qm.apply(spec)
    for opts in ({}, {"l2_psum": True}):
        stream, _ = scan_stepper(qm.step, qm.init_state(2, **opts), spec)
        if bits == 16:
            assert float((stream - off).abs().max()) < 1e-5, opts
        else:
            for t in range(spec.shape[2]):
                _check_tie_bounds(off[:, :, t].numpy(), stream[:, :, t].numpy())
    if bits == 16:
        with torch.no_grad():
            assert float((off - tm.apply(spec)).abs().max()) < 0.1


def test_per_channel_grid_tighter():
    x = torch.cat([torch.linspace(-0.1, 0.1, 256)[:, None],
                   torch.linspace(-10.0, 10.0, 256)[:, None]], dim=1)
    pt = tfq.act_qparams(x.min(), x.max(), 8)
    pc = tfq.act_qparams(x.amin(dim=0), x.amax(dim=0), 8)
    e_pt = float((tfq.fake_quant(x, pt) - x)[:, 0].abs().max())
    e_pc = float((tfq.fake_quant(x, pc) - x)[:, 0].abs().max())
    assert e_pc < e_pt / 50


# -- QAT ------------------------------------------------------------------------------


SCHED = dict(warmup_steps=5, decay_until_step=100, max_lr=1e-3)


def _batch(batch=4, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((batch, n)).astype(np.float32) * 0.05
    noisy = clean + rng.standard_normal((batch, n)).astype(np.float32) * 0.02
    return noisy, clean


def test_qat_steps_match_jax(setup):
    """Three QAT steps (int8 fake-quant, freeze_bn=True) on one batch: the
    loss of each and the params after three, against JAX's jitted step; the
    running statistics stay untouched."""
    from gtcrn_micro_tpu.train import trainer as jt
    from gtcrn_micro_tpu.quant.ptq import FakeQuantizer as JFakeQuantizer
    from gtcrn_micro_tpu.train.scheduler import WarmupCosineConfig as JSched
    from gtcrn_micro_tpu_torch.train.scheduler import WarmupCosineConfig
    from gtcrn_micro_tpu_torch.train.trainer import make_optimizer, make_train_step

    jm, pnp, _, _, ranges = setup
    jqp = _j_act_qp(ranges[False])
    params = jax.tree.map(jnp.asarray, pnp)
    opt = jt.make_optimizer(params, JSched(**SCHED))
    jstep = jax.jit(jt.make_train_step(jm, opt, quantizer=JFakeQuantizer(jqp), freeze_bn=True))
    jstate = opt.init(params)

    model = GTCRNMicro.from_params(pnp, device="cpu")
    topt = make_optimizer(model, WarmupCosineConfig(**SCHED), device="cpu")
    tstep = make_train_step(model, topt, quantizer=FakeQuantizer(act_qp_from_jax(jqp, "cpu")),
                            freeze_bn=True, device="cpu")
    noisy, clean = _batch()
    for _ in range(3):
        params, jstate, jloss = jstep(params, jstate, noisy, clean)
        loss = tstep(noisy, clean)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = {k: np.asarray(v) for k, v in flatten(jax.tree.map(np.asarray, params)).items()}
    got = {k: v.detach().numpy() for k, v in flatten(model.params()).items()}
    start = flatten(pnp)
    for k, v in want.items():
        if "running" in k or "erb" in k:
            np.testing.assert_array_equal(got[k], np.asarray(start[k]), err_msg=k)
        else:
            tol = 1.2e-3 if k.endswith(".b") else 1e-4
            np.testing.assert_allclose(got[k], v, rtol=0, atol=tol, err_msg=k)


def test_qat_improves_post_quant_loss(setup):
    """A few straight-through QAT steps reduce the loss of the quantized
    model measured after quantization, and freeze_bn keeps the running
    statistics (tests/quant/test_quant.py:140-193)."""
    from gtcrn_micro_tpu_torch.dsp.stft import hann_window, stft
    from gtcrn_micro_tpu_torch.train.loss import hybrid_loss
    from gtcrn_micro_tpu_torch.train.scheduler import WarmupCosineConfig
    from gtcrn_micro_tpu_torch.train.trainer import make_optimizer, make_train_step

    _, pnp, _, _, _ = setup
    model = GTCRNMicro.from_params(pnp, device="cpu")
    rng = np.random.default_rng(2)
    clean = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32) * 0.05)
    noisy = clean + torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32) * 0.02)
    window = hann_window(512, device="cpu")
    specs = stft(noisy, window)
    quantizer = FakeQuantizer(qparams_from_ranges(observe_ranges(model, specs, batch_size=2)))

    def post_quant_loss():
        with torch.no_grad():
            enh = model.apply(specs, quant=quantizer)
            return float(hybrid_loss(enh, stft(clean, window)))

    before = post_quant_loss()
    running = model.encoder.en0.bn.running_mean.clone()
    opt = make_optimizer(model, WarmupCosineConfig(warmup_steps=2, decay_until_step=40,
                                                   max_lr=2e-3), device="cpu")
    step = make_train_step(model, opt, quantizer=quantizer, freeze_bn=True, device="cpu")
    for _ in range(10):
        step(noisy, clean)
    after = post_quant_loss()
    assert np.isfinite(after) and after < before, (before, after)
    assert torch.equal(model.encoder.en0.bn.running_mean, running)
