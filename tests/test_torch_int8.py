"""The port's full-integer int8 serving step (gtcrn_micro_tpu_torch.ops.
int8_step.Int8Serving) held against the JAX package's and against the
port's own fake-quant step, on the CPU (its products as int32 matmuls).

The setup is tests/ops/test_int8_step.py's: the JAX init (PRNGKey(0)), its
BN-folded params, ranges observed on the folded model over the seeded
calibration batch ``(4, 257, 16, 2) * 0.3``, int8 params carried across bit
for bit.  The JAX step runs eagerly (division by the scale as such; under
jit XLA multiplies by its reciprocal, another float32 number).

Bounds (tests/ops/test_int8_step.py:67-72; the integer accumulators are
exact, but a pre-quantization value that lands on a rounding tie flips by
one quantum with one ulp of float association): median frame max-abs <
1e-6, worst frame < 5e-3 max|y|, every frame's SNR > 50 dB.  Measured at B=2
over 20 frames: against JAX max 4.5e-8, 138 dB, rings equal; against the
port's fake-quant step 136 dB in most frames, 57.7 dB where a tie flips.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu.models.folding import fold_bn_params as j_fold
from gtcrn_micro_tpu.ops.int8_step import Int8Serving as JInt8Serving
from gtcrn_micro_tpu.quant.fake_quant import act_qparams as j_act_qparams
from gtcrn_micro_tpu.quant.ptq import observe_ranges as j_observe_ranges
from gtcrn_micro_tpu_torch.io.params import act_qp_from_jax, state_from_jax
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro
from gtcrn_micro_tpu_torch.ops.int8_step import Int8Serving, int_matmul
from gtcrn_micro_tpu_torch.quant.ptq import QuantizedModel

B, T, T_CARRY = 2, 20, 12


def _frame_checks(want, got):
    err = np.abs(got - want)
    num, den = np.sum(want ** 2), np.sum(err ** 2)
    return err.max(), np.abs(want).max(), (10 * np.log10(num / den) if den > 0 else np.inf)


def _assert_bounds(rows):
    """rows: (max-abs error, max|y|, SNR) per frame."""
    errs = sorted(r[0] for r in rows)
    assert errs[len(errs) // 2] < 1e-6, errs
    assert errs[-1] < 5e-3 * max(max(r[1] for r in rows), 1.0), errs
    assert min(r[2] for r in rows) > 50.0, [r[2] for r in rows]


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
    params = jm.init(jax.random.PRNGKey(0))
    pnp = jax.tree.map(np.asarray, params)
    folded = jax.tree.map(np.asarray, j_fold(params))
    calib = np.random.default_rng(0).standard_normal((4, 257, 16, 2)).astype(np.float32) * 0.3
    ranges = j_observe_ranges(jm, folded, jnp.asarray(calib), batch_size=4)
    jqp = {p: j_act_qparams(jnp.float32(lo), jnp.float32(hi), 8) for p, (lo, hi) in ranges.items()}
    tqp = act_qp_from_jax(jqp, device="cpu")
    sim = QuantizedModel(GTCRNMicro.from_params(folded, device="cpu"), tqp)
    return jm, params, pnp, jqp, tqp, sim


@pytest.fixture(scope="module")
def jax_run(setup):
    """The JAX int8 step over T frames (eager): spec, outputs, the state
    after T_CARRY frames and after T."""
    jm, params, _, jqp, _, _ = setup
    spec = np.random.default_rng(1).standard_normal((B, 257, T, 2)).astype(np.float32) * 0.3
    serving = JInt8Serving(jm, params, jqp, carry_dtype=jnp.float32)
    st, outs, mid = serving.init_state(B), [], None
    for t in range(T):
        if t == T_CARRY:
            mid = jax.tree.map(np.asarray, st)
        y, st = serving.step(st, jnp.asarray(spec[:, :, t : t + 1]))
        outs.append(np.asarray(y))
    return spec, outs, mid, jax.tree.map(np.asarray, st)


def _port(setup, **kw):
    _, _, pnp, _, tqp, _ = setup
    return Int8Serving(pnp, kw.pop("act_qp", tqp), carry_dtype=torch.float32, device="cpu", **kw)


def test_int8_step_matches_jax(setup, jax_run):
    spec, outs, _, jstate = jax_run
    serving = _port(setup)
    st, rows = serving.init_state(B), []
    for t in range(T):
        y, st = serving.step(st, torch.from_numpy(spec[:, :, t : t + 1]))
        assert y.shape == (B, 257, 1, 2) and y.dtype == torch.float32
        rows.append(_frame_checks(outs[t], y.numpy()))
    _assert_bounds(rows)
    assert st["step"] == int(jstate["step"]) == T & 15
    # the rings hold the same int8 values (a tie flip would move one by 1)
    for k, v in jstate.items():
        if k != "step":
            assert st[k].dtype == torch.int8
            d = np.abs(st[k].numpy().astype(np.int32) - v.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, k


def test_int8_step_matches_fake_quant_step(setup):
    """The integer step == the port's fake-quant step on the folded params
    across a full ring wrap."""
    *_, sim = setup
    serving = _port(setup)
    spec = np.random.default_rng(1).standard_normal((B, 257, T, 2)).astype(np.float32) * 0.3
    st8, st_sim, rows = serving.init_state(B), sim.init_state(B), []
    for t in range(T):
        frame = torch.from_numpy(spec[:, :, t : t + 1])
        y8, st8 = serving.step(st8, frame)
        ys, st_sim = sim.step(st_sim, frame)
        rows.append(_frame_checks(ys.numpy(), y8.numpy()))
    _assert_bounds(rows)


def test_jax_int8_state_continues_in_port(setup, jax_run):
    """A JAX int8 state after 12 frames, carried across, continues in the
    port as it does in JAX."""
    spec, outs, mid, _ = jax_run
    st = state_from_jax(mid, device="cpu")
    assert st["step"] == T_CARRY and all(v.dtype == torch.int8 for k, v in st.items()
                                         if k != "step")
    serving = _port(setup)
    rows = []
    for t in range(T_CARRY, T):
        y, st = serving.step(st, torch.from_numpy(spec[:, :, t : t + 1]))
        rows.append(_frame_checks(outs[t], y.numpy()))
    _assert_bounds(rows)


@pytest.mark.parametrize("mutation", ["pad_with_int8_zero", "rings_filled_with_int8_zero",
                                      "correction_off_by_one"])
def test_int8_zero_point_canary(setup, monkeypatch, mutation):
    """The agreement with the fake-quant step pins every use of the zero
    points: padding the frequency axis with int8 0, filling the rings with
    int8 0, or correcting the accumulators with ``z + 1`` is detected (min
    frame SNR < 50 dB).  tests/ops/test_int8_step.py's canary moves a
    boundary's zero point by one in every use at once, which cancels in the
    integer algebra except where a value clips, and its ``run`` starts its
    worst SNR at 0 dB, so it holds for any output (ROADMAP C)."""
    from gtcrn_micro_tpu_torch.ops import int8_step

    *_, sim = setup
    spec = np.random.default_rng(2).standard_normal((1, 257, 8, 2)).astype(np.float32) * 0.3

    def min_snr():
        serving = _port(setup)
        st8, st_sim, worst = serving.init_state(1), sim.init_state(1), np.inf
        for t in range(8):
            frame = torch.from_numpy(spec[:, :, t : t + 1])
            y8, st8 = serving.step(st8, frame)
            ys, st_sim = sim.step(st_sim, frame)
            worst = min(worst, _frame_checks(ys.numpy(), y8.numpy())[2])
        return worst

    assert min_snr() > 50.0
    if mutation == "pad_with_int8_zero":
        monkeypatch.setattr(int8_step._Act, "pad_f",
                            lambda self, q, lo, hi: torch.nn.functional.pad(q, (0, 0, lo, hi)))
    elif mutation == "rings_filled_with_int8_zero":
        init = Int8Serving.init_state

        def zero_rings(self, batch):
            st = init(self, batch)
            return {k: v if k == "step" else torch.zeros_like(v) for k, v in st.items()}

        monkeypatch.setattr(Int8Serving, "init_state", zero_rings)
    else:
        mm = Int8Serving._mm
        monkeypatch.setattr(Int8Serving, "_mm", staticmethod(lambda q, m: mm(q, m) - m["cs"]))
    assert min_snr() < 50.0


def test_int8_state_is_int8(setup):
    serving = _port(setup)
    st = serving.init_state(3)
    rings = {k: v for k, v in st.items() if k != "step"}
    assert len(rings) == 20  # 6 GTConv + 6 TRA energy + 8 TCN
    assert all(v.dtype == torch.int8 for v in rings.values())
    # the rings hold each boundary's zero point, not int8 zeros
    for key in ("gtcn1/block0/conv2/in", "encoder/en2/depth_conv/in"):
        assert bool((st[key] == serving.A[key].zero).all())
    assert bool((st["decoder/de1/tra/ring"] == serving.A["decoder/de1/tra/energy"].zero).all())
    # half the bytes of the layered model's bf16 ring state (the same 20
    # rings, keyed there by the ring's layer)
    bf16 = GTCRNMicro(device="cpu").init_state(3, dtype=torch.bfloat16)
    assert len(bf16) == len(st)
    int8_bytes = sum(v.numel() * v.element_size() for v in rings.values())
    bf16_bytes = sum(v.numel() * v.element_size() for k, v in bf16.items() if k != "step")
    assert 2 * int8_bytes == bf16_bytes


def test_int8_step_wraps_counter(setup):
    serving = _port(setup)
    st = serving.init_state(1)
    for _ in range(17):
        _, st = serving.step(st, torch.zeros((1, 257, 1, 2)))
    assert st["step"] == 1  # 17 & 15


@pytest.mark.parametrize("layer", ["en0", "en1", "de3", "de4", "gtcn1b0", "en2", "de0"])
def test_padded_product_equals_unpadded(setup, layer):
    """The zero-padded int8 weights (K and N to multiples of 8, as
    ``torch._int_mm`` needs) give the unpadded int32 product exactly."""
    serving = _port(setup)
    w = serving.W[layer]
    if layer in ("en0", "en1"):
        mixes = [w]
    elif layer in ("de3", "de4"):
        mixes = [w["even"], w["odd"]]
    elif layer == "gtcn1b0":
        mixes = [w["pw1"], w["pw3"]]
    else:
        mixes = [w["pw1"], w["pw2"]] + w["dw"].get("taps", [])
    rng = np.random.default_rng(4)
    for m in mixes:
        wp = m["w"].numpy()
        assert wp.shape[0] % 8 == 0 and wp.shape[1] % 8 == 0
        k = int(np.nonzero(np.abs(wp).sum(axis=1))[0].max()) + 1  # the unpadded K
        n = m["n"]
        assert not wp[k:].any() and not wp[:, n:].any()
        q = torch.from_numpy(rng.integers(-128, 128, (2, 33, k), dtype=np.int8))
        got = Int8Serving._mm(q, m).numpy()
        want = q.numpy().astype(np.int64) @ wp[:k, :n].astype(np.int64)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(m["cs"].numpy(), wp[:k, :n].astype(np.int32).sum(axis=0))
    a = torch.from_numpy(rng.integers(-128, 128, (40, 16), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (16, 8), dtype=np.int8))
    np.testing.assert_array_equal(int_matmul(a, b).numpy(),
                                  a.numpy().astype(np.int64) @ b.numpy().astype(np.int64))


def test_int8_step_needs_int8_params(setup):
    from gtcrn_micro_tpu_torch.quant.fake_quant import act_qparams

    *_, tqp, _ = setup
    bad = dict(tqp)
    bad["sfe/depth_conv/in"] = act_qparams(-1.0, 1.0, 16)
    with pytest.raises(ValueError, match="act_bits=8"):
        _port(setup, act_qp=bad)
