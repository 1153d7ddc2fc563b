"""The port's cohort server (gtcrn_micro_tpu_torch.serve) held against the JAX
package's serve.py, on the CPU.

The audio-mode server runs the fused backends (the plain version on CPU
tensors) with the GEMM-form DFT; the JAX reference is ``CohortServer(
GTCRNMicro(), ..., mode="audio", dtype=float32)`` on the same numpy params
and audio.  Tolerance 2e-6 on audio of scale 0.3: the same bound as the
fused-model parity (tests/ops/test_fused_step.py:39-44), tighter than the
2e-5 of the JAX package's own GEMM-form audio server test
(tests/test_serve.py:274); measured gap ~2e-7.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.models import GTCRNMicro
from gtcrn_micro_tpu.serve import CohortServer as JServer
from gtcrn_micro_tpu_torch.io.params import params_from_numpy
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicroConfig
from gtcrn_micro_tpu_torch.ops.fused_grid import GridFusedGTCRNMicro
from gtcrn_micro_tpu_torch.ops.fused_step import FusedGTCRNMicro, LayoutGTCRNMicro
from gtcrn_micro_tpu_torch.serve import CohortPlan, CohortServer, plan_cohorts

BATCH, COHORTS, HOPS = 8, 2, 20
TOL = 2e-6


@pytest.fixture(scope="module")
def params():
    p = GTCRNMicro().init(jax.random.PRNGKey(0))
    return p, params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


@pytest.fixture(scope="module")
def audio_run(params):
    """Seeded audio and the JAX server's output for it."""
    jp, _ = params
    rng = np.random.default_rng(1)
    x = rng.standard_normal((COHORTS, BATCH, 256 * HOPS)).astype(np.float32) * 0.3
    srv = JServer(GTCRNMicro(), jp, batch=BATCH, n_cohorts=COHORTS,
                  dtype=jnp.float32, mode="audio")
    outs = [[] for _ in range(COHORTS)]
    for t in range(HOPS):
        got = srv.round_robin([jnp.asarray(x[c][:, 256 * t : 256 * (t + 1)])
                               for c in range(COHORTS)])
        for c in range(COHORTS):
            outs[c].append(np.asarray(got[c]))
    return x, np.stack([np.concatenate(o, axis=-1) for o in outs])


def _server(tp, model_cls=GridFusedGTCRNMicro, batch=BATCH, n_cohorts=COHORTS,
            mode="audio"):
    model = model_cls(tp, dtype=torch.float32, device="cpu")
    return CohortServer(model, tp, batch=batch, n_cohorts=n_cohorts,
                        dtype=torch.float32, mode=mode, device="cpu")


def test_plan_math():
    p = plan_cohorts(step_time_s=0.00165, batch=8192)
    assert p.n_cohorts == 9  # 9*1.65=14.85<=16ms; 1.65+16/9=3.43<=10ms
    assert p.streams == 73728
    assert p.realtime_ok
    assert abs(p.worst_latency_s - (0.00165 + 0.016 / 9)) < 1e-9
    assert p.phase_of(3) == 3 * 0.016 / 9

    too_slow = plan_cohorts(step_time_s=0.017, batch=1024)
    assert too_slow.n_cohorts == 0 and not too_slow.realtime_ok


def test_throughput_plan_math():
    plan = plan_cohorts(0.003, batch=12288, budget_s=0.040, chunk_hops=2)
    assert plan.n_cohorts == 10 and plan.interval_s == 0.032
    assert plan.worst_latency_s == pytest.approx(0.016 + 0.0032 + 0.003)
    assert not plan.realtime_ok
    assert plan_cohorts(0.003, batch=12288).n_cohorts == 5
    p1 = CohortPlan(batch=8192, n_cohorts=9, step_time_s=0.00165)
    assert p1.keep_up_ok and p1.realtime_ok


@pytest.mark.parametrize("model_cls", [GridFusedGTCRNMicro, FusedGTCRNMicro])
def test_audio_server_matches_jax(params, audio_run, model_cls):
    _, tp = params
    x, jout = audio_run
    srv = _server(tp, model_cls)
    outs = [[] for _ in range(COHORTS)]
    for t in range(HOPS):
        got = srv.round_robin([torch.from_numpy(x[c][:, 256 * t : 256 * (t + 1)])
                               for c in range(COHORTS)])
        for c in range(COHORTS):
            assert got[c].shape == (BATCH, 256) and got[c].dtype == torch.float32
            outs[c].append(got[c].numpy())
    assert srv.frames_served == COHORTS * HOPS
    tout = np.stack([np.concatenate(o, axis=-1) for o in outs])
    np.testing.assert_allclose(tout, jout, atol=TOL)


class _Gain:
    """A stand-in model for both servers: halves the spectrum (exact in
    bf16), so the bf16 comparison below sees only the two servers' DSP."""

    config = GTCRNMicroConfig()
    dtype, device = torch.bfloat16, torch.device("cpu")

    def init_state(self, batch, dtype=None):
        return {}

    def step(self, params, state, spec):
        return spec * 0.5, state


def test_audio_server_bf16_matches_jax():
    """The audio-mode server in bf16 with dft="mxu": both GEMMs take bf16
    operands, and the output is rounded to bf16 once after the overlap-add,
    as in the JAX server.  The float32 values both sides round agree to
    ~2e-7, so every sample is within one bf16 step (rtol 2^-7) plus the
    float32 audio bound 2e-6 of JAX's."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((COHORTS, BATCH, 256 * HOPS)).astype(np.float32) * 0.3
    jsrv = JServer(_Gain(), {}, batch=BATCH, n_cohorts=COHORTS, dtype=jnp.bfloat16,
                   mode="audio")
    tsrv = CohortServer(_Gain(), None, batch=BATCH, n_cohorts=COHORTS,
                        dtype=torch.bfloat16, mode="audio", device="cpu")
    for t in range(HOPS):
        chunks = [torch.from_numpy(x[c][:, 256 * t : 256 * (t + 1)]).to(torch.bfloat16)
                  for c in range(COHORTS)]
        got = tsrv.round_robin(chunks)
        want = jsrv.round_robin([jnp.asarray(c.float().numpy(), jnp.bfloat16) for c in chunks])
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                       rtol=2.0**-7, atol=TOL)


def _ring_items(srv, cohort):
    return [(k, v) for k, v in srv._states[cohort][0].items() if k != "step"]


def test_admission_lifecycle(params):
    _, tp = params
    srv = _server(tp, batch=2, n_cohorts=2, mode="spec")
    a = srv.admit(0)
    b = srv.admit(0)
    assert {a, b} == {0, 1}
    with pytest.raises(RuntimeError):
        srv.admit(0)
    assert srv.next_cohort() == 1
    srv.release(0, a)
    srv.step(0, torch.ones((2, 257, 1, 2)))


def test_reset_slot_zeroes_batch_column(params):
    """The fused rings are (L, *frame, B): a reset zeroes the slot's column
    (last axis) of every ring and its row of the DSP buffers, and leaves the
    other streams alone.  (The JAX server zeroes axis 0, which for the fused
    layouts is the ring axis.)"""
    _, tp = params
    srv = _server(tp, batch=3, n_cohorts=1)
    rng = np.random.default_rng(2)
    for _ in range(3):
        srv.step(0, torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32)))
    srv.reset_slot(0, 1)
    for k, v in _ring_items(srv, 0):
        assert v.shape[-1] == 3, k
        assert float(v[..., 1].abs().max()) == 0.0, k
        assert float(v[..., 0].abs().max()) > 0.0, k
        assert float(v[..., 2].abs().max()) > 0.0, k
    d = srv._dsp[0][0]
    for buf in (d.in_buf, d.ola_buf):
        assert float(buf[1].abs().max()) == 0.0
        assert float(buf[0].abs().max()) > 0.0 and float(buf[2].abs().max()) > 0.0


def test_slot_churn_second_stream_independent_of_first(params):
    """admit -> stream -> release -> admit again: the recycled slot is reset,
    so the second stream's output carries nothing of the first's history."""
    _, tp = params
    srv = _server(tp, batch=2, n_cohorts=1)
    rng = np.random.default_rng(3)
    loud = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
    a = srv.admit(0)
    b = srv.admit(0)
    for _ in range(4):
        srv.step(0, loud)
    srv.release(0, a)
    a2 = srv.admit(0)  # the cohort is full: the recycled slot comes back
    assert a2 == a
    for k, v in _ring_items(srv, 0):
        assert float(v[..., a2].abs().max()) == 0.0, k
        assert float(v[..., b].abs().max()) > 0.0, k

    fresh = _server(tp, batch=2, n_cohorts=1)
    second = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
    for _ in range(3):
        got = srv.step(0, second)
        want = fresh.step(0, second)
    np.testing.assert_allclose(got[a2].numpy(), want[a2].numpy(), atol=1e-6)

    # clean slots are preferred, and an explicit reset returns a recycled
    # slot to the clean pool
    srv2 = _server(tp, batch=2, n_cohorts=1)
    first = srv2.admit(0)
    srv2.step(0, loud)
    srv2.release(0, first)
    assert srv2.admit(0) != first
    srv2.reset_slot(0, first)
    assert first in srv2._free[0] and first not in srv2._recycled[0]


def test_silence_in_gives_exact_zero_out(params):
    _, tp = params
    srv = _server(tp, batch=4, n_cohorts=1)
    rng = np.random.default_rng(4)
    for _ in range(6):
        x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
        x[2] = 0.0
        out = srv.step(0, x)
        assert torch.isfinite(out).all()
        assert float(out[2].abs().max()) == 0.0
    assert float(out[0].abs().max()) > 0.0


def test_plain_backend_serves_and_options_are_checked(params):
    _, tp = params
    srv = _server(tp, LayoutGTCRNMicro, batch=2, n_cohorts=1)
    assert srv.step(0, torch.zeros((2, 256))).shape == (2, 256)
    with pytest.raises(ValueError, match="does not divide"):
        CohortServer(None, tp, batch=3, n_cohorts=1, mesh=["cpu", "cpu"])
    with pytest.raises(ValueError):
        CohortServer(None, tp, batch=2, n_cohorts=1, device="cpu", chunk_hops=2)
    with pytest.raises(ValueError):
        CohortServer(None, tp, batch=2, n_cohorts=1, device="cpu", chunk_hops=3)
    with pytest.raises(ValueError):
        CohortServer(None, tp, batch=2, n_cohorts=1, device="cpu", mode="video")
