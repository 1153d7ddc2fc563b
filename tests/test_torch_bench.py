"""The port's headline bench (gtcrn_micro_tpu_torch/bench.py) held against the
root bench.py, on the CPU.

- The schedule: each scenario of tests/test_bench_schedule.py runs through
  both ``main``s with the same fake ``measure_round_robin`` /
  ``measure_step_latency`` / ``measure_rtt`` and the root bench's
  ``CHAMPIONS``; both must make the same sequence of measurements (batch,
  K, state options) and print the same single JSON line.  On the layered
  backend the sequences are equal; on the default grid backend (kernel B2:
  one ring layout) the port skips the two stretch phases, so its sequence
  is the root bench's without its l2_psum calls, and its JSON line the same.
- ``_verify``'s verdict equals the root bench's over a grid of step times
  and K, edges included; the signal path prints no JSON before anything is
  verified and the best line after.
- ``measure_round_robin`` on the CPU (the plain version of the kernels):
  finite, every cohort stepped ``rounds * repeats + 1`` times, its outputs
  and states bit-identical to a ``CohortServer`` stepped the same way.
"""

import json
import signal

import numpy as np
import pytest
import torch

import bench as jbench
from gtcrn_micro_tpu_torch import bench
from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params
from gtcrn_micro_tpu_torch.ops.fused_step import LayoutGTCRNMicro
from gtcrn_micro_tpu_torch.serve import CohortServer

STEP_LAT = (0.0190, 0.0185, 0.0199)


def _champion_first(mod, b, k, kw):
    return 0.00165 if b == 8192 else 0.0190


def _alternate_rescue(mod, b, k, kw):
    return {8192: 0.0019, 12288: 0.00263, 9216: 0.0020}[b]


def _walk_down(mod, b, k, kw):
    return {8192: 0.0019, 12288: 0.0032, 9216: 0.0022}[b]


def _psum_stretch(mod, b, k, kw):
    return 0.00158 if kw.get("l2_psum") else 0.00165


def _deadline(mod, b, k, kw):
    mod._DEADLINE[0] = 0.0  # budget gone the moment the first verify ends
    return 0.00165


SCENARIOS = {"champion_first": _champion_first, "alternate_rescue": _alternate_rescue,
             "walk_down": _walk_down, "psum_stretch": _psum_stretch, "deadline": _deadline}
STATE_OPTS = ("l2_psum", "store_dtype")


def _opts(kw):
    """State options by name, dtypes by their name (jnp and torch alike)."""
    return tuple(sorted((k, str(v).split(".")[-1].strip("'>")) for k, v in kw.items()
                        if k in STATE_OPTS))


def _run(mod, scenario, capsys, argv=None):
    """(measurements, the JSON lines, all lines) of ``mod.main`` under the
    scenario's fakes."""
    calls = []
    fake = SCENARIOS[scenario]

    def fake_rr(model, params, b, k, **kw):
        calls.append(("rr", b, k, _opts(kw)))
        return fake(mod, b, k, kw)

    def fake_lat(model, params, b, **kw):
        calls.append(("lat", b))
        return STEP_LAT

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(mod._BEST, "streams", 0)
        mp.setitem(mod._BEST, "emitted", False)
        mp.setattr(mod, "measure_rtt", lambda *a, **k: 0.0)
        mp.setattr(mod, "measure_round_robin", fake_rr)
        mp.setattr(mod, "measure_step_latency", fake_lat)
        mp.setattr(mod, "CHAMPIONS", jbench.CHAMPIONS)
        capsys.readouterr()
        mod.main() if argv is None else mod.main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    return calls, [ln for ln in lines if ln.startswith("{")], lines


@pytest.fixture(scope="module")
def jax_runs():
    return {}


@pytest.mark.parametrize("scenario,backend", [(s, "layered") for s in SCENARIOS]
                         + [(s, "grid") for s in SCENARIOS if s != "psum_stretch"])
def test_schedule_matches_root_bench(scenario, backend, jax_runs, capsys):
    if scenario not in jax_runs:
        jax_runs[scenario] = _run(jbench, scenario, capsys)
    j_calls, j_json, _ = jax_runs[scenario]
    calls, payloads, lines = _run(bench, scenario, capsys,
                                  ["--device", "cpu", "--backend", backend])
    assert len(j_json) == 1 and payloads == j_json, "the same single JSON line"
    if backend == "layered":
        assert calls == j_calls
    else:
        assert calls == [c for c in j_calls if c[0] == "lat" or not c[3]]
        assert any("stretch skipped" in ln for ln in lines)
    assert any(c[3] for c in j_calls) == (scenario != "deadline")
    verified = [ln for ln in lines if ln.startswith("# verified: ")]
    assert len(verified) == 1
    plan = json.loads(verified[0][len("# verified: "):])
    assert plan["backend"] == backend and plan["device"] == "cpu" and plan["dtype"] == "bf16"
    value = json.loads(payloads[0])["value"]
    b, k = plan["plan"]["batch"], plan["plan"]["cohorts"]
    step = plan["plan"]["step_s"]
    assert b * k == value and k * step <= bench.FRAME_S
    assert step + bench.FRAME_S / k <= bench.LATENCY_BUDGET_S


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 16])
def test_verify_verdict_matches_root_bench(k, monkeypatch, capsys):
    # a step grid around both edges: K*step = 16 ms and step + 16/K = 10 ms
    steps = sorted({0.016 / k, 0.010 - 0.016 / k, *np.linspace(1e-4, 0.02, 41).tolist()})
    steps = [s for s in steps if s > 0]
    steps += [np.nextafter(s, 1.0) for s in steps] + [np.nextafter(s, 0.0) for s in steps]
    for mod in (jbench, bench):
        monkeypatch.setitem(mod._BEST, "streams", 0)
        monkeypatch.setitem(mod._BEST, "cfg", None)
    for s in steps:
        s = float(s)
        monkeypatch.setattr(jbench, "measure_round_robin", lambda *a, **kw: s)
        monkeypatch.setattr(bench, "measure_round_robin", lambda *a, **kw: s)
        assert bench._verify(None, None, 8192, k, 0.0) == jbench._verify(None, None, 8192, k, 0.0)
        assert bench.max_cohorts(s) == jbench.max_cohorts(s)
    assert bench._BEST["streams"] == jbench._BEST["streams"]
    capsys.readouterr()


def test_signal_path_prints_best_verified_only(monkeypatch, capsys):
    exits = []
    monkeypatch.setattr(bench.os, "_exit", exits.append)
    monkeypatch.setitem(bench._BEST, "streams", 0)
    monkeypatch.setitem(bench._BEST, "emitted", False)
    bench._on_signal(signal.SIGTERM, None)
    out = capsys.readouterr().out
    assert exits == [0]
    assert not any(ln.startswith("{") for ln in out.splitlines())
    assert "nothing verified" in out
    monkeypatch.setitem(bench._BEST, "streams", 7 * 8192)
    bench._on_signal(signal.SIGTERM, None)
    bench._emit()  # idempotent
    payloads = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert exits == [0, 0] and len(payloads) == 1
    assert json.loads(payloads[0]) == {"metric": "concurrent_realtime_streams", "value": 57344,
                                       "unit": "streams", "vs_baseline": 57344 / 4096}


def test_handlers_installed_only_by_main(capsys):
    before = signal.getsignal(signal.SIGTERM)
    assert before is not bench._on_signal
    bench.main(["--device", "cpu", "--budget", "0"])  # nothing runs: the budget is spent
    assert signal.getsignal(signal.SIGTERM) is before
    assert signal.getsignal(signal.SIGINT) is not bench._on_signal
    out = capsys.readouterr().out.splitlines()
    assert [ln for ln in out if ln.startswith("{")] == [json.dumps(
        {"metric": "concurrent_realtime_streams", "value": 0, "unit": "streams",
         "vs_baseline": 0.0})]


def test_measure_round_robin_on_cpu(monkeypatch):
    torch.set_num_threads(2)
    params = init_params(torch.Generator().manual_seed(0), device="cpu")
    servers = []

    class Recording(CohortServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.outs = {}
            servers.append(self)

        def step(self, cohort, frame):
            out = super().step(cohort, frame)
            self.outs[cohort] = out
            return out

    monkeypatch.setattr(bench, "CohortServer", Recording)
    B, K, rounds, repeats = 8, 2, 3, 3
    model = LayoutGTCRNMicro(params, dtype=torch.bfloat16, device="cpu")
    detail = {}
    rr = bench.measure_round_robin(model, params, B, K, rounds=rounds, repeats=repeats,
                                   detail=detail)
    assert np.isfinite(rr) and rr > 0
    assert detail == {}  # CUDA events and torch.profiler need a card
    (srv,) = servers
    n = rounds * repeats + 1
    assert srv._frames == [n] * K
    ref = CohortServer(LayoutGTCRNMicro(params, dtype=torch.bfloat16, device="cpu"), params,
                       batch=B, n_cohorts=K, dtype=torch.bfloat16, mode="audio", dft="mxu",
                       device="cpu")
    chunk = torch.zeros((B, 256), dtype=torch.bfloat16)
    for _ in range(n):
        outs = ref.round_robin([chunk] * K)
    for c in range(K):
        st, ref_st = srv._states[c][0], ref._states[c][0]
        assert st["step"] == ref_st["step"] == n % 16
        assert all(torch.equal(st[name], ref_st[name]) for name in st if name != "step")
        assert torch.equal(srv._dsp[c][0][0].ola_buf, ref._dsp[c][0][0].ola_buf)
        assert torch.equal(srv.outs[c], outs[c])
        assert torch.isfinite(outs[c].float()).all()
