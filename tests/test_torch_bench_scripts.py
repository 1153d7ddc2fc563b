"""The port's measuring scripts (gtcrn_micro_tpu_torch/scripts/) held against
the root scripts/ they port, on the CPU.

- ``roofline.accounted_floors`` equals the JAX script's for the full-width
  model at 8,192 streams, exactly (the JAX script is loaded by its path).
- The verdict formulas: ``throughput_mode.keep_up`` against the JAX
  package's ``CohortPlan``; ``bench_int8.rt_verdict``,
  ``train_speed.audio_multiple``, ``serve_soak.pct`` and
  ``sweep_cohort.max_cohorts`` against the JAX scripts' (whose source lines
  are checked to still read so).
- The soak runs 0.5 s at 4 streams x 2 cohorts with admission churn: its
  JSON has every key of the JAX soak's report, every output is finite, and
  each readmitted slot starts from zero state.
- ``profile_serving.categorize`` maps CUDA kernel names to their groups.
- Every script's ``main`` runs on the CPU at a tiny size (the control flow;
  no time from it is a device number).
"""

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from gtcrn_micro_tpu.models.gtcrn_micro import GTCRNMicro as JModel
from gtcrn_micro_tpu.serve import CohortPlan as JPlan
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro
from gtcrn_micro_tpu_torch.scripts import (
    bench_int8,
    profile_serving,
    profile_train,
    roofline,
    serve_soak,
    sweep_cohort,
    throughput_mode,
    train_speed,
)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_scripts_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _source(name):
    return (ROOT / "scripts" / f"{name}.py").read_text()


def test_accounted_floors_equal_jax():
    jroof = _jax_script("roofline")
    want = jroof.accounted_floors(JModel(), 8192)
    got = roofline.accounted_floors(GTCRNMicro(device="cpu"), 8192)
    assert got == want
    assert set(got) == {"ideal_per_stream", "whole_state_per_stream"}


def test_keep_up_and_rate_formulas_equal_jax():
    steps = np.concatenate([np.linspace(1e-4, 0.08, 57), [0.002, 0.004, 0.008, 0.016, 0.032]])
    for t in (1, 2, 4, 8, 16):
        for k in range(1, 13):
            for s in steps:
                s = float(s)
                p = JPlan(batch=12288, n_cohorts=k, step_time_s=s, chunk_hops=t)
                assert throughput_mode.keep_up(12288, k, t, s) == (
                    p.keep_up_ok, p.worst_latency_s, p.streams)
    assert 'rt = "RT" if lat < 0.010 else "over"' in _source("bench_int8")
    assert "{audio_s / t:7.0f}x real-time" in _source("train_speed")
    for s in (0.0099, 0.010, np.nextafter(0.010, 0.0), 0.0101, 0.5):
        assert bench_int8.rt_verdict(float(s)) == ("RT" if s < 0.010 else "over")
    for b, crop, t in ((16, 8.0, 0.07), (64, 8.0, 0.2), (8, 10.0, 0.0123)):
        assert train_speed.audio_multiple(b, crop, t) == b * crop / t
    jsweep = _jax_script("sweep_cohort")
    for s in np.linspace(1e-4, 0.012, 97):
        assert sweep_cohort.max_cohorts(float(s)) == jsweep.max_cohorts(float(s))
    assert "return lats[min(int(p / 100 * len(lats)), len(lats) - 1)]" in _source("serve_soak")
    lats = sorted(np.random.default_rng(0).random(37).tolist())
    for p in (50, 90, 99, 100):
        assert serve_soak.pct(lats, p) == lats[min(int(p / 100 * len(lats)), len(lats) - 1)]


def _report_keys(tree):
    """The keys of the JAX soak's ``report = {...}`` literal, nested ones dotted."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", "") == "report"):
            keys = set()
            for k, v in zip(node.value.keys, node.value.values):
                keys.add(k.value)
                if isinstance(v, ast.Dict):
                    keys |= {f"{k.value}.{kk.value}" for kk in v.keys}
            return keys
    raise AssertionError("no report literal")


def test_soak_on_cpu_has_the_jax_keys():
    want = _report_keys(ast.parse(_source("serve_soak")))
    assert {"latency_ms.p99", "probe_artifact_overruns", "forced_resets", "pass"} <= want
    rep = serve_soak.main(["--device", "cpu", "--batch", "4", "--cohorts", "2", "--seconds", "0.5",
                           "--warm-seconds", "0", "--admit-every", "0.05", "--probe-every", "4"])
    got = set(rep) | {f"latency_ms.{k}" for k in rep["latency_ms"]}
    assert want <= got
    assert rep["intervals"] == 31 and rep["steps_fired"] == 62 and rep["probes"] >= 1
    assert rep["nonfinite_steps"] == 0 and rep["launches"] == 0
    assert rep["releases"] >= 1 and rep["released_dirty"] == rep["releases"]
    assert rep["readmits_checked"] >= 1 and rep["readmits_nonzero"] == 0
    assert rep["admits"] == rep["releases"] + 4


@pytest.mark.parametrize("name,group", [
    ("fused_grid_b2<__nv_bfloat16>", "kernel B2"),
    ("void fused_step_b1<float>(KernelArgs)", "kernel B1"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "NCCL"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1", "GEMM"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_16x6_tn_align4>(Params)", "GEMM"),
    ("void splitKreduce_kernel<32, 16, int, float, float, float, float, true, false>", "GEMM"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4>", "GEMM"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize128x64x32", "conv"),
    ("void cudnn::cnn::wgrad_alg0_engine<float, 128, 6, 7, 3, 3, 5, false, 512>(int)", "conv"),
    ("void implicit_convolve_sgemm<float, float, 128, 6, 7, 3, 3, 5, 1, false>", "conv"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, unsigned int, 3>", "copy"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("Memset (Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::direct_copy_kernel_cuda>", "copy"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MaxOps>>",
     "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "elementwise"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl>", "elementwise"),
    ("void at::native::index_elementwise_kernel<128, 4>", "elementwise"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>", "other"),
])
def test_categorize(name, group):
    assert profile_serving.categorize(name) == group


# the loop counts that are module constants, shrunk for the CPU
SMALL = {sweep_cohort: {"BATCHES": (8, 16), "CHAIN": 3, "ROUNDS": 2},
         throughput_mode: {"HOPS": (2,), "BATCHES": (2,)},
         profile_serving: {"CHAIN": 2}, profile_train: {"CHAIN": 1}}


@pytest.mark.parametrize("mod,argv", [
    (sweep_cohort, []),
    (throughput_mode, []),
    (throughput_mode, ["--backend", "step"]),
    (bench_int8, ["4", "8", "--chain", "3"]),
    (train_speed, ["--crop_s", "0.5", "--batches", "2", "--chain", "1"]),
    (roofline, ["--batch", "8", "--bw_gb", "10"]),
    (profile_serving, ["8", "--audio"]),
    (profile_serving, ["4", "--backend", "layered", "--chunk", "2", "--folded"]),
    (profile_train, ["2", "--crop_s", "0.5"]),
], ids=lambda v: v.__name__.rsplit(".", 1)[-1] if hasattr(v, "__name__") else None)
def test_script_runs_on_cpu(mod, argv, capsys, monkeypatch):
    for name, n in SMALL.get(mod, {}).items():
        monkeypatch.setattr(mod, name, n)
    res = mod.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert res and out
    if mod is throughput_mode:
        assert "RESULT:" in out and ("T=1 only" in out) == ("step" in argv)
    if mod in (profile_serving, profile_train):
        assert np.isfinite(res["step_s"]) and "not measured: no card" in out
    if mod is roofline:
        assert res["bound_by"] == "bytes" and res["launches"] == 0  # 8 streams: bytes
        assert roofline.measure_bw(1 << 16, chain=2, device="cpu") > 0
    if mod is bench_int8:
        assert set(res) == {4, 8}
    if mod is train_speed:
        assert {k[1] for k in res} == {"f32", "bf16"}
        assert all(v["event_s"] is None and np.isfinite(v["step_s"]) for v in res.values())


def test_jax_params_count_matches(monkeypatch):
    """accounted_floors counts the params by the port's state dict: the same
    leaves, and the same sizes, as the JAX params tree."""
    j = JModel().init(jax.random.PRNGKey(0))
    j_sizes = sorted(int(np.asarray(v).size) for v in jax.tree_util.tree_leaves(j))
    p_sizes = sorted(v.numel() for v in GTCRNMicro(device="cpu").state_dict().values())
    assert p_sizes == j_sizes
