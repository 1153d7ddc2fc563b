"""The rest of the port's entry points on the CPU, held against the JAX
package and the root scripts they port.

- ``serve --checkpoint`` on a trainer's checkpoint directory equals
  ``--params`` of the same weights, bit for bit.
- ``utils.complexity``'s CLI prints JAX's parameter count; the model demo
  (``models.gtcrn_micro``) shows a prefix difference of exactly 0 and
  streaming within 1e-6 of offline.
- The ``GTConvBlock.shuffle`` seam: JAX's one-hot form equals the shipped
  copy bit for bit in float32 and bf16, JAX's own ``shuffle`` too, and the
  model's ``apply`` is unchanged with either.
- ``int8_microbench``'s three chains against JAX's, written out here in
  ``jnp`` (the root script keeps them inside its ``main``; its source lines
  are checked to still read so): int8 exactly, bf16 and int8-noreq within
  the int8 test's bounds.
- Every new script's ``main`` runs on the CPU at a tiny size (the control
  flow; no time from it is a device number).
- ``smoke_all``: its steps and their order with the processes stood in for,
  its two inline steps for real, and (marked slow) the whole run.
"""

import os
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gtcrn_micro_tpu.nn.blocks import GTConvBlock as JGTConvBlock
from gtcrn_micro_tpu.utils.complexity import param_count as jax_param_count
from gtcrn_micro_tpu.models.gtcrn_micro import GTCRNMicro as JModel
from gtcrn_micro_tpu_torch import serve
from gtcrn_micro_tpu_torch.io.export_native import MAGIC_INT8
from gtcrn_micro_tpu_torch.models import gtcrn_micro
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, flatten, init_params
from gtcrn_micro_tpu_torch.nn import blocks
from gtcrn_micro_tpu_torch.scripts import (
    ab_psum,
    ablate_shuffle,
    int8_microbench,
    leak_probe,
    ring_bank_microbench,
    smoke_all,
    sweep_chunk,
)
from gtcrn_micro_tpu_torch.utils import complexity
from gtcrn_micro_tpu_torch.utils.checkpoint import CheckpointManager
from gtcrn_micro_tpu_torch.utils.make_smoke_data import make_smoke_data

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A trainer's checkpoint directory of seed-1 weights, and a flat .npz
    of the same weights."""
    d = tmp_path_factory.mktemp("trained")
    params = init_params(torch.Generator().manual_seed(1), device="cpu")
    CheckpointManager(str(d / "checkpoints")).save(7, {"params": params, "opt_state": {},
                                                       "epoch": 1, "step": 7})
    np.savez(d / "w.npz", **{k.replace(".", "/"): v.numpy() for k, v in flatten(params).items()})
    return str(d / "checkpoints"), str(d / "w.npz")


def test_serve_checkpoint_equals_params_bit_for_bit(trained):
    ckpt, npz = trained
    args = ["--device", "cpu", "--seconds", "0.25", "--batch", "2", "--cohorts", "1",
            "--dtype", "f32"]
    by_ckpt = serve.main(args + ["--checkpoint", ckpt])
    by_params = serve.main(args + ["--params", npz])
    seed0 = serve.main(args)
    for k in ("grid", "plain"):
        assert torch.equal(by_ckpt[k], by_params[k])
    assert not torch.equal(by_ckpt["grid"], seed0["grid"])  # the weights were read
    with pytest.raises(SystemExit):  # one source of weights at a time
        serve.main(args + ["--checkpoint", ckpt, "--params", npz])


def test_complexity_cli_prints_jax_param_count(capsys):
    n_jax = jax_param_count(JModel().init(jax.random.PRNGKey(0)))
    assert complexity.main(["--device", "cpu"]) == (n_jax, 41929335)
    out = capsys.readouterr().out.splitlines()
    assert out == [f"params: {n_jax / 1e3:.2f} k (published 19.01 k)",
                   "MACs/s audio: 41.93 M (published 45.92 M)"]
    src = (ROOT / "gtcrn_micro_tpu" / "utils" / "complexity.py").read_text()
    assert 'print(f"params: {n_params / 1e3:.2f} k (published 19.01 k)")' in src
    assert 'print(f"MACs/s audio: {n_macs / 1e6:.2f} M (published 45.92 M)")' in src


def test_model_demo_causality_and_streaming(capsys):
    res = gtcrn_micro.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert res["prefix_diff"] == 0.0 and res["suffix_diff"] > 0
    assert res["stream_diff"] < 1e-6
    assert (res["params"], res["macs"]) == (19014, 41929335)
    assert "causality: prefix diff 0.00e+00 (==0)" in out and "streaming vs offline" in out


def test_shuffle_seam_onehot_equals_copy(monkeypatch):
    rng = np.random.default_rng(0)
    x1, x2 = (rng.standard_normal((2, 3, 33, 8)).astype(np.float32) for _ in range(2))
    want = np.asarray(JGTConvBlock.shuffle(jnp.asarray(x1), jnp.asarray(x2)))
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    assert torch.equal(blocks.GTConvBlock.shuffle(t1, t2), torch.from_numpy(want))
    for dt in (torch.float32, torch.bfloat16):
        a, b = t1.to(dt), t2.to(dt)
        assert torch.equal(ablate_shuffle.onehot_shuffle(a, b), blocks.GTConvBlock.shuffle(a, b))

    spec = torch.from_numpy(rng.standard_normal((1, 257, 4, 2)).astype(np.float32))
    params = init_params(torch.Generator().manual_seed(0), device="cpu")
    for dt in (torch.float32, torch.bfloat16):
        model = GTCRNMicro.from_params(params, dtype=dt, device="cpu")
        with torch.no_grad():
            shipped = model.apply(spec.to(dt))
            monkeypatch.setattr(blocks.GTConvBlock, "shuffle",
                                staticmethod(ablate_shuffle.onehot_shuffle))
            onehot = model.apply(spec.to(dt))
            monkeypatch.setattr(blocks.GTConvBlock, "shuffle",
                                staticmethod(ablate_shuffle.concat_shuffle))
            concat = model.apply(spec.to(dt))  # the seam is the one forward calls
            monkeypatch.undo()
        assert torch.equal(onehot, shipped)
        assert not torch.equal(concat, shipped)


# -- int8_microbench: the root script's chains, written out in jnp ----------

JAX_CHAIN_LINES = (
    "y = jnp.dot(x, wb[i], preferred_element_type=jnp.float32)",
    "y = y + bias[i]",
    "x = jnp.maximum(y, 0.1 * y).astype(jnp.bfloat16)",
    "v = y.astype(jnp.float32) * jnp.float32(0.01) + bias[i]",
    "v = jnp.maximum(v, 0.1 * v)",
    "return jnp.clip(jnp.round(v * 12.7), -128, 127).astype(jnp.int8)",
    "q = requant(acc, i)",
    "acc = jnp.dot(x, wb[i], preferred_element_type=jnp.float32)",
    "y = acc.astype(jnp.float32) + bias[i]",
    "w8 = jnp.asarray(rng.integers(-127, 128, (n_layers, C, C)), jnp.int8)",
    "wb = w8.astype(jnp.bfloat16) * jnp.bfloat16(0.01)",
    "bias = jnp.asarray(rng.standard_normal((n_layers, C)), jnp.float32)",
    "xb = jnp.asarray(rng.standard_normal((batch, F, C)), jnp.bfloat16)",
    "xq = jnp.asarray(rng.integers(-127, 128, (batch, F, C)), jnp.int8)",
)


def _jax_chains(batch, n_layers):
    """The root script's inputs and chains (eager: one operation at a time)."""
    F, C = 33, 16
    rng = np.random.default_rng(0)
    w8 = jnp.asarray(rng.integers(-127, 128, (n_layers, C, C)), jnp.int8)
    wb = w8.astype(jnp.bfloat16) * jnp.bfloat16(0.01)
    bias = jnp.asarray(rng.standard_normal((n_layers, C)), jnp.float32)
    xb = jnp.asarray(rng.standard_normal((batch, F, C)), jnp.bfloat16)
    xq = jnp.asarray(rng.integers(-127, 128, (batch, F, C)), jnp.int8)

    def dot8(q, w):
        return jax.lax.dot_general(q, w, (((2,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)

    x = xb
    for i in range(n_layers):
        y = jnp.dot(x, wb[i], preferred_element_type=jnp.float32)
        y = y + bias[i]
        x = jnp.maximum(y, 0.1 * y).astype(jnp.bfloat16)
    bf16 = x
    q = xq
    for i in range(n_layers):
        v = dot8(q, w8[i]).astype(jnp.float32) * jnp.float32(0.01) + bias[i]
        v = jnp.maximum(v, 0.1 * v)
        q = jnp.clip(jnp.round(v * 12.7), -128, 127).astype(jnp.int8)
    int8 = q
    x = None
    for i in range(n_layers):
        acc = dot8(xq, w8[i]) if x is None else jnp.dot(x, wb[i],
                                                        preferred_element_type=jnp.float32)
        y = acc.astype(jnp.float32) + bias[i]
        x = jnp.maximum(y, 0.1 * y).astype(jnp.bfloat16)
    inputs = dict(w8=w8, wb=wb, bias=bias, xb=xb, xq=xq)
    return inputs, {"bf16": bf16, "int8": int8, "int8-noreq": x}


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_int8_microbench_chains_match_jax():
    src = (ROOT / "scripts" / "int8_microbench.py").read_text()
    for line in JAX_CHAIN_LINES:
        assert line in src, line
    want_in, want = _jax_chains(64, 4)
    t = int8_microbench.make_inputs(64, 4, "cpu")
    for k, v in want_in.items():
        assert np.array_equal(_np(t[k]), np.asarray(v, np.float32 if k in ("wb", "xb")
                                                    else v.dtype)), k
    got = {"bf16": int8_microbench.chain_bf16(t["xb"], t["wb"], t["bias"]),
           "int8": int8_microbench.chain_int8(t["xq"], t["w8"], t["bias"]),
           "int8-noreq": int8_microbench.chain_int8_noreq(t["xq"], t["w8"], t["wb"], t["bias"])}
    assert got["int8"].dtype == torch.int8
    assert np.array_equal(got["int8"].numpy(), np.asarray(want["int8"]))
    for k in ("bf16", "int8-noreq"):  # tests/test_torch_int8.py's bounds, per stream
        assert got[k].dtype == torch.bfloat16
        y, g = np.asarray(want[k], np.float64), _np(got[k]).astype(np.float64)
        err = np.abs(g - y).reshape(64, -1).max(axis=1)
        snr = 10 * np.log10((y ** 2).reshape(64, -1).sum(1)
                            / np.maximum(((g - y) ** 2).reshape(64, -1).sum(1), 1e-30))
        assert np.median(err) < 1e-6 and err.max() < 5e-3 * np.abs(y).max() and snr.min() > 50


def test_int8_dot_is_one_2d_product(monkeypatch):
    """torch._int_mm takes (M, K) x (K, N): the chain reshapes (B, 33, 16) to
    (B * 33, 16), never a batched 3-D product."""
    shapes = []
    real = int8_microbench.int_matmul
    monkeypatch.setattr(int8_microbench, "int_matmul",
                        lambda a, w: shapes.append((tuple(a.shape), tuple(w.shape))) or real(a, w))
    t = int8_microbench.make_inputs(20, 2, "cpu")
    int8_microbench.chain_int8(t["xq"], t["w8"], t["bias"])
    assert shapes == [((20 * 33, 16), (16, 16))] * 2


# -- every new script's main on the CPU, at a tiny size ---------------------

SMALL = {sweep_chunk: {"BATCHES": (2,), "CHUNKS": (1, 2), "CHAIN_FRAMES": 2, "MIN_STEPS": 1},
         ab_psum: {"CHAIN": 2, "REPEATS": 1, "ROUNDS": 1},
         ring_bank_microbench: {"CHAIN": 2},
         ablate_shuffle: {"CHAIN": 1}}


@pytest.mark.parametrize("mod,argv", [
    (sweep_chunk, []),
    (int8_microbench, ["24", "2"]),
    (ab_psum, ["2"]),
    (ab_psum, ["--rr", "2", "2"]),
    (ring_bank_microbench, ["2"]),
    (ablate_shuffle, ["2"]),
    (leak_probe, ["--mode", "all", "--steps", "2", "--batch", "2", "--samples", "4000",
                  "--log-every", "1"]),
], ids=lambda v: v.__name__.rsplit(".", 1)[-1] if hasattr(v, "__name__") else None)
def test_script_runs_on_cpu(mod, argv, capsys, monkeypatch):
    for name, n in SMALL.get(mod, {}).items():
        monkeypatch.setattr(mod, name, n)
    shipped = blocks.GTConvBlock.shuffle
    res = mod.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert res and out
    if mod is sweep_chunk:
        assert set(res) == {(2, 1), (2, 2)} and all(min(c) > 0 for c in res.values())
    if mod is int8_microbench:
        assert set(res) == {"bf16", "int8", "int8-noreq"} and min(res.values()) > 0
    if mod is ab_psum:
        assert set(res[2]["ratios"]) == {"psum", "fp8", "psum+fp8"}
        assert out.count("best-of-2") == 3 and ("keep-up" in out) == ("--rr" in argv)
    if mod is ring_bank_microbench:
        assert set(res) == {"separate", "bank"}
        # 8 ring writes at least; no device on the CPU
        assert all(r["copy_ops"] >= 8 and r["device_copies"] == 0 for r in res.values())
    if mod is ablate_shuffle:
        assert set(res) == {"copy", "one-hot", "concat"}
        assert blocks.GTConvBlock.shuffle is shipped  # restored
    if mod is leak_probe:
        assert set(res) == {"putonly", "compute", "full"}
        assert out.count("MB/step over 2 steps") == 3


def test_sweep_chunk_reports_oom_and_raises_the_rest(monkeypatch, capsys):
    """An out-of-memory cell prints FAIL OOM and the sweep goes on; any other
    error propagates (the root script caught every exception as a row)."""
    monkeypatch.setattr(sweep_chunk, "BATCHES", (2,))
    monkeypatch.setattr(sweep_chunk, "CHUNKS", (1, 2))

    def oom(model, b, t, rtt):
        if t == 2:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return 1e-3, 1e-3, 1e-3

    monkeypatch.setattr(sweep_chunk, "chain_latency", oom)
    res = sweep_chunk.main(["--device", "cpu"])
    assert res == {(2, 1): (1e-3, 1e-3, 1e-3), (2, 2): None}
    assert "FAIL OOM" in capsys.readouterr().out

    def broken(model, b, t, rtt):
        raise ValueError("not a memory fault")

    monkeypatch.setattr(sweep_chunk, "chain_latency", broken)
    with pytest.raises(ValueError):
        sweep_chunk.main(["--device", "cpu"])


# -- smoke_all ---------------------------------------------------------------

def test_smoke_all_inline_steps(trained, tmp_path, capsys):
    """The two steps without a CLI, in this process: the ONNX round trip and
    the GTM8 artifacts from a checkpoint directory."""
    from gtcrn_micro_tpu_torch.io.onnx_export import export_model_onnx

    ckpt, _ = trained
    make_smoke_data(str(tmp_path / "data"), n_train=1, n_val=4, seconds=0.5)
    model = GTCRNMicro.from_params(init_params(torch.Generator().manual_seed(1), device="cpu"),
                                   device="cpu")
    (tmp_path / "m.onnx").write_bytes(export_model_onnx(model, 1, 8))
    smoke_all.onnx_round_trip(str(tmp_path / "m.onnx"), "cpu")
    smoke_all.gtm8_artifacts(ckpt, str(tmp_path / "data" / "val" / "noisy"), str(tmp_path), "cpu")
    out = capsys.readouterr().out
    assert "onnx round-trip ok" in out and "GTM8 artifacts ok" in out
    for name in ("w_int8.bin", "w_16x8.bin"):
        assert (tmp_path / name).read_bytes()[:4] == struct.pack("<I", MAGIC_INT8)


def test_smoke_all_runs_every_cli_in_order(tmp_path, monkeypatch):
    """The steps, their order and the device flag, with each process stood in
    for by a fake that writes what the step would."""
    cmds = []
    root = str(tmp_path / "smoke")

    def fake_run(cmd):
        cmds.append([str(c) for c in cmd])
        line = " ".join(cmds[-1])
        if "make_smoke_data" in line:
            make_smoke_data(root, n_train=1, n_val=1, seconds=0.1)
        elif "train.train" in line:
            os.makedirs(f"{root}/exp_1/checkpoints/best")
        elif "eval.evaluate" in line:
            os.makedirs(f"{root}/enhanced/RESULTS_intrusive")
            Path(f"{root}/enhanced/RESULTS_intrusive/RESULTS.txt").write_text("")
        elif "io.export_program" in line:
            os.makedirs(f"{root}/export", exist_ok=True)
            for n in ("gtcrn_micro_weights.bin", "gtcrn_micro.onnx", "gtcrn_micro_stream.onnx",
                      "gtcrn_micro_w8a16_pc.bin"):
                Path(f"{root}/export/{n}").write_text("")
        elif "runtime.native" in line:
            return "built: /b/libgtcrn_micro.so and /b/gtcrn_stream\n"
        elif f"-m {smoke_all.PKG}.serve" in line:
            Path(f"{root}/serve_demo.wav").write_text("")
        return ""

    monkeypatch.setattr(smoke_all, "_run", fake_run)
    assert smoke_all.main(["--root", root, "--device", "cpu"]) == 0
    steps = [c[2] if c[1] in ("-m", "-c") else " ".join(c[:2]) for c in cmds]
    pkg = "gtcrn_micro_tpu_torch."
    assert [s.removeprefix(pkg).split(" import ")[0] for s in steps] == [
        "utils.make_smoke_data", "train.train", "eval.infer", "eval.infer", "eval.evaluate",
        "io.export_program", f"from {pkg}scripts.smoke_all", f"from {pkg}scripts.smoke_all",
        "io.export_program", "runtime.native",
        f"/b/gtcrn_stream {root}/export/gtcrn_micro_weights.bin",
        "/b/gtcrn_stream --int8", "/b/gtcrn_stream --int16", "/b/gtcrn_stream --pc",
        "/b/gtcrn_stream --bench", "utils.complexity", "serve"]
    host_only = ("utils.make_smoke_data", "runtime.native")
    for c in cmds:
        if c[1] == "-m":
            assert (c[-2:] == ["--device", "cpu"]) != c[2].endswith(host_only), c
        elif c[1] == "-c":
            assert c[2].endswith("'cpu'))"), c
    assert "--checkpoint" in cmds[-1] and cmds[-1][cmds[-1].index("--dtype") + 1] == "f32"
    quant = cmds[3]
    assert quant[quant.index("--act_bits") + 1] == "16" and "--quant" in quant


@pytest.mark.slow
def test_smoke_all_end_to_end_on_cpu(tmp_path):
    """Every CLI for real, each in its own process (about 110 s here)."""
    assert smoke_all.main(["--device", "cpu", "--root", str(tmp_path)]) == 0
    assert (tmp_path / "serve_demo.wav").exists()
    assert (tmp_path / "enhanced" / "RESULTS_intrusive" / "RESULTS.txt").exists()

