"""The port's deployment export (io.export_native), native-engine bindings
(runtime.native) and reference-checkpoint importer (io.torch_ckpt), held
against the JAX package's on the CPU.

- Files: the port writes GTM1 and GTM8 (v1 at 8 and 16 bits, v2 mixed, v3
  per-lane, v4 integer per-lane) byte for byte as JAX does, from the same
  BN-folded params (``GTCRNMicro().init(PRNGKey(0))``) and activation params
  built by JAX's ``act_qparams`` from seeded ranges, carried across with
  ``io.params.act_qp_from_jax`` (no JAX model compile).
- Engine: ``NativeEngine`` built by the port (g++, into the port's ignored
  build directory) on files the port wrote, against the port's own models at
  the bounds of tests/runtime/test_native.py: fp32 engine vs the plain fused
  ring step < 1e-5 over 20 frames (:61), int8 engine vs the port's
  ``QuantizedModel`` ring step < 5e-4 * max(max|y|, 1) (:137), ``step_batch``
  bit-equal to sequential engines (:163), the int8 engine refusing a mixed
  file (:235).  Skipped where g++ is absent.
- Importer: a state dict with the reference's keys and shapes (the inverse of
  io/torch_ckpt.py's mapping, with ``module.`` prefixes and
  ``num_batches_tracked``) imports to exactly JAX's leaves.
"""

import shutil
import subprocess

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.io import export_native as jexport
from gtcrn_micro_tpu.io.torch_ckpt import import_reference_checkpoint as j_import
from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu.models.folding import fold_bn_params as j_fold
from gtcrn_micro_tpu.ops.fused_step import pack_weights as j_pack
from gtcrn_micro_tpu.quant.fake_quant import act_qparams as j_act_qparams
from gtcrn_micro_tpu_torch.eval import infer
from gtcrn_micro_tpu_torch.io import export_native as texport
from gtcrn_micro_tpu_torch.io.params import act_qp_from_jax, params_from_numpy
from gtcrn_micro_tpu_torch.io.torch_ckpt import import_reference_checkpoint
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, flatten
from gtcrn_micro_tpu_torch.ops.fused_step import LayoutGTCRNMicro
from gtcrn_micro_tpu_torch.quant.ptq import QuantizedModel, observe_ranges, qparams_from_ranges

T = 20  # frames: past the 16-slot ring wrap


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def folded():
    """(JAX folded params, the same as numpy, the port's tensors)."""
    jp = j_fold(JModel().init(jax.random.PRNGKey(0)))
    pnp = jax.tree.map(np.asarray, jp)
    return jp, pnp, params_from_numpy(pnp, device="cpu")


def _lanes() -> dict:
    """Per boundary, its lane count: the packed width its scales fold into."""
    shapes = [np.shape(w) for w in j_pack(JModel().init(jax.random.PRNGKey(0)))]
    return {path: shapes[i][axis] for i, (path, axis) in enumerate(jexport._slot_fold_info())
            if path is not None}


def _j_act_qp(kind: str) -> dict:
    """JAX act params from seeded [lo, hi] per boundary: uniform 8 or 16
    bits, mixed (four boundaries lifted to 16 bits, as quant/mixed.py's
    compose_act_qp does), or per-lane."""
    rng = np.random.default_rng({"8": 1, "16": 2, "mixed": 3, "pc16": 4, "pc8": 5}[kind])
    lanes = _lanes()
    lifted = {"encoder/en0/conv/in", "encoder/en3/depth_conv/in", "decoder/de1/tra/energy",
              "decoder/de4/conv/in"}
    out = {}
    for p in jexport.act_path_order():
        n = lanes[p] if kind.startswith("pc") else ()
        lo = -rng.uniform(0.05, 2.0, n).astype(np.float32)
        hi = rng.uniform(0.05, 2.0, n).astype(np.float32)
        bits = {"8": 8, "16": 16, "pc16": 16, "pc8": 8}.get(kind, 16 if p in lifted else 8)
        out[p] = j_act_qparams(jnp.asarray(lo), jnp.asarray(hi), bits)
    return out


@pytest.mark.parametrize("fmt, kind, integer_pc", [
    ("gtm1", None, False), ("v1_int8", "8", False), ("v1_16x8", "16", False),
    ("v2_mixed", "mixed", False), ("v3_per_lane", "pc16", False), ("v4_integer_pc", "pc8", True),
])
def test_files_byte_identical_to_jax(folded, tmp_path, fmt, kind, integer_pc):
    jp, _, tp = folded
    jpath, tpath = tmp_path / "jax.bin", tmp_path / "port.bin"
    if kind is None:
        assert jexport.export_native_weights(jp, str(jpath)) == 158
        assert texport.export_native_weights(tp, str(tpath)) == 158
        got = texport.load_native_weights(str(tpath))
        want = jexport.load_native_weights(str(jpath))
        assert [g.shape for g in got] == [w.shape for w in want] and got[0].shape == (64, 192)
    else:
        jqp = _j_act_qp(kind)
        jexport.export_native_weights_int8(jp, jqp, str(jpath), integer_pc=integer_pc)
        n = texport.export_native_weights_int8(tp, act_qp_from_jax(jqp, device="cpu"),
                                               str(tpath), integer_pc=integer_pc)
        assert n == 158
    assert tpath.read_bytes() == jpath.read_bytes()


def test_int8_export_refuses_missing_paths(folded, tmp_path):
    _, _, tp = folded
    qp = act_qp_from_jax(_j_act_qp("8"), device="cpu")
    qp.pop("decoder/de4/conv/in")
    with pytest.raises(KeyError, match="missing"):
        texport.export_native_weights_int8(tp, qp, str(tmp_path / "x.bin"))
    assert texport.act_path_order() == jexport.act_path_order()
    assert texport._slot_axes() == jexport._slot_axes()
    assert texport._slot_fold_info() == jexport._slot_fold_info()


# -- the native engine, driven by the port ------------------------------------------


@pytest.fixture(scope="module")
def native(folded, tmp_path_factory):
    """The port-built engine and the port-written files: GTM1 of the folded
    params, GTM8 int8 from the port's calibration of its own model."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native engine builds with g++")
    from gtcrn_micro_tpu_torch.runtime.native import build_native

    build_native()
    _, _, tp = folded
    d = tmp_path_factory.mktemp("native")
    texport.export_native_weights(tp, str(d / "w.bin"))
    model = GTCRNMicro.from_params(tp, device="cpu")
    calib = np.random.default_rng(3).standard_normal((4, 257, 16, 2)).astype(np.float32) * 0.3
    act_qp = qparams_from_ranges(observe_ranges(model, calib, batch_size=4), 8)
    texport.export_native_weights_int8(tp, act_qp, str(d / "w8.bin"))
    return tp, model, act_qp, d


def _spec(seed, n=1, frames=T):
    return np.random.default_rng(seed).standard_normal((n, 257, frames, 2)).astype(np.float32) * 0.3


def test_native_fp32_matches_plain_fused_step(native):
    from gtcrn_micro_tpu_torch.runtime.native import NativeEngine

    tp, _, _, d = native
    eng, plain = NativeEngine(str(d / "w.bin")), LayoutGTCRNMicro(tp, device="cpu")
    spec = _spec(0)
    state = plain.init_state(1)
    errs = []
    for t in range(T):
        y, state = plain.step(None, state, torch.from_numpy(spec[:, :, t : t + 1]))
        errs.append(np.abs(y.numpy()[0, :, 0] - eng.step(spec[0, :, t])).max())
    assert max(errs) < 1e-5, errs
    x = (np.random.default_rng(1).standard_normal(8000) * 0.1).astype(np.float32)
    out = eng.enhance(x)
    assert out.shape == x.shape and np.isfinite(out).all()


def test_native_int8_matches_quantized_model(native):
    from gtcrn_micro_tpu_torch.runtime.native import NativeEngine

    _, model, act_qp, d = native
    eng8, qm = NativeEngine(str(d / "w8.bin"), quant="int8"), QuantizedModel(model, act_qp)
    spec = _spec(4)
    state = qm.init_state(1)
    errs, mags = [], []
    for t in range(T):
        y, state = qm.step(None, state, torch.from_numpy(spec[:, :, t : t + 1]))
        errs.append(np.abs(y.numpy()[0, :, 0] - eng8.step(spec[0, :, t])).max())
        mags.append(float(y.abs().max()))
    assert max(errs) < 5e-4 * max(max(mags), 1.0), (errs, mags)


@pytest.mark.parametrize("which", ["fp32", "int8"])
def test_step_batch_matches_sequential(native, which):
    from gtcrn_micro_tpu_torch.runtime.native import NativeEngine

    _, _, _, d = native
    path, quant = (str(d / "w.bin"), None) if which == "fp32" else (str(d / "w8.bin"), "int8")
    N, frames = 3, 5
    spec = _spec(6, N, frames)
    batch_eng = NativeEngine(path, quant=quant)
    singles = [NativeEngine(path, quant=quant) for _ in range(N)]
    for t in range(frames):
        got = batch_eng.step_batch(spec[:, :, t])
        for i in range(N):
            np.testing.assert_array_equal(got[i], singles[i].step(spec[i, :, t]))


def test_engines_refuse_files_of_another_kind(native, tmp_path):
    from gtcrn_micro_tpu_torch.runtime.native import NativeEngine

    tp, _, _, d = native
    mixed = str(tmp_path / "mixed.bin")
    texport.export_native_weights_int8(tp, act_qp_from_jax(_j_act_qp("mixed"), device="cpu"),
                                       mixed)
    with pytest.raises(RuntimeError, match="failed to load"):
        NativeEngine(mixed, quant="int8")
    NativeEngine(mixed, quant="mixed").step(_spec(7, frames=1)[0, :, 0])
    with pytest.raises(RuntimeError, match="failed to load"):
        NativeEngine(str(d / "w.bin"), quant="int8")


def test_cli_enhances_a_wav(native, tmp_path):
    from gtcrn_micro_tpu_torch.io.wav import read_wav, write_wav
    from gtcrn_micro_tpu_torch.runtime import native as rt

    _, _, _, d = native
    assert "gtcrn_micro_tpu_torch/native" in rt.CLI_PATH.replace("\\", "/")
    x = (np.random.default_rng(8).standard_normal(8000) * 0.1).astype(np.float32)
    write_wav(str(tmp_path / "in.wav"), x, 16000)
    res = subprocess.run([rt.CLI_PATH, "--int8", str(d / "w8.bin"), str(tmp_path / "in.wav"),
                          str(tmp_path / "out.wav")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    y, fs = read_wav(str(tmp_path / "out.wav"))
    assert fs == 16000 and len(y) == len(x)


# -- the reference checkpoint --------------------------------------------------------


def _oihw(w):
    return np.transpose(w, (3, 2, 0, 1))  # HWIO -> OIHW


def _iohw(w):
    return np.ascontiguousarray(np.transpose(w[::-1, ::-1], (2, 3, 0, 1)))  # flipped HWIO -> IOHW


def _reference_state_dict(p: dict) -> dict:
    """The reference's state dict for params ``p`` (numpy, JAX layouts):
    the inverse of io/torch_ckpt.py's mapping."""
    sd = {"erb.erb_fc.weight": p["erb"]["bm_w"].T, "erb.ierb_fc.weight": p["erb"]["bs_w"].T,
          "sfe.depth_conv.weight": _oihw(p["sfe"]["depth_conv"]["w"])}

    def bn(prefix, q):
        sd.update({f"{prefix}.weight": q["gamma"], f"{prefix}.bias": q["beta"],
                   f"{prefix}.running_mean": q["running_mean"],
                   f"{prefix}.running_var": q["running_var"],
                   f"{prefix}.num_batches_tracked": np.array(7)})

    def pw(w, deconv=False):  # (I, O) -> (O, I, 1, 1), or (I, O, 1, 1) transposed
        return (w if deconv else w.T)[:, :, None, None]

    def conv_block(prefix, q, deconv):
        sd[f"{prefix}.conv.weight"] = _iohw(q["conv"]["w"]) if deconv else _oihw(q["conv"]["w"])
        sd[f"{prefix}.conv.bias"] = q["conv"]["b"]
        bn(f"{prefix}.bn", q["bn"])
        if "act" in q:
            sd[f"{prefix}.act.weight"] = q["act"]["alpha"].reshape(1)

    def gt_block(prefix, q, deconv):
        for i in (1, 2):
            sd[f"{prefix}.point_conv{i}.weight"] = pw(q[f"point_conv{i}"]["w"], deconv)
            sd[f"{prefix}.point_conv{i}.bias"] = q[f"point_conv{i}"]["b"]
            bn(f"{prefix}.point_bn{i}", q[f"point_bn{i}"])
        w = q["depth_conv"]["w"]
        sd[f"{prefix}.depth_conv.weight"] = _iohw(w) if deconv else _oihw(w)
        sd[f"{prefix}.depth_conv.bias"] = q["depth_conv"]["b"]
        bn(f"{prefix}.depth_bn", q["depth_bn"])
        for a in ("point_act", "depth_act"):
            sd[f"{prefix}.{a}.weight"] = q[a]["alpha"].reshape(1)
        tra = q["tra"]
        sd[f"{prefix}.tra.depth_conv.weight"] = tra["depth_w"].T[:, None, :]  # Conv1d (C, 1, k)
        sd[f"{prefix}.tra.depth_conv.bias"] = tra["depth_b"]
        sd[f"{prefix}.tra.point_conv.weight"] = tra["point_w"].T[:, :, None]  # Conv1d (O, I, 1)
        sd[f"{prefix}.tra.point_conv.bias"] = tra["point_b"]

    for i in (0, 1):
        conv_block(f"encoder.en_convs.{i}", p["encoder"][f"en{i}"], False)
    for i in (2, 3, 4):
        gt_block(f"encoder.en_convs.{i}", p["encoder"][f"en{i}"], False)
    for g in ("gtcn1", "gtcn2"):
        for j in range(4):
            q, prefix = p[g][f"block{j}"], f"{g}.blocks.{j}"
            sd[f"{prefix}.conv1.weight"] = pw(q["conv1"]["w"])
            sd[f"{prefix}.conv2.weight"] = _oihw(q["conv2"]["w"])
            sd[f"{prefix}.conv3.weight"] = pw(q["conv3"]["w"])
            for k in (1, 2, 3):
                sd[f"{prefix}.conv{k}.bias"] = q[f"conv{k}"]["b"]
                bn(f"{prefix}.bn{k}", q[f"bn{k}"])
                sd[f"{prefix}.act{k}.weight"] = q[f"act{k}"]["alpha"].reshape(1)
    for i in (0, 1, 2):
        gt_block(f"decoder.de_convs.{i}", p["decoder"][f"de{i}"], True)
    for i in (3, 4):
        conv_block(f"decoder.de_convs.{i}", p["decoder"][f"de{i}"], True)
    return {f"module.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def reference_tar(tmp_path_factory):
    """A reference-style ``.tar`` of seeded random params (every leaf
    distinct, so a swapped key cannot pass), and those params."""
    rng = np.random.default_rng(11)
    pnp = jax.tree.map(lambda v: rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32),
                       jax.tree.map(np.asarray, JModel().init(jax.random.PRNGKey(0))))
    path = tmp_path_factory.mktemp("ckpt") / "best_model.tar"
    torch.save({"epoch": 3, "model": _reference_state_dict(pnp), "optimizer": {}}, path)
    return path, pnp


def test_import_reference_checkpoint_matches_jax(reference_tar):
    path, pnp = reference_tar
    got = flatten(import_reference_checkpoint(str(path), device="cpu"))
    want = flatten(jax.tree.map(np.asarray, j_import(str(path))))
    src = flatten(pnp)
    assert got.keys() == want.keys() == src.keys()
    for k, v in want.items():
        # JAX's importer ends in np.ascontiguousarray, which turns the 0-d
        # PReLU slopes into (1,) (ROADMAP C); the port keeps the params'
        # own 0-d shape
        assert got[k].dtype == torch.float32 and got[k].shape == src[k].shape, k
        assert v.shape == (src[k].shape or (1,)), k
        np.testing.assert_array_equal(got[k].numpy().reshape(v.shape), v, err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), src[k], err_msg=k)
    loaded = flatten(infer.load_params(str(path), device="cpu"))
    assert all(torch.equal(loaded[k], got[k]) for k in got)


def test_import_refuses_an_extra_tensor(reference_tar, tmp_path):
    path, _ = reference_tar
    ckpt = torch.load(path, weights_only=False)
    ckpt["model"]["module.decoder.extra.weight"] = torch.zeros(3)
    bad = tmp_path / "extra.tar"
    torch.save(ckpt, bad)
    with pytest.raises(ValueError, match="unconsumed.*decoder.extra.weight"):
        import_reference_checkpoint(str(bad), device="cpu")
