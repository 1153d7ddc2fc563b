"""The port's params, packed weights and fused forward held against the JAX
package (gtcrn_micro_tpu.ops.fused_step / fused_grid), on the CPU.

The same numpy params and numpy inputs go through both: the params are the
port's ``init_params`` (seeded) as numpy arrays, which the JAX functions take
as they are; the init test holds that tree against the JAX ``init``.  The JAX Pallas kernels run in interpret mode, once each; the
other comparisons use the JAX ``LayoutGTCRNMicro`` (the same math in plain
XLA) and the JAX layered ring model.

Tolerances: the packed weights are the same float32 numpy arithmetic (1e-7).
Streamed outputs use the JAX package's own 2e-6
(tests/ops/test_fused_step.py:39-44); measured gaps are ~6e-8 on outputs of
magnitude ~0.15, from other summation orders across ~40 layers.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.models import GTCRNMicro
from gtcrn_micro_tpu.ops import fused_step as jfs
from gtcrn_micro_tpu.ops.fused_grid import GridFusedGTCRNMicro as JGrid
from gtcrn_micro_tpu_torch.io.params import (
    load_params_npz,
    params_from_numpy,
    state_from_jax,
)
from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params
from gtcrn_micro_tpu_torch.ops import fused_step as tfs
from gtcrn_micro_tpu_torch.ops.fused_grid import GridFusedGTCRNMicro

T = 20  # frames: crosses the wrap of the 16-slot rings
B = 16
TOL = 2e-6


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


@pytest.fixture(scope="module")
def setup():
    pnp = _numpy(init_params(torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(0)
    spec = rng.standard_normal((B, 257, T, 2)).astype(np.float32) * 0.2
    return GTCRNMicro(), pnp, params_from_numpy(pnp, device="cpu"), spec


def _stream(step, state, spec, t0=0, t1=None, to_np=np.asarray, wrap=jnp.asarray):
    """``step`` has the JAX package's protocol, ``step(params, state, x)``."""
    outs = []
    for t in range(t0, spec.shape[2] if t1 is None else t1):
        y, state = step(None, state, wrap(spec[:, :, t : t + 1]))
        outs.append(to_np(y))
    return np.concatenate(outs, axis=2), state


def _port_stream(m, state, spec, t0=0, t1=None):
    return _stream(lambda _params, s, x: m.step(s, x), state, spec, t0, t1,
                   to_np=lambda y: y.numpy(), wrap=torch.from_numpy)


def _state_np(state):
    return {k: np.asarray(v) for k, v in state.items()}


@pytest.fixture(scope="module")
def jax_fused(setup):
    """JAX FusedGTCRNMicro (Pallas, interpret mode) over T frames, with its
    state after frame 10, and the layered ring model's outputs."""
    model, params, _tp, spec = setup
    fused = jfs.FusedGTCRNMicro(params, tile=8, interpret=True)
    out_a, st = _stream(fused.step, fused.init_state(B), spec, 0, 10)
    st10 = _state_np(st)
    out_b, _ = _stream(fused.step, st, spec, 10, T)
    ring, _ = _stream(lambda p, s, x: model.step_jit(params, s, x),
                      model.init_state(B, ring=True), spec)
    return np.concatenate([out_a, out_b], axis=2), st10, ring


@pytest.fixture(scope="module")
def jax_grid(setup):
    """JAX GridFusedGTCRNMicro (interpret mode) over 6 frames, with its state
    after frame 3."""
    _model, params, _tp, spec = setup
    fused = JGrid(params, tile=8, interpret=True)
    out_a, st = _stream(fused.step, fused.init_state(B), spec, 0, 3)
    st3 = _state_np(st)
    out_b, _ = _stream(fused.step, st, spec, 3, 6)
    return np.concatenate([out_a, out_b], axis=2), st3


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _init_bound(path, leaves):
    """The torch-default uniform bound 1/sqrt(fan_in) of a leaf."""
    parent, leaf = path.rsplit("/", 1)
    if parent.endswith("/tra"):
        return 1 / np.sqrt(3 if leaf.startswith("depth") else 8)
    w = leaves[f"{parent}/w"]
    fan_in = int(np.prod(w.shape[:3])) if w.ndim == 4 else w.shape[0]
    return 1 / np.sqrt(fan_in)


def test_init_params_match_jax_tree():
    """Paths, shapes and dtypes of the JAX init; the ERB filters, identity BN
    statistics and PReLU slopes equal JAX's; every random leaf is drawn from
    U(-b, b) with the torch-default bound b."""
    from gtcrn_micro_tpu.dsp.erb import ErbBands
    from gtcrn_micro_tpu.nn.core import BatchNorm, PReLU

    jl = _leaves(jax.eval_shape(GTCRNMicro().init, jax.random.PRNGKey(0)))
    tl = {k: v.numpy() for k, v in _leaves(
        init_params(torch.Generator().manual_seed(3), device="cpu")).items()}
    assert sorted(tl) == sorted(jl) and len(tl) == 342
    assert sum(v.size for v in tl.values()) == 44938
    erb = ErbBands().init_params()
    bn = {k: np.asarray(v)[0] for k, v in BatchNorm(16).init(None).items()}
    alpha = float(PReLU().init(None)["alpha"])
    scaled = []
    for k, j in jl.items():
        t = tl[k]
        assert t.shape == j.shape and t.dtype == j.dtype == np.float32, k
        leaf = k.rsplit("/", 1)[1]
        if k.startswith("erb/"):
            np.testing.assert_array_equal(t, np.asarray(erb[leaf]), err_msg=k)
        elif leaf in bn:
            assert np.all(t == bn[leaf]), k
        elif leaf == "alpha":
            assert t == alpha, k
        else:
            scaled.append(t.ravel() / _init_bound(k, tl))
    # pooled over the 17,627 random values, v/b is U(-1, 1)
    v = np.concatenate(scaled)
    assert v.size == 17627 and np.abs(v).max() <= 1.0
    assert v.min() < -0.99 and v.max() > 0.99
    assert abs(v.mean()) < 0.02 and abs(v.std() - 1 / np.sqrt(3)) < 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_and_pack_weights_match_jax(setup, dtype):
    _model, params, tp, _spec = setup
    jw = jfs.pack_weights(params, getattr(jnp, dtype))
    tw = tfs.pack_weights(tp, getattr(torch, dtype), device="cpu")
    assert len(tw.entries()) == len(jw) == tfs.N_WEIGHTS == 158
    assert tw.buf.dtype == getattr(torch, dtype) and tw.buf.dim() == 1
    for i, (j, t) in enumerate(zip(jw, tw.entries())):
        j = np.asarray(j, np.float32)
        t = t.float().numpy()
        assert t.size == j.size, i
        assert np.abs(t.reshape(j.shape) - j).max() <= 1e-7, i


def test_load_params_npz(setup, tmp_path):
    _model, pnp, tp, _spec = setup
    path = tmp_path / "params.npz"
    np.savez(path, **_leaves(pnp))
    loaded = _leaves(load_params_npz(str(path), device="cpu"))
    for k, v in _leaves(tp).items():
        np.testing.assert_array_equal(loaded[k].numpy(), v.numpy())


def _random_taps(rng):
    return {name: tuple(rng.standard_normal(shape + (B,)).astype(np.float32) * 0.3
                        for _ in range(2))
            for name, _L, _d, shape in tfs.RING_DEFS}


def _jax_W(params):
    return jfs._unpack(jfs.pack_weights(params))[0]


def test_plain_forward_matches_jax_forward_values(setup):
    _model, params, tp, spec = setup
    rng = np.random.default_rng(1)
    taps = _random_taps(rng)
    spec_t = spec[:, :, 0].transpose(2, 1, 0).copy()  # (2, 257, B)
    jout, jfr = jfs._forward_values(
        _jax_W(params), jnp.asarray(spec_t),
        {k: tuple(map(jnp.asarray, v)) for k, v in taps.items()}, jnp.float32)
    W = tfs.unpack(tfs.pack_weights(tp, device="cpu"))
    tout, tfr = tfs.forward_plain(
        W, torch.from_numpy(spec_t), {k: tuple(map(torch.from_numpy, v))
                                      for k, v in taps.items()})
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL)
    assert sorted(tfr) == sorted(jfr)
    for k in jfr:
        np.testing.assert_allclose(tfr[k].numpy(), np.asarray(jfr[k]), atol=TOL,
                                   err_msg=k)


def _block_inputs(rng, F=33):
    x = rng.standard_normal((16, F, B)).astype(np.float32) * 0.5
    taps = [rng.standard_normal((16, F, B)).astype(np.float32) * 0.5 for _ in range(2)]
    etaps = [rng.random((8, B)).astype(np.float32) for _ in range(2)]
    return x, taps, etaps


def _t(*a):
    return [torch.from_numpy(v) for v in a]


@pytest.mark.parametrize("deconv", [False, True])
def test_gtconv_channel_interleave(setup, deconv):
    """Output channel 2i is the gated half h3*g, 2i+1 the passive x[8+i]."""
    _model, params, tp, _spec = setup
    rng = np.random.default_rng(2)
    x, taps, etaps = _block_inputs(rng)
    name = "de0" if deconv else "en2"
    W = tfs.unpack(tfs.pack_weights(tp, device="cpu"))[name]
    out, _h, _e = tfs._gtconv(_t(x)[0], W, _t(*taps), _t(*etaps), deconv)
    np.testing.assert_array_equal(out[1::2].numpy(), x[8:])
    jout, _, _ = jfs._gtconv(jnp.asarray(x), _jax_W(params)[name],
                             tuple(map(jnp.asarray, taps)),
                             tuple(map(jnp.asarray, etaps)), deconv, jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL)


@pytest.mark.parametrize("deconv", [False, True])
def test_rings_store_pw1_output_and_tra_energy(setup, deconv):
    """The GTConv dw ring stores h = PReLU(pw1(x[:8])), not the block input;
    the TRA ring stores e = mean_F(h3^2)."""
    _model, _params, tp, _spec = setup
    rng = np.random.default_rng(3)
    x, taps, etaps = _block_inputs(rng)
    name = "de1" if deconv else "en3"
    W = tfs.unpack(tfs.pack_weights(tp, device="cpu"))[name]
    out, h, e = tfs._gtconv(_t(x)[0], W, _t(*taps), _t(*etaps), deconv)
    xt = torch.from_numpy(x)
    want_h = tfs._prelu(torch.tensordot(W["pw1_w"], xt[:8], dims=1)
                        + W["pw1_b"][:, None, None], W["a1"])
    np.testing.assert_array_equal(h.numpy(), want_h.numpy())
    # h3 is recoverable from the gated half: out[2i] = h3[i] * g[i] with g > 0
    gated = out[0::2]
    g = gated.abs().amax(dim=1, keepdim=True)
    assert torch.all(g > 0)
    # recompute h3 through the block's own layers and check e
    freq = tfs._full_freq3 if deconv else tfs._dw_freq3
    y = (freq(_t(taps[0])[0], W["dw_w"], 0) + freq(_t(taps[1])[0], W["dw_w"], 1)
         + freq(h, W["dw_w"], 2) + W["dw_b"][:, None, None])
    h3 = torch.tensordot(W["pw2_w"], tfs._prelu(y, W["a2"]), dims=1) + W["pw2_b"][:, None, None]
    np.testing.assert_allclose(e.numpy(), (h3 * h3).mean(dim=1).numpy(), rtol=1e-6)
    # TCN rings store the pw1 output as well
    Wt = tfs.unpack(tfs.pack_weights(tp, device="cpu"))["gtcn1b2"]
    _o, ht = tfs._tcn(xt, Wt, _t(*taps))
    want = tfs._prelu(torch.tensordot(Wt["pw1_w"], xt, dims=1)
                      + Wt["pw1_b"][:, None, None], Wt["a1"])
    np.testing.assert_array_equal(ht.numpy(), want.numpy())


@pytest.mark.parametrize("block", ["en2", "de0", "gtcn2b3"])
def test_tap_order(setup, block):
    """taps = (x_{t-2d}, x_{t-d}) multiply dw_w[0] and dw_w[1]; the current
    frame multiplies dw_w[2].  Held against JAX with distinct taps, and the
    result must change when the taps are swapped."""
    _model, params, tp, _spec = setup
    rng = np.random.default_rng(4)
    x, taps, etaps = _block_inputs(rng)
    W = tfs.unpack(tfs.pack_weights(tp, device="cpu"))[block]
    JW = _jax_W(params)[block]
    if block.startswith("gtcn"):
        run = lambda tt: tfs._tcn(_t(x)[0], W, _t(*tt))[0]
        ref = jfs._tcn(jnp.asarray(x), JW, tuple(map(jnp.asarray, taps)), jnp.float32)[0]
    else:
        deconv = block.startswith("de")
        run = lambda tt: tfs._gtconv(_t(x)[0], W, _t(*tt), _t(*etaps), deconv)[0]
        ref = jfs._gtconv(jnp.asarray(x), JW, tuple(map(jnp.asarray, taps)),
                          tuple(map(jnp.asarray, etaps)), deconv, jnp.float32)[0]
    out = run(taps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)
    assert np.abs(run(taps[::-1]).numpy() - out.numpy()).max() > 1e-3


def test_stride2_conv_geometry(setup):
    """(1,5) stride-2 conv, pad 2, even/odd split: 129 -> 65 -> 33."""
    _model, params, tp, _spec = setup
    rng = np.random.default_rng(5)
    W = tfs.unpack(tfs.pack_weights(tp, device="cpu"))
    JW = _jax_W(params)
    x = rng.standard_normal((3, 129, B)).astype(np.float32)
    y = tfs._conv5_stride2(_t(x)[0], W["en0"]["w"], W["en0"]["b"], W["en0"]["a"])
    z = tfs._conv5_stride2(y, W["en1"]["w"], W["en1"]["b"], W["en1"]["a"])
    assert y.shape == (16, 65, B) and z.shape == (16, 33, B)
    jy = jfs._conv5_stride2(jnp.asarray(x), JW["en0"]["w"], JW["en0"]["b"],
                            JW["en0"]["a"], jnp.float32)
    jz = jfs._conv5_stride2(jy, JW["en1"]["w"], JW["en1"]["b"], JW["en1"]["a"],
                            jnp.float32)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=TOL)


def test_transposed_conv_geometry(setup):
    """(1,5) transposed conv: zero-stuff, pad 2: 33 -> 65 -> 129; PReLU after
    de3 only, tanh after de4."""
    _model, params, tp, _spec = setup
    rng = np.random.default_rng(6)
    W = tfs.unpack(tfs.pack_weights(tp, device="cpu"))
    JW = _jax_W(params)
    x = rng.standard_normal((16, 33, B)).astype(np.float32)
    y = tfs._deconv5_up2(_t(x)[0], W["de3"]["w"], W["de3"]["b"])
    z = tfs._deconv5_up2(tfs._prelu(y, W["de3"]["a"]), W["de4"]["w"], W["de4"]["b"])
    assert y.shape == (16, 65, B) and z.shape == (2, 129, B)
    jy = jfs._deconv5_up2(jnp.asarray(x), JW["de3"]["w"], JW["de3"]["b"], jnp.float32)
    jz = jfs._deconv5_up2(jfs._prelu(jy, JW["de3"]["a"]), JW["de4"]["w"],
                          JW["de4"]["b"], jnp.float32)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=TOL)


def test_skip_order(setup, monkeypatch):
    """The decoder adds skips[4-i] before de0-de2, skips[1] before de3 and
    skips[0] before de4: each block must see the skip of its own width and
    position, checked by recording what the blocks receive."""
    _model, _params, tp, spec = setup
    W = tfs.unpack(tfs.pack_weights(tp, device="cpu"))
    taps = {k: tuple(map(torch.from_numpy, v))
            for k, v in _random_taps(np.random.default_rng(7)).items()}
    seen, skips = [], []
    gt, dc = tfs._gtconv, tfs._deconv5_up2

    def gtconv(x, Wb, dw, tra, deconv):
        out = gt(x, Wb, dw, tra, deconv)
        (seen if deconv else skips).append(x if deconv else out[0])
        return out

    def deconv(x, w, b):
        seen.append(x)
        return dc(x, w, b)

    monkeypatch.setattr(tfs, "_gtconv", gtconv)
    monkeypatch.setattr(tfs, "_deconv5_up2", deconv)
    spec_t = torch.from_numpy(spec[:, :, 0].transpose(2, 1, 0).copy())
    tfs.forward_plain(W, spec_t, taps)
    x = tfs._sfe(W, tfs._erb_features(W, spec_t))
    s0 = tfs._conv5_stride2(x, W["en0"]["w"], W["en0"]["b"], W["en0"]["a"])
    s1 = tfs._conv5_stride2(s0, W["en1"]["w"], W["en1"]["b"], W["en1"]["a"])
    all_skips = [s0, s1] + skips  # skips[2..4] are the encoder GTConv outputs
    trunk = all_skips[4]
    for st in range(2):
        for k in range(4):
            trunk = tfs._tcn(trunk, W[f"gtcn{st + 1}b{k}"], taps[f"tcn{st}{k}"])[0]
    assert len(seen) == 5
    want = trunk + all_skips[4]  # de0's input
    for i in range(5):
        torch.testing.assert_close(seen[i], want, rtol=0, atol=0)
        if i < 3:
            prev = gt(seen[i], W[f"de{i}"], taps[f"dec{i}_dw"], taps[f"dec{i}_tra"], True)[0]
            want = prev + all_skips[3 - i]  # skips 3, 2 for de1, de2; 1 for de3
        elif i == 3:
            want = tfs._prelu(dc(seen[3], W["de3"]["w"], W["de3"]["b"]), W["de3"]["a"])
            want = want + all_skips[0]


def test_mag_and_low_bins_pass_through(setup):
    """mag = sqrt(re^2 + im^2 + 1e-12); bins 0-64 pass the ERB merge and
    split unchanged."""
    _model, _params, tp, spec = setup
    W = tfs.unpack(tfs.pack_weights(tp, device="cpu"))
    s = torch.from_numpy(spec[:, :, 0].transpose(2, 1, 0).copy())
    s[:, 3] = 0.0  # a silent bin: mag is sqrt(1e-12), not 0
    x = tfs._erb_features(W, s)
    re, im = s[0], s[1]
    np.testing.assert_array_equal(x[0, :65].numpy(),
                                  torch.sqrt(re * re + im * im + 1e-12)[:65].numpy())
    assert float(x[0, 3].min()) == pytest.approx(1e-6)
    np.testing.assert_array_equal(x[1:, :65].numpy(), s[:, :65].numpy())
    m = torch.from_numpy(np.random.default_rng(8).random((2, 129, B)).astype(np.float32))
    out = tfs._apply_mask(W, m, s)
    np.testing.assert_array_equal(out[0, :65].numpy(),
                                  (re[:65] * m[0, :65] - im[:65] * m[1, :65]).numpy())


def test_fused_step_matches_jax_fused_and_ring(setup, jax_fused):
    _model, _params, tp, spec = setup
    jout, _st10, ring = jax_fused
    m = tfs.FusedGTCRNMicro(tp, device="cpu")
    out, state = _port_stream(m, m.init_state(B), spec)
    assert out.shape == spec.shape and state["step"] == T & 15
    np.testing.assert_allclose(out, jout, atol=TOL)
    np.testing.assert_allclose(out, ring, atol=TOL)
    assert m.launches == 0  # CPU tensors take the plain version


def test_grid_fused_matches_jax_grid(setup, jax_grid):
    _model, _params, tp, spec = setup
    jout, _st3 = jax_grid
    m = GridFusedGTCRNMicro(tp, device="cpu")
    out, _ = _port_stream(m, m.init_state(B), spec, 0, 6)
    np.testing.assert_allclose(out, jout, atol=TOL)
    assert m.launches == 0


@pytest.mark.parametrize("layout", ["fused", "grid", "layout"])
def test_state_carry_from_jax(setup, jax_fused, jax_grid, layout):
    """Run JAX, convert its state with state_from_jax, continue in the port.
    The fused case resumes at frame 10 and crosses the 16-slot ring wrap."""
    _model, params, tp, spec = setup
    m = GridFusedGTCRNMicro(tp, device="cpu")
    if layout == "fused":  # tile-major (L, nt, *frame, tile)
        jout, st, t0, t1 = jax_fused[0], jax_fused[1], 10, T
    elif layout == "grid":  # (L, *frame padded to 40, B)
        jout, st, t0, t1 = jax_grid[0], jax_grid[1], 3, 6
    else:  # JAX LayoutGTCRNMicro: already the port's layout
        jm = jfs.LayoutGTCRNMicro(params)
        jout, jst = _stream(jm.step, jm.init_state(B), spec, 0, 18)
        st, t0, t1 = _state_np(jst), 18, 18
        jout = np.concatenate([jout, _stream(jm.step, jst, spec, 18, T)[0]], axis=2)
        t1 = T
    state = state_from_jax(st, device="cpu")
    assert state["step"] == t0 & 15
    for name, L, _d, shape in tfs.RING_DEFS:
        assert tuple(state[name].shape) == (L,) + shape + (B,)
    out, _ = _port_stream(m, state, spec, t0, t1)
    np.testing.assert_allclose(out, jout[:, :, t0:t1], atol=TOL)
