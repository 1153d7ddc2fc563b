"""The port's layered GTCRN-Micro model (gtcrn_micro_tpu_torch.nn,
models.gtcrn_micro.GTCRNMicro) held against the JAX package's, on the CPU.

The same numpy params go into both: the JAX init (PRNGKey(0)) with seeded
non-trivial BatchNorm statistics, so every BatchNorm does work.  The JAX
references run eagerly (no jit: a full-model CPU compile takes minutes).

Tolerances are those of the JAX package's own tests for the same
quantities: spectra atol 1e-5 (tests/models/test_gtcrn_micro.py:67-286),
served audio 5e-7 against the offline pipeline (tests/test_serve.py:178-205),
fp8 rings SNR > 10 dB (:210-230).  The JAX package has no test of the
BatchNorm batch statistics' values: each is held at rtol 1e-5 of its norm,
since a channel whose batch mean is near zero carries the float32 noise of
its ~800-term sum (~3e-8), far above 1e-5 of that mean (measured: 2e-7 of
the norm).  Measured gaps: apply 1.8e-7; training apply 4.6e-6 on outputs
up to 3.3 (every BatchNorm divides by a batch deviation, which amplifies the
float32 noise of the sums: 5e-6 to 1.2e-5 at 12 or 16 frames, hence 24);
the ring step 2.4e-7 and its state 4.2e-7; ring chunks 0 and psum chunks
1.8e-7 against apply; the plain fused backend 8.9e-8.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu.models.folding import fold_bn_params as j_fold
from gtcrn_micro_tpu.serve import CohortServer as JServer
from gtcrn_micro_tpu_torch.dsp.stft import istft, sqrt_hann_window, stft
from gtcrn_micro_tpu_torch.io.params import state_from_jax
from gtcrn_micro_tpu_torch.models.folding import fold_bn_params
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, init_params
from gtcrn_micro_tpu_torch.models.registry import get_model
from gtcrn_micro_tpu_torch.ops.fused_step import LayoutGTCRNMicro
from gtcrn_micro_tpu_torch.serve import CohortServer
from gtcrn_micro_tpu_torch.utils.complexity import param_count

TOL = 1e-5
FP8 = torch.float8_e4m3fn


def _randomise_bn(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomise_bn(v, rng)
        elif k in ("running_mean", "beta"):
            tree[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        elif k in ("running_var", "gamma"):
            tree[k] = (1 + rng.random(v.shape) * 0.5).astype(np.float32)


def _spec(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)


def _snr(ref, x):
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((x - ref) ** 2), 1e-20))


@pytest.fixture(scope="module")
def setup():
    jm = JModel()
    pnp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    _randomise_bn(pnp, np.random.default_rng(0))
    return jm, pnp, GTCRNMicro.from_params(pnp, device="cpu")


def _stream(model, state, spec, T=1):
    """The port's step over spec (B, F, N, 2) in chunks of T frames."""
    outs = []
    for t0 in range(0, spec.shape[2], T):
        y, state = model.step(state, torch.from_numpy(spec[:, :, t0 : t0 + T]))
        outs.append(y.numpy())
    return np.concatenate(outs, axis=2), state


@pytest.fixture(scope="module")
def jax_ring_run(setup):
    """The JAX ring step over 20 frames: spec, outputs, final state."""
    jm, pnp, _ = setup
    spec = _spec((2, 257, 20, 2), 7)
    state, outs = jm.init_state(2), []
    for t in range(20):
        y, state = jm.step(pnp, state, jnp.asarray(spec[:, :, t : t + 1]))
        outs.append(np.asarray(y))
    return spec, np.concatenate(outs, axis=2), jax.tree.map(np.asarray, state)


def test_apply_matches_jax(setup):
    jm, pnp, tm = setup
    spec = _spec((2, 257, 12, 2), 1)
    want = np.asarray(jm.apply(pnp, jnp.asarray(spec)))
    got = tm.apply(torch.from_numpy(spec)).detach().numpy()
    assert got.shape == (2, 257, 12, 2)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_training_apply_and_stats_match_jax(setup):
    jm, pnp, tm = setup
    # 24 frames: the batch statistics of 2 x 24 x F values per channel
    spec = _spec((2, 257, 24, 2), 2)
    want, jstats = jm.apply(pnp, jnp.asarray(spec), training=True)
    got, stats = tm.apply(torch.from_numpy(spec), training=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL)
    assert set(stats) == set(jstats) and len(stats) == 2 * 46
    for k, v in stats.items():
        ref = np.asarray(jstats[k])
        assert v.dtype == torch.float32 and not v.requires_grad
        assert np.linalg.norm(v.numpy() - ref) <= 1e-5 * np.linalg.norm(ref), k
    # the forward never touches the running statistics
    assert torch.equal(tm.encoder.en0.bn.running_mean,
                       torch.from_numpy(pnp["encoder"]["en0"]["bn"]["running_mean"]))


def test_causality(setup):
    """Two signals with a common prefix: identical output over the prefix,
    different after it (pattern of tests/models/test_gtcrn_micro.py:40-59)."""
    _, _, tm = setup
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal((1, 8000)).astype(np.float32) for _ in range(3))
    w = sqrt_hann_window(512, device="cpu")
    ys = []
    for x in (np.concatenate([a, b], 1), np.concatenate([a, c], 1)):
        with torch.no_grad():
            ys.append(istft(tm.apply(stft(torch.from_numpy(x), w)), w)[0].numpy())
    prefix = 8000 - 256 * 2
    assert np.abs(ys[0][:prefix] - ys[1][:prefix]).max() == 0.0
    assert np.abs(ys[0][8000:] - ys[1][8000:]).max() > 0.0


def test_ring_step_matches_jax(setup, jax_ring_run):
    """T = 1 ring step over 20 frames (one counter wrap): every output and
    every state entry against the JAX step."""
    _, _, tm = setup
    spec, want, jstate = jax_ring_run
    got, state = _stream(tm, tm.init_state(2), spec)
    np.testing.assert_allclose(got, want, atol=TOL)
    assert set(state) == set(jstate) and state["step"] == int(jstate["step"]) == 4
    for k, v in state.items():
        if k != "step":
            np.testing.assert_allclose(v.numpy(), jstate[k], atol=TOL, err_msg=k)


@pytest.mark.parametrize("T", [2, 4, 8, 16])
def test_chunked_ring_matches_apply(setup, T):
    """T-frame ring chunks over 32 frames (two counter wraps): slabs with
    d >= T, the time-ordered window with d < T (tests/models/
    test_gtcrn_micro.py:270-286)."""
    _, _, tm = setup
    spec = _spec((2, 257, 32, 2), 11)
    with torch.no_grad():
        want = tm.apply(torch.from_numpy(spec)).numpy()
    got, state = _stream(tm, tm.init_state(2), spec, T)
    np.testing.assert_allclose(got, want, atol=TOL)
    assert state["step"] == 0


def test_shift_state_chunks_of_three_match_apply(setup):
    _, _, tm = setup
    spec = _spec((1, 257, 12, 2), 3)
    with torch.no_grad():
        want = tm.apply(torch.from_numpy(spec)).numpy()
    state = tm.init_state(1, ring=False)
    assert "step" not in state
    got, _ = _stream(tm, state, spec, 3)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("T", [1, 2, 4, 16])
def test_psum_state_matches_apply(setup, T):
    """l2_psum: the 14 L == 2 caches carry partial-output pairs, the 6
    L >= 4 rings stay rings (tests/models/test_gtcrn_micro.py:169-207)."""
    _, _, tm = setup
    spec = _spec((2, 257, 32, 2), 13)
    with torch.no_grad():
        want = tm.apply(torch.from_numpy(spec)).numpy()
    state = tm.init_state(2, l2_psum=True)
    assert len([k for k in state if k.endswith("psum_a")]) == 14
    assert len([k for k in state if k.endswith("/ring")]) == 6
    got, _ = _stream(tm, state, spec, T)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_fp8_rings(setup):
    _, _, tm = setup
    spec = _spec((1, 257, 20, 2), 17)
    with torch.no_grad():
        want = tm.apply(torch.from_numpy(spec)).numpy()
    state = tm.init_state(1, store_dtype=FP8)
    rings = [k for k in state if k.endswith("/ring")]
    assert len(rings) == 20 and all(state[k].dtype == FP8 for k in rings)
    got, _ = _stream(tm, state, spec)
    assert np.isfinite(got).all()
    assert _snr(want, got) > 10.0


@pytest.mark.parametrize("mode", ["ring", "shift", "psum", "psum+fp8"])
def test_state_inventory_matches_jax(setup, mode):
    """Keys, shapes and dtypes of ``init_state`` are the JAX package's, and
    the shift state is the reference's canonical inventory (tests/models/
    test_gtcrn_micro.py:86-96)."""
    jm, _, tm = setup
    opts = {"ring": {}, "shift": {"ring": False}, "psum": {"l2_psum": True},
            "psum+fp8": {"l2_psum": True, "store_dtype": FP8}}[mode]
    jopts = dict(opts, store_dtype=jnp.float8_e4m3fn) if "store_dtype" in opts else opts
    state = tm.init_state(4, **opts)
    jstate = jm.init_state(4, **jopts)
    assert sorted(state) == sorted(jstate)
    for k, v in state.items():
        if k == "step":
            assert v == 0
        else:
            assert tuple(v.shape) == jstate[k].shape, k
            assert str(v.dtype).split(".")[1] == jstate[k].dtype.name, k
    if mode == "shift":
        conv = [k for k in state if k.endswith("depth_conv/cache")]
        tra = [k for k in state if k.endswith("tra/cache")]
        tcn = [k for k in state if "/conv2/cache" in k]
        assert len(conv) == 6 and all(state[k].shape == (4, 2, 33, 16) for k in conv)
        assert len(tra) == 6 and all(state[k].shape == (4, 2, 8) for k in tra)
        assert sorted(state[k].shape[1] for k in tcn) == [2, 2, 4, 4, 8, 8, 16, 16]


def test_param_count_and_params_round_trip(setup):
    _, pnp, tm = setup
    tree = tm.params()
    assert jax.tree.structure(jax.tree.map(lambda v: 0, tree)) == \
        jax.tree.structure(jax.tree.map(lambda v: 0, pnp))
    for path, v in jax.tree_util.tree_leaves_with_path(pnp):
        node = tree
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), v)
    assert param_count(tree) == 19014  # reference gtcrn_micro/README.md:25
    assert param_count(init_params(device="cpu")) == 19014
    assert param_count(tree, trainable_only=False) == 44938
    assert sum(p.numel() for p in tm.parameters()) == 19014
    model = get_model("gtcrn_micro", n_fft=512, hop_len=256, win_len=512, device="cpu")
    model.load_params(tree)
    spec = torch.from_numpy(_spec((1, 257, 4, 2), 5))
    with torch.no_grad():
        assert torch.equal(model.apply(spec), tm.apply(spec))
    with pytest.raises(KeyError):
        get_model("nope")


def test_fold_bn_params_matches_jax(setup):
    """The folded params equal JAX's fold and give the same forward
    (tests/models/test_gtcrn_micro.py:259-267)."""
    _, pnp, tm = setup
    want = jax.tree.map(np.asarray, j_fold(pnp))
    folded = fold_bn_params(tm.params())
    got = jax.tree.map(lambda v: v.numpy(), folded)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=0)
    spec = torch.from_numpy(_spec((1, 257, 6, 2), 9))
    with torch.no_grad():
        ref = tm.apply(spec)
        out = GTCRNMicro.from_params(folded, device="cpu").apply(spec)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL)


def test_state_from_jax_continues(setup, jax_ring_run):
    """A stepped JAX layered state converts 1:1 and both packages continue
    from it to the same outputs; a psum + fp8 state converts bit for bit
    with its dtypes."""
    jm, pnp, tm = setup
    _, _, jstate = jax_ring_run
    state = state_from_jax(jstate, device="cpu")
    assert state["step"] == 4
    spec = _spec((2, 257, 4, 2), 21)
    got, _ = _stream(tm, state, spec)
    js, want = {k: jnp.asarray(v) for k, v in jstate.items()}, []
    for t in range(4):
        y, js = jm.step(pnp, js, jnp.asarray(spec[:, :, t : t + 1]))
        want.append(np.asarray(y))
    np.testing.assert_allclose(got, np.concatenate(want, axis=2), atol=TOL)

    js = jm.init_state(1, l2_psum=True, store_dtype=jnp.float8_e4m3fn)
    js = {k: (v if k == "step" else jnp.asarray(np.random.default_rng(1).standard_normal(v.shape),
                                                v.dtype))
          for k, v in js.items()}
    conv = state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    for k, v in conv.items():
        if k != "step":
            assert v.dtype == (FP8 if k.endswith("/ring") else torch.float32), k
            np.testing.assert_array_equal(v.float().numpy(), np.asarray(js[k], np.float32))


def test_ring_step_matches_plain_fused_backend(setup):
    """The layered step and the plain version of the fused kernels
    (LayoutGTCRNMicro, BatchNorm folded, another layout) over 24 frames."""
    _, pnp, tm = setup
    spec = _spec((4, 257, 24, 2), 23) * 0.4
    got, _ = _stream(tm, tm.init_state(4), spec)
    plain = LayoutGTCRNMicro(pnp, device="cpu")
    want, _ = _stream(plain, plain.init_state(4), spec)
    np.testing.assert_allclose(got, want, atol=TOL)


# ---------------------------------------------------------------------------
# the layered backend of the cohort server
# ---------------------------------------------------------------------------


def test_layered_audio_server_chunk_hops2(setup):
    """chunk_hops = 2: the served audio equals the port's offline stft ->
    apply -> istft (5e-7, tests/test_serve.py:178-205) and the JAX server
    on the same params, run eagerly (the audio bound 2e-6 of
    tests/test_torch_serve.py)."""
    jm, pnp, tm = setup
    rng = np.random.default_rng(3)
    hops = 12
    x = rng.standard_normal((2, 256 * hops)).astype(np.float32) * 0.3
    x[:, :257] = 0.0  # the stream's left context equals the offline reflect pad
    srv = CohortServer(tm, None, batch=2, n_cohorts=1, dtype=torch.float32, mode="audio",
                       dft="fft", device="cpu", chunk_hops=2)
    jsrv = JServer(jm, pnp, batch=2, n_cohorts=1, dtype=jnp.float32, mode="audio",
                   dft="fft", chunk_hops=2)
    outs, jouts = [], []
    with jax.disable_jit():
        for t in range(hops // 2):
            c = x[:, 512 * t : 512 * (t + 1)]
            outs.append(srv.step(0, torch.from_numpy(c)).numpy())
            jouts.append(np.asarray(jsrv.step(0, jnp.asarray(c))))
    assert srv.frames_served == hops
    y = np.concatenate(outs, axis=-1)
    np.testing.assert_allclose(y, np.concatenate(jouts, axis=-1), atol=2e-6)
    w = sqrt_hann_window(512, device="cpu")
    with torch.no_grad():
        off = istft(tm.apply(stft(torch.from_numpy(x), w)), w, length=x.shape[1]).numpy()
    y = y[:, 256:]  # drop the center-trim hop
    np.testing.assert_allclose(y, off[:, : y.shape[1]], atol=5e-7)


def test_layered_server_options(setup):
    """chunk_hops 3 is refused whatever the backend, the fused backends
    refuse throughput mode, and ``state_opts`` reach the layered state."""
    _, pnp, tm = setup
    for model in (tm, None):
        with pytest.raises(ValueError, match="power of two"):
            CohortServer(model, pnp, batch=2, n_cohorts=1, dtype=torch.float32,
                         device="cpu", chunk_hops=3)
    with pytest.raises(ValueError, match="chunks of"):
        CohortServer(LayoutGTCRNMicro(pnp, device="cpu"), pnp, batch=2, n_cohorts=1,
                     dtype=torch.float32, device="cpu", chunk_hops=4)
    with pytest.raises(ValueError):  # the server's dtype must be the model's
        CohortServer(tm, None, batch=2, n_cohorts=1, dtype=torch.bfloat16, device="cpu")
    srv = CohortServer(tm, None, batch=2, n_cohorts=2, dtype=torch.float32, mode="spec",
                       device="cpu", chunk_hops=16,
                       state_opts={"l2_psum": True, "store_dtype": FP8})
    st = srv._states[1][0]  # the only shard
    assert len([k for k in st if k.endswith("psum_a")]) == 14
    assert all(v.dtype == FP8 for k, v in st.items() if k.endswith("/ring"))
    out = srv.step(1, torch.from_numpy(_spec((2, 257, 16, 2), 4)))
    assert out.shape == (2, 257, 16, 2) and st["step"] == 0 and srv.frames_served == 16


def test_layered_reset_slot_zeroes_axis_0(setup):
    """The layered state is (B, L, F, C): a reset zeroes the slot's row
    (axis 0) of every state tensor and of the DSP buffers, and nothing of
    the other streams."""
    _, _, tm = setup
    srv = CohortServer(tm, None, batch=3, n_cohorts=1, dtype=torch.float32, mode="audio",
                       device="cpu", chunk_hops=4)
    rng = np.random.default_rng(2)
    for _ in range(2):
        srv.step(0, torch.from_numpy(rng.standard_normal((3, 1024)).astype(np.float32)))
    srv.reset_slot(0, 1)
    (d,) = srv._dsp[0][0]  # cohort 0, its only shard
    tensors = [(k, v) for k, v in srv._states[0][0].items() if k != "step"]
    for k, v in tensors + [("in_buf", d.in_buf), ("ola_buf", d.ola_buf)]:
        assert v.shape[0] == 3, k
        assert float(v[1].abs().max()) == 0.0, k
        assert float(v[0].abs().max()) > 0.0 and float(v[2].abs().max()) > 0.0, k
