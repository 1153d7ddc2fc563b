"""The port's AdaRound (gtcrn_micro_tpu_torch.quant.adaround) held against the
JAX package's on the CPU.

Setup as tests/quant/test_adaround.py: ``GTCRNMicro().init(PRNGKey(3))``,
int8 activation params from 2 seeded calibration specs (the ranges observed
by the port's observer, which matches JAX's to an ulp; both sides then get
the same params, JAX's ``act_qparams`` carried across bit for bit), and
seeded white-noise batches.  JAX's references are jitted (an eager JAX
forward of the full model takes tens of seconds here).  Bounds and why:

- ``_h``, ``_h_init``, the soft weight: float32 elementwise, but JAX's and
  PyTorch's sigmoid and log differ by an ulp (measured 2.4e-7 on the
  rounding variables): 1e-6; hard rounding and the bake are bit-identical;
- LSQ fake-quant: ``exp`` differs by an ulp, so a value on a rounding tie
  may move one quantum: values within one quantum, and all but a few of
  them equal; gradients the same rule;
- one AdaRound step (phase 10's rule in chip_smoke.py): loss, MSE and
  regulariser within 1e-5 relative, each group's gradients within 1e-4 of
  the group's largest (measured 1e-7 and 1.6e-6).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.dsp.stft import istft as j_istft
from gtcrn_micro_tpu.dsp.stft import sqrt_hann_window as j_window
from gtcrn_micro_tpu.dsp.stft import stft as j_stft
from gtcrn_micro_tpu.io import export_native as jexport
from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu.models.folding import fold_bn_params as j_fold
from gtcrn_micro_tpu.nn.core import Ctx as JCtx
from gtcrn_micro_tpu.quant import adaround as ja
from gtcrn_micro_tpu.quant.fake_quant import QParams as JQParams
from gtcrn_micro_tpu.quant.fake_quant import act_qparams as j_act_qparams
from gtcrn_micro_tpu_torch.dsp.stft import istft, sqrt_hann_window, stft
from gtcrn_micro_tpu_torch.io import export_native as texport
from gtcrn_micro_tpu_torch.io.params import act_qp_from_jax
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, flatten
from gtcrn_micro_tpu_torch.quant import adaround as ta
from gtcrn_micro_tpu_torch.quant.fake_quant import act_qparams, fake_quant, weight_qparams
from gtcrn_micro_tpu_torch.quant.ptq import FakeQuantizer, observe_ranges


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _exact_jit(fn, *args):
    """``jax.jit(fn)(*args)`` with XLA's algebraic simplifier off.  With it
    on, XLA turns a division by a constant into a product with the
    reciprocal (``weight_qparams``' ``amax / 127``: an ulp off in 4 % of the
    channels), which eager JAX -- how JAX's ``init_rvars`` and bake run --
    and the port do not (ROADMAP C)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})(*args)


def _jflat(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="/"): np.array(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _tflat(tree) -> dict:
    return {k.replace(".", "/"): v.detach().numpy() for k, v in flatten(tree).items()}


@pytest.fixture(scope="module")
def setup():
    jm = JModel()
    params = jm.init(jax.random.PRNGKey(3))
    pnp = jax.tree.map(np.asarray, params)
    model = GTCRNMicro.from_params(pnp, device="cpu")
    calib = np.random.default_rng(0).standard_normal((2, 257, 8, 2)).astype(np.float32) * 0.3
    ranges = observe_ranges(model, calib, batch_size=2)
    jqp = {p: j_act_qparams(jnp.float32(lo), jnp.float32(hi), 8) for p, (lo, hi) in ranges.items()}
    box = {}

    def init(p):
        rv, av, axes = ja.init_rvars(jm, p, jqp)
        box.update(axes=axes, order=(list(rv), list(av)))  # jit returns dicts key-sorted
        return rv, av

    jr, jav = _exact_jit(init, params)
    mapping = ta.quantized_weight_tree_paths(model, {k: torch.from_numpy(np.array(v))
                                                     for k, v in jr.items()})
    return dict(jm=jm, params=params, model=model, jqp=jqp, qp=act_qp_from_jax(jqp, "cpu"),
                mapping=mapping,
                jr={k: np.asarray(v) for k, v in jr.items()},
                jav={k: np.asarray(v) for k, v in jav.items()}, j_axes=box["axes"],
                j_order=box["order"])


@pytest.fixture(scope="module")
def j_bake(setup):
    """JAX's ``_bake_params`` (eager in JAX's AdaRound), jitted exactly."""
    jm = setup["jm"]
    return lambda p, rv: _exact_jit(lambda a, b: ja._bake_params(jm, a, b), p, rv)


def _perturbed(jr, seed=5, size=3.0):
    """Rounding variables moved as training would move them."""
    rng = np.random.default_rng(seed)
    return {k: (v + rng.normal(size=v.shape) * size).astype(np.float32) for k, v in jr.items()}


def _jax_missed_max(setup, params) -> dict:
    """{hook path: sign} at each channel's abs-max elements that JAX's
    ``_pin_mask`` (amax taken as scale * 127, adaround.py:68-72) leaves
    unpinned (the weight's sign there, 0 elsewhere), for the weights of
    ``params`` (a JAX tree)."""
    flat = _jflat(params)
    out = {}
    for spath, tpath in setup["mapping"].items():
        w, axis = flat[tpath], setup["j_axes"][spath]
        jax_pin = np.asarray(ja._pin_mask(jnp.asarray(w), ja.weight_qparams(jnp.asarray(w), axis)))
        true_pin = ta._pin_mask(torch.from_numpy(np.array(w)), axis).numpy()
        assert not (jax_pin & ~true_pin).any()
        out[spath] = np.where(true_pin & ~jax_pin, np.sign(w), 0.0)
    return out


def _saturate(rv: dict, missed: dict, value: float) -> dict:
    """``rv`` with the rounding variables at ``missed`` set to ``value`` times
    the weight's sign there.  +10: JAX rounds those elements (|w / s| just
    under 127) away from zero, to the nearest value that the port pins;
    -10: towards zero."""
    return {k: np.where(missed[k] != 0, np.float32(value) * missed[k], v).astype(np.float32)
            for k, v in rv.items()}


def test_rounding_pieces_match_jax():
    rng = np.random.default_rng(7)
    v = np.concatenate([rng.standard_normal(1000) * 4, [-30.0, -10.0, 0.0, 10.0, 30.0]]).astype(
        np.float32)
    np.testing.assert_allclose(ta._h(torch.from_numpy(v)).numpy(), np.asarray(ja._h(v)),
                               rtol=0, atol=1e-6)
    assert float(ta._h(torch.tensor(10.0))) == 1.0 and float(ta._h(torch.tensor(-10.0))) == 0.0
    rem = rng.uniform(0, 1, 1000).astype(np.float32)
    np.testing.assert_allclose(ta._h_init(torch.from_numpy(rem)).numpy(),
                               np.asarray(ja._h_init(jnp.asarray(rem))), rtol=0, atol=1e-6)

    w = (rng.standard_normal((4, 8)) * 0.2).astype(np.float32)
    vv = rng.standard_normal((4, 8)).astype(np.float32)
    for hard in (False, True):
        for ste in (False, True):
            got = ta.soft_quant_weight(torch.from_numpy(w), torch.from_numpy(vv), 0, hard, ste)
            want = np.asarray(ja.soft_quant_weight(jnp.asarray(w), jnp.asarray(vv), 0, hard, ste))
            if hard:
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # ste: the same forward, and a gradient of 1 inside the range (0 without)
    plain = ta.soft_quant_weight(torch.from_numpy(w), torch.from_numpy(vv), 0)
    assert torch.equal(plain, ta.soft_quant_weight(torch.from_numpy(w), torch.from_numpy(vv), 0,
                                                   ste=True))
    for ste in (False, True):
        wt = torch.from_numpy(w).requires_grad_(True)
        vt = torch.from_numpy(vv).requires_grad_(True)
        ta.soft_quant_weight(wt, vt, 0, ste=ste).sum().backward()
        jgw, jgv = jax.grad(lambda a, b: jnp.sum(ja.soft_quant_weight(a, b, 0, ste=ste)),
                            argnums=(0, 1))(jnp.asarray(w), jnp.asarray(vv))
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), rtol=0, atol=1e-5)
        np.testing.assert_allclose(vt.grad.numpy(), np.asarray(jgv), rtol=0, atol=1e-5)
        if not ste:
            assert float(wt.grad.abs().max()) == 0.0
    interior = np.abs(w) < 0.9 * np.abs(w).max(axis=1, keepdims=True)
    np.testing.assert_allclose(wt.grad.numpy()[interior], 1.0, rtol=1e-5)


def test_clip_gradient_is_jax_clip():
    """At a value on a bound ``jnp.clip`` passes half the gradient."""
    x = np.array([1.0, -1.0, 0.5, 2.0, -3.0], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    ta._clip(xt, -1.0, 1.0).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jnp.clip(a, -1.0, 1.0)))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("per_lane", [False, True])
def test_fake_quant_lsq_matches_jax(per_lane):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 9, 4)) * 0.5).astype(np.float32)
    lo, hi = (x.min(axis=(0, 1)), x.max(axis=(0, 1))) if per_lane else (x.min(), x.max())
    lo, hi = np.float32(lo) * np.float32(0.8), np.float32(hi) * np.float32(0.8)  # some clip
    jqp = j_act_qparams(jnp.asarray(lo), jnp.asarray(hi), 8)
    qp = act_qparams(lo, hi, 8)
    delta = np.asarray(rng.standard_normal(np.shape(lo)) * 0.05, np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    dt = torch.from_numpy(delta).requires_grad_(True)
    y = ta.fake_quant_lsq(xt, qp, dt)
    (y * torch.arange(y.numel()).reshape(y.shape)).sum().backward()
    weights = jnp.arange(x.size, dtype=jnp.float32).reshape(x.shape)
    jy = np.asarray(ja.fake_quant_lsq(jnp.asarray(x), jqp, jnp.asarray(delta)))
    _, (jgx, jgd) = jax.value_and_grad(
        lambda a, d: jnp.sum(ja.fake_quant_lsq(a, jqp, d) * weights), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(delta))
    s = np.asarray(qp.scale * torch.exp(dt.detach()))
    diff = np.abs(y.detach().numpy() - jy)
    assert np.all(diff <= 1.01 * np.broadcast_to(s, diff.shape)) and np.mean(diff > 0) < 0.02
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    gd = np.asarray(jgd)
    np.testing.assert_allclose(dt.grad.numpy(), gd, rtol=0, atol=2e-2 * np.abs(gd).max())


def test_init_rvars_matches_jax(setup):
    rvars, avars, axes = ta.init_rvars(setup["model"], setup["qp"])
    assert (list(rvars), list(avars)) == setup["j_order"]
    assert len(rvars) == len(avars) == 59
    assert axes == setup["j_axes"]
    for k, v in setup["jr"].items():
        np.testing.assert_allclose(rvars[k].numpy(), v, rtol=0, atol=1e-6, err_msg=k)
    for k, v in setup["jav"].items():  # carried scalar scales are (1,) (io/params.py)
        assert avars[k].numel() == v.size and not avars[k].any()
    # zero initial rounding error, up to the clip at the grid ends
    w = setup["model"].encoder.en2.point_conv1.w.detach()
    np.testing.assert_allclose(ta.soft_quant_weight(w, rvars["encoder/en2/pw1/w"], 1).numpy(),
                               w.numpy(), rtol=0, atol=1e-6)


def test_one_step_loss_and_gradients_match_jax(setup):
    jm, params, jqp = setup["jm"], setup["params"], setup["jqp"]
    rng = np.random.default_rng(5)
    n = 4096
    noisy = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)
    w = j_window(512)
    target = np.array(j_istft(jm.apply_jit(params, j_stft(jnp.asarray(noisy), w)), w, length=n))
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"): v
            for p, v in jax.tree_util.tree_leaves_with_path(params)}
    fv = {k: v for k, v in flat.items() if ja._float_trainable(k)}
    reg_weight, beta = 1e-4, 20.0

    def loss_fn(ov, spec, tgt, b):  # adaround.py:278-298 from JAX's public pieces
        rv, av, f = ov
        ctx = JCtx()
        ctx.quant = ja.AdaRoundQuantizer(jqp, rvars=rv, avars=av)
        out = jm._forward(ja._unflatten_like(params, {**flat, **f}), spec, ctx)
        mse = jnp.mean(jnp.square(j_istft(out, w, length=tgt.shape[-1]) - tgt))
        reg = sum(jnp.sum(1.0 - jnp.abs(2.0 * ja._h(v) - 1.0) ** b) for v in rv.values()) / sum(
            v.size for v in rv.values())
        return mse + reg_weight * reg, (mse, reg)

    # a trained-like state: at the zero-error init each pinned weight's h(V)
    # sits exactly on the clip's lower bound, where the tie gradient hangs on
    # the last bit of sigmoid(V) (eager JAX and the port give half, jitted
    # JAX one side); perturbed variables are off every tie.  Where JAX's pin
    # misses a channel max, V is saturated up: JAX's soft value is then the
    # nearest value that the port pins, and both gradients are 0
    rv = _saturate(_perturbed(setup["jr"], seed=6, size=1.0), _jax_missed_max(setup, params), 10.0)
    av = {k: np.asarray(rng.standard_normal(v.shape) * 0.05, np.float32)
          for k, v in setup["jav"].items()}
    jr = {k: jnp.asarray(v) for k, v in rv.items()}
    jav = {k: jnp.asarray(v) for k, v in av.items()}
    (jl, (jmse, jreg)), jg = _exact_jit(jax.value_and_grad(loss_fn, has_aux=True),
                                        (jr, jav, fv), j_stft(jnp.asarray(noisy), w),
                                        jnp.asarray(target), jnp.float32(beta))

    run = ta.AdaRound(setup["model"], setup["qp"], reg_weight=reg_weight)
    assert set(run.vars["f"]) == set(fv) and not run.vars["w"]
    run.load({"v": rv, "a": av, "f": _jflat(fv), "w": {}})
    loss, mse, reg, grads = run.gradients(noisy, target, beta)
    for got, want in ((loss, jl), (mse, jmse), (reg, jreg)):
        assert abs(float(got) / float(want) - 1) <= 1e-5, (float(got), float(want))
    for g, jgrads in zip("vaf", jg):
        jgrads = {k: np.asarray(v) for k, v in jgrads.items()}
        assert set(grads[g]) == set(jgrads)
        top = max(float(np.abs(v).max()) for v in jgrads.values())
        err = max(float(np.abs(grads[g][k].numpy() - v).max()) for k, v in jgrads.items())
        assert top > 0 and err <= 1e-4 * top, (g, err, top)


def test_bake_matches_jax_bit_for_bit(setup, j_bake):
    jm, params, model = setup["jm"], setup["params"], setup["model"]
    rv = _saturate(_perturbed(setup["jr"]), _jax_missed_max(setup, params), 10.0)
    want = _jflat(j_bake(params, {k: jnp.asarray(v) for k, v in rv.items()}))
    got = _tflat(ta._bake_params(model, {k: torch.from_numpy(v) for k, v in rv.items()}))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    box = {}
    jax.eval_shape(lambda p, r: box.update(m=ja.quantized_weight_tree_paths(jm, p, r)) or 0,
                   params, rv)
    assert setup["mapping"] == box["m"] and len(box["m"]) == 59
    # every baked weight lies on its grid, with the original scale bit for bit
    moved = 0
    for spath, tpath in setup["mapping"].items():
        axis = setup["j_axes"][spath]
        wb, wo = torch.from_numpy(got[tpath]), torch.from_numpy(_jflat(params)[tpath])
        qb = weight_qparams(wb, axis)
        assert torch.equal(qb.scale, weight_qparams(wo, axis).scale), tpath
        assert float((fake_quant(wb, qb) - wb).abs().max()) <= 1e-6 * float(wb.abs().max())
        moved += int(not torch.equal(wb, wo))
    assert moved >= 40


def test_pin_holds_the_channel_max_where_jax_misses_it(setup, j_bake):
    """ROADMAP C: JAX's ``_pin_mask`` takes amax as ``scale * 127``; where
    the float32 scale puts that above the true amax, the channel's max
    element goes unpinned.  Rounded down, it moves the re-observed scale by
    about 1/127 and the channel's other baked weights off their grid.  The
    port pins by the weight's own amax: its bake keeps every scale."""
    params, model = setup["params"], setup["model"]
    missed = _jax_missed_max(setup, params)
    n_missed = sum(int((m != 0).sum()) for m in missed.values())
    assert n_missed > 0
    rv = _saturate(_perturbed(setup["jr"]), missed, -10.0)  # round the missed maxima down
    jb = _jflat(j_bake(params, {k: jnp.asarray(v) for k, v in rv.items()}))
    tb = _tflat(ta._bake_params(model, {k: torch.from_numpy(v) for k, v in rv.items()}))
    jax_drift, jax_off_grid = 0, 0.0
    for spath, tpath in setup["mapping"].items():
        axis = setup["j_axes"][spath]
        s0 = weight_qparams(torch.from_numpy(_jflat(params)[tpath]), axis).scale
        for baked, port in ((jb[tpath], False), (tb[tpath], True)):
            wb = torch.from_numpy(baked)
            qb = weight_qparams(wb, axis)
            off = float((fake_quant(wb, qb) - wb).abs().max()) / float(wb.abs().max())
            if port:
                assert torch.equal(qb.scale, s0) and off <= 1e-6, spath
            else:
                jax_drift = max(jax_drift, float(((qb.scale - s0).abs() / s0).max()))
                jax_off_grid = max(jax_off_grid, off)
    # JAX's bake: a channel's scale moved by ~1/127, values off the grid
    assert 0.5 / 127 < jax_drift < 2 / 127 and jax_off_grid > 1e-4, (jax_drift, jax_off_grid)


def _int8_mse(model, params, act_qp, noisy, target):
    window = sqrt_hann_window(512, device="cpu")
    m = GTCRNMicro.from_params(params, device="cpu")
    with torch.no_grad():
        out = m.apply(stft(torch.from_numpy(noisy), window), quant=FakeQuantizer(act_qp))
        wav = istft(out, window, length=noisy.shape[1]).numpy()
    return float(np.mean((wav - target) ** 2))


def _targets(model, noisy):
    window = sqrt_hann_window(512, device="cpu")
    with torch.no_grad():
        return istft(model.apply(stft(torch.from_numpy(noisy), window)), window,
                     length=noisy.shape[1]).numpy()


@pytest.mark.parametrize("lr_w,steps,seed", [(0.0, 30, 1), (2e-4, 25, 5)])
def test_adaround_optimize_improves_int8(setup, lr_w, steps, seed):
    """tests/quant/test_adaround.py:166-203 (and :120-164 with ``lr_w``):
    the int8 simulation must not get worse (bound JAX's: after < 1.05
    before), the learned scales keep the calibrated integer zero points, and
    the baked weights stay on their grid."""
    model, qp = setup["model"], setup["qp"]
    rng = np.random.default_rng(seed)
    noisy = (rng.standard_normal((2, 4096)) * 0.1).astype(np.float32)
    target = _targets(model, noisy)
    before = _int8_mse(model, model.params(), qp, noisy, target)
    baked, baked_qp = ta.adaround_optimize(model, noisy, target, qp, steps=steps, batch_size=2,
                                           lr_w=lr_w, w_anchor=1e-3 if lr_w else 0.0,
                                           log_every=0)
    after = _int8_mse(model, baked, baked_qp, noisy, target)
    assert after < before * 1.05, (before, after)
    for p, q in baked_qp.items():
        assert torch.equal(q.zero, qp[p].zero)
    w_b = baked["encoder"]["en2"]["point_conv1"]["w"]
    assert float((fake_quant(w_b, weight_qparams(w_b, 1)) - w_b).abs().max()) <= 1e-6


def test_early_stop_returns_the_best_not_the_last(setup):
    """The val SNR peaks and falls (training on targets at half scale while
    the val targets are the float32 outputs): the artifact returned must
    score the best SNR seen, not the last -- the variables are updated in
    place, so keeping the best needs copies."""
    model, qp = setup["model"], setup["qp"]
    rng = np.random.default_rng(2)
    noisy = (rng.standard_normal((2, 4096)) * 0.1).astype(np.float32)
    val = (rng.standard_normal((1, 4096)) * 0.1).astype(np.float32)
    target, val_target = _targets(model, noisy) * 0.5, _targets(model, val)
    history = []
    baked, baked_qp = ta.adaround_optimize(model, noisy, target, qp, steps=12, batch_size=2,
                                           lr_f=3e-2, log_every=0, val_noisy=val,
                                           val_target=val_target, eval_every=2, patience=100,
                                           history=history)
    snrs = [s for _, s in history]
    assert [i for i, _ in history] == [2, 4, 6, 8, 10, 12]
    assert max(snrs) > snrs[-1] + 0.1, snrs  # the run does fall after its best
    window = sqrt_hann_window(512, device="cpu")
    m = GTCRNMicro.from_params(baked, device="cpu")
    with torch.no_grad():
        out = istft(m.apply(stft(torch.from_numpy(val), window), quant=FakeQuantizer(baked_qp)),
                    window, length=val.shape[1])
    t = torch.from_numpy(val_target)
    snr = float(10 * torch.log10(t.square().sum() / (out - t).square().sum()))
    assert abs(snr - max(snrs)) <= 1e-4, (snr, snrs)
    # patience: stops after that many evals without improvement
    history2 = []
    ta.adaround_optimize(model, noisy, target, qp, steps=12, batch_size=2, lr_f=3e-2,
                         log_every=0, val_noisy=val, val_target=val_target, eval_every=2,
                         patience=1, history=history2)
    first_drop = next(i for i in range(1, len(snrs)) if snrs[i] <= max(snrs[:i]))
    assert len(history2) == first_drop + 1


def test_bias_refine_trains_only_the_float_terms(setup):
    model, qp = setup["model"], setup["qp"]
    rng = np.random.default_rng(3)
    noisy = (rng.standard_normal((2, 4096)) * 0.1).astype(np.float32)
    target = _targets(model, noisy)
    refined = _tflat(ta.bias_refine(model, noisy, target, qp, steps=3, batch_size=2, lr=1e-3,
                                    log_every=0))
    start = _tflat(model.params())
    for k, v in start.items():
        if ta._float_trainable(k):
            continue
        np.testing.assert_array_equal(refined[k], v, err_msg=k)
    assert sum(not np.array_equal(refined[k], v) for k, v in start.items()) > 50


def test_act_qp_npz_round_trips_with_jax(setup, tmp_path):
    jqp = {p: JQParams(scale=q.scale * 1.5, zero=q.zero, qmin=q.qmin, qmax=q.qmax)
           for p, q in setup["jqp"].items()}
    path = str(tmp_path / "act_qp.npz")  # as gtcrn_micro_tpu/quant/adaround.py:723-733 writes it
    np.savez(path, **{f"{p}:scale": np.asarray(q.scale) for p, q in jqp.items()},
             **{f"{p}:zero": np.asarray(q.zero) for p, q in jqp.items()},
             **{f"{p}:qminmax": np.asarray([q.qmin, q.qmax]) for p, q in jqp.items()})
    got = ta.load_act_qp(path, device="cpu")
    assert set(got) == set(jqp)
    for p, q in jqp.items():
        assert got[p].scale.dtype == torch.float32 and (got[p].qmin, got[p].qmax) == (q.qmin, q.qmax)
        np.testing.assert_array_equal(got[p].scale.numpy(), np.asarray(q.scale))
        np.testing.assert_array_equal(got[p].zero.numpy(), np.asarray(q.zero))
    out = str(tmp_path / "port.npz")
    ta.save_act_qp(got, out)
    back = ja.load_act_qp(out)
    for p, q in jqp.items():
        np.testing.assert_array_equal(np.asarray(back[p].scale), np.asarray(q.scale))
        assert (back[p].qmin, back[p].qmax) == (q.qmin, q.qmax)


def test_adaround_artifact_exports_identically(setup, j_bake, tmp_path):
    """JAX's rounding variables and scale deltas carried into the port, the
    port's bake and learned scales carried back to JAX's exporter: the GTM8
    both packages write from that one bake is the same file, and JAX's own
    bake of the same variables is the port's bit for bit."""
    folded = j_fold(setup["params"])
    fmodel = GTCRNMicro.from_params(jax.tree.map(np.asarray, folded), device="cpu")
    rv = _saturate(_perturbed(setup["jr"], seed=9), _jax_missed_max(setup, folded), 10.0)
    rng = np.random.default_rng(10)
    av = {k: np.asarray(rng.standard_normal(v.shape) * 0.05, np.float32)
          for k, v in setup["jav"].items()}
    baked = ta._bake_params(fmodel, {k: torch.from_numpy(v) for k, v in rv.items()})
    baked_qp = ta.apply_avars(setup["qp"], {k: torch.from_numpy(v) for k, v in av.items()})
    j_baked = j_bake(folded, {k: jnp.asarray(v) for k, v in rv.items()})
    got, want = _tflat(baked), _jflat(j_baked)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the learned scales: torch's and XLA's float32 exp differ by an ulp
    j_qp = ja.apply_avars(setup["jqp"], {k: jnp.asarray(v) for k, v in av.items()})
    for p, q in j_qp.items():
        np.testing.assert_allclose(baked_qp[p].scale.numpy(), np.asarray(q.scale), rtol=2.4e-7)
    shape = {p: np.shape(q.scale) for p, q in setup["jqp"].items()}
    carried = {p: JQParams(scale=jnp.asarray(q.scale.numpy().reshape(shape[p])),
                           zero=jnp.asarray(q.zero.numpy().reshape(shape[p])),
                           qmin=q.qmin, qmax=q.qmax) for p, q in baked_qp.items()}
    paths = {k: str(tmp_path / f"{k}.gtm8") for k in ("port", "jax", "jax_own_bake")}
    texport.export_native_weights_int8(baked, baked_qp, paths["port"])
    jexport.export_native_weights_int8(_nested_np(baked), carried, paths["jax"])
    jexport.export_native_weights_int8(j_baked, carried, paths["jax_own_bake"])
    blobs = {k: open(p, "rb").read() for k, p in paths.items()}
    assert blobs["port"] == blobs["jax"] == blobs["jax_own_bake"]
    assert len(blobs["port"]) > 19014


def _nested_np(tree: dict) -> dict:
    return {k: _nested_np(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}
