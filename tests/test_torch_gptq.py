"""The port's GPTQ (gtcrn_micro_tpu_torch.quant.gptq) held against the JAX
package's on the CPU.

- ``gptq_rows`` is a numpy float64 copy: bit-identical to JAX's on the four
  random problems of tests/quant/test_gptq.py:56-90, with those tests'
  properties.
- The capture: every boundary's geometry, read from the port's ``conv2d``
  calls, equals JAX's ``conv_general_dilated`` call (JAX's lhs_dilation is
  the port's zero-stuffing ``freq_up``, its padding pairs the port's
  symmetric padding), and the patch algebra reproduces all 59 boundaries.
- ``gptq_params`` on the JAX test's setup (BN-folded ``PRNGKey(0)`` params,
  2 x 257 x 33 seeded specs, a16 per-lane activation params; the ranges
  from the port's observer, JAX's ``act_qparams`` on them carried across):
  every weight on its grid with its scale bit for bit, biases untouched,
  GPTQ's summed local error below nearest rounding's.  The codes against
  JAX's own bake: tests/test_torch_gptq_bake.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu.models.folding import fold_bn_params as j_fold
from gtcrn_micro_tpu.quant import gptq as jg
from gtcrn_micro_tpu.io.wav import write_wav as j_write_wav
from gtcrn_micro_tpu.quant.fake_quant import act_qparams as j_act_qparams
from gtcrn_micro_tpu_torch.io.params import act_qp_from_jax
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, flatten
from gtcrn_micro_tpu_torch.quant import gptq as tg
from gtcrn_micro_tpu_torch.quant.fake_quant import fake_quant, weight_qparams
from gtcrn_micro_tpu_torch.quant.ptq import observe_ranges


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _random_problem(seed=1, d=32, m=8, n=2048):  # tests/quant/test_gptq.py:46-53
    rng = np.random.default_rng(seed)
    mix = rng.normal(size=(d, d))
    p = rng.normal(size=(n, d)) @ mix
    w = rng.normal(size=(d, m)) * 0.1
    amax = np.abs(w).max(axis=0)
    scale = amax / tg.INT_HI
    pin = np.abs(w) >= amax[None, :] - 1e-12
    return p, w, scale, pin, amax


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_gptq_rows_bit_identical_to_jax(seed):
    p, w, scale, pin, amax = _random_problem(seed)
    if seed == 3:  # already on the grid: the identity
        w = np.clip(np.round(w / scale), tg.INT_LO, tg.INT_HI) * scale
        amax = np.abs(w).max(axis=0)
        scale, pin = amax / tg.INT_HI, np.abs(w) >= amax[None, :] - 1e-12
    if seed == 4:  # a never-firing input falls back to nearest, no NaN
        p[:, 5] = 0.0
    got = tg.gptq_rows(p, w, scale, pin)
    np.testing.assert_array_equal(got, jg.gptq_rows(p, w, scale, pin))
    nearest = np.clip(np.round(w / scale), tg.INT_LO, tg.INT_HI) * scale
    if seed == 1:
        assert tg.local_error(p, w, got) < tg.local_error(p, w, nearest)
        assert tg.local_error(p, w, got) == jg.local_error(p, w, got)
    if seed == 2:
        q = got / scale
        assert np.allclose(q, np.round(q), atol=1e-6) and np.round(np.abs(q)).max() <= tg.INT_HI
        assert np.array_equal(np.abs(got).max(axis=0), amax)
    if seed == 3:
        np.testing.assert_allclose(got, w, atol=1e-12)
    if seed == 4:
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got[5], nearest[5], atol=1e-12)


@pytest.fixture(scope="module")
def setup():
    jm = JModel()
    params = j_fold(jm.init(jax.random.PRNGKey(0)))
    model = GTCRNMicro.from_params(jax.tree.map(np.array, params), device="cpu")
    specs = np.asarray(np.random.default_rng(0).normal(size=(2, 257, 33, 2)) * 0.1, np.float32)
    ranges = observe_ranges(model, specs, batch_size=2, per_channel=True)
    jqp = {p: j_act_qparams(jnp.asarray(lo, jnp.float32), jnp.asarray(hi, jnp.float32), 16)
           for p, (lo, hi) in ranges.items()}
    return dict(jm=jm, params=params, model=model, specs=specs, jqp=jqp,
                qp=act_qp_from_jax(jqp, "cpu"))


def test_capture_geometry_matches_jax(setup):
    recs = tg.capture_boundaries(setup["model"], setup["qp"], setup["specs"])
    jrecs = jg.capture_boundaries(setup["jm"], setup["params"], setup["jqp"],
                                  jnp.asarray(setup["specs"]))
    assert [r.path for r in recs] == [r.path for r in jrecs] and len(recs) == 59
    kinds = {"conv": 0, "depth": 0, "pw": 0}
    for rec, jrec in zip(recs, jrecs):
        assert rec.channel_axis == jrec.channel_axis and tuple(rec.w.shape) == jrec.w.shape
        np.testing.assert_array_equal(rec.w.numpy(), jrec.w)
        if jrec.cfg is None:
            assert rec.cfg is None
            kinds["depth" if rec.leaf == "depth_w" else "pw"] += 1
        else:
            c = jrec.cfg
            assert rec.cfg == {
                "stride": tuple(c["window_strides"]),
                "padding": tuple(lo for lo, hi in c["padding"]),
                "dilation": tuple(c["rhs_dilation"]),
                "groups": c["feature_group_count"],
                "freq_up": c["lhs_dilation"][1],
            }, rec.path
            assert all(lo == hi for lo, hi in c["padding"]) and c["lhs_dilation"][0] == 1
            kinds["conv"] += 1
        for _ in tg._boundary_groups(rec):  # the patch check raises on a mismatch
            pass
    assert kinds == {"conv": 19, "depth": 6, "pw": 34}
    # the transposed convs that upsample frequency: de3 and de4
    assert [r.path for r in recs if r.cfg and r.cfg["freq_up"] == 2] == [
        "decoder/de3/conv/w", "decoder/de4/conv/w"]


def test_patch_check_catches_misaligned_patches(setup):
    recs = tg.capture_boundaries(setup["model"], setup["qp"], setup["specs"])
    rec = next(r for r in recs if r.cfg is not None and r.cfg["freq_up"] > 1)
    rec.x = rec.x.flip(-1)  # the same shapes, the frequencies reversed
    with pytest.raises(RuntimeError, match="patch algebra mismatch"):
        for _ in tg._boundary_groups(rec):
            pass


def test_gptq_params_on_grid_and_scale_invariant(setup):
    model, qp = setup["model"], setup["qp"]
    report = []
    baked = tg.gptq_params(model, qp, setup["specs"], report=report)
    check_bake(model, qp, setup["specs"], baked, report)


def check_bake(model, qp, specs, baked, report) -> dict:
    """Every quantized weight of ``baked`` on its grid with the original's
    scale bit for bit, the other leaves untouched, GPTQ's summed local error
    below nearest rounding's, the model finite; returns {tree path: codes}."""
    recs = tg.capture_boundaries(model, qp, specs, retain=set())
    flat_old = {k.replace(".", "/"): v for k, v in flatten(model.params()).items()}
    flat_new = {k.replace(".", "/"): v for k, v in flatten(baked).items()}
    mapping = tg._tree_mapping(recs, flat_old)
    n_changed, codes = 0, {}
    for rec in recs:
        tpath = mapping[rec.path]
        w_old, w_new = flat_old[tpath], flat_new[tpath]
        qp_old, qp_new = weight_qparams(w_old, rec.channel_axis), weight_qparams(w_new, rec.channel_axis)
        assert torch.equal(qp_old.scale, qp_new.scale), rec.path
        tol = 1e-6 * float(w_new.abs().max() + 1e-12)
        assert float((fake_quant(w_new, qp_new) - w_new).abs().max()) <= tol, rec.path
        n_changed += int(not torch.equal(w_old, w_new))
        codes[tpath] = (torch.round(w_new / qp_new.scale), qp_new.scale)
    assert n_changed >= 50
    quantized = set(mapping.values())
    for k, v in flat_old.items():
        if k not in quantized:
            assert torch.equal(v, flat_new[k]), k
    assert [r["path"] for r in report] == [r.path for r in recs]
    assert sum(r["local_err"] for r in report) < sum(r["nearest_err"] for r in report)
    out = GTCRNMicro.from_params(baked, device="cpu").apply(torch.from_numpy(specs))
    assert bool(torch.isfinite(out).all())
    return codes


def test_augmented_hessian_specs_match_jax(setup, tmp_path):
    """The input-only corpus of any wav dir (tests/quant/test_gptq.py:127-155):
    the same shape, clips and seeded determinism as JAX's; the clean
    proxies are each model's own float32 enhancement (the spectra within
    1e-5, the layered model's audio bound)."""
    rng = np.random.default_rng(7)
    for i in range(2):
        j_write_wav(str(tmp_path / f"n{i}.wav"),
                    rng.standard_normal(12000).astype(np.float32) * 0.1, 16000)
    kw = dict(n_clips=8, segment_seconds=0.5, seed=3)
    specs = tg.augmented_hessian_specs(setup["model"], str(tmp_path), **kw)
    assert specs.shape == (8, 257, 8000 // 256 + 1, 2) and specs.dtype == torch.float32
    assert torch.equal(specs, tg.augmented_hessian_specs(setup["model"], str(tmp_path), **kw))
    want = np.asarray(jg.augmented_hessian_specs(setup["jm"], setup["params"], str(tmp_path), **kw))
    np.testing.assert_allclose(specs.numpy(), want, rtol=0, atol=1e-5)
    assert len({round(float(np.linalg.norm(c)), 5) for c in want.reshape(8, -1)}) >= 6
