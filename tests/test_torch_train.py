"""The port's training path (gtcrn_micro_tpu_torch.train, utils.checkpoint,
utils.make_smoke_data) held against the JAX package's, on the CPU.

The same numpy params (the JAX init, PRNGKey(0)) and the same numpy batches
go through both.  The JAX train step is jitted once per module at the shapes
of tests/train/test_trainer.py (batch 4 x 4,096, warmup 5 / decay 100), so
the two files share the persistent compile cache.

Tolerances and why:

- loss rtol 1e-5 (measured 1.7e-7): the hybrid loss of the same spectra in
  another summation order;
- BatchNorm running statistics atol 1e-5 (measured 4.8e-7): one fold of
  batch statistics that agree to float32 rounding;
- params after three steps: the first update has a learning rate of 0, so
  two updates move a leaf by at most lr(1) + lr(2) = 6e-4 (Adam's update is
  at most the rate per element here).  Every bias of a conv or pointwise
  layer feeds a training-mode BatchNorm, which removes any constant shift:
  its true gradient is 0, both packages compute rounding noise (about 1e-7
  against 1e-5 for the gammas), and Adam scales that noise to a full +-lr
  step whose sign is a coin toss.  Those leaves are held to the bound 2 x
  6e-4 = 1.2e-3 (measured 9.0e-4).  Every other leaf is held to 1e-4, a
  sixth of the largest move (measured 4.0e-5): Adam divides each gradient by
  its own running RMS, so an element whose gradient is near 0 turns the
  packages' float32 rounding into a visible share of its step.
"""

import json
import os
import sys

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.models import GTCRNMicro as JModel
from gtcrn_micro_tpu.train import dataloader as jdl
from gtcrn_micro_tpu.train import trainer as jt
from gtcrn_micro_tpu.train.loss import hybrid_loss as j_hybrid_loss
from gtcrn_micro_tpu.train.loss import si_snr_db as j_si_snr_db
from gtcrn_micro_tpu.train.scheduler import WarmupCosineConfig as JSched
from gtcrn_micro_tpu.train.scheduler import warmup_cosine_lr as j_lr
from gtcrn_micro_tpu.utils.make_smoke_data import make_smoke_data as j_make_smoke_data
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, flatten, init_params
from gtcrn_micro_tpu_torch.train import dataloader as tdl
from gtcrn_micro_tpu_torch.train import train as train_mod
from gtcrn_micro_tpu_torch.train.loss import hybrid_loss, si_snr_db
from gtcrn_micro_tpu_torch.train.scheduler import WarmupCosineConfig, warmup_cosine_lr
from gtcrn_micro_tpu_torch.train.trainer import (
    apply_bn_stats,
    clip_by_global_norm,
    make_eval_step,
    make_optimizer,
    make_train_step,
    opt_state_from_jax,
)
from gtcrn_micro_tpu_torch.utils.checkpoint import BestTracker, CheckpointManager
from gtcrn_micro_tpu_torch.utils.config import load_config
from gtcrn_micro_tpu_torch.utils.make_smoke_data import make_smoke_data

SCHED = dict(warmup_steps=5, decay_until_step=100, max_lr=1e-3)
LR_SUM = 2e-4 + 4e-4  # lr(1) + lr(2) under SCHED; lr(0) = 0


def _batch(batch=4, n=4096, seed=0):
    """tests/train/test_trainer.py's synthetic batch, as numpy."""
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((batch, n)).astype(np.float32) * 0.05
    noisy = clean + rng.standard_normal((batch, n)).astype(np.float32) * 0.02
    return noisy, clean


def _np(tree):
    return {k: np.asarray(v) for k, v in flatten(jax.tree.map(np.asarray, tree)).items()}


def _port_flat(model):
    return {k: v.detach().numpy().copy() for k, v in flatten(model.params()).items()}


@pytest.fixture(scope="module")
def jax_run():
    """Three jitted JAX steps from the JAX init: the start, then (params,
    opt_state, loss) after each step, all numpy."""
    model = JModel()
    params = model.init(jax.random.PRNGKey(0))
    opt = jt.make_optimizer(params, JSched(**SCHED))
    opt_state = opt.init(params)
    step = jax.jit(jt.make_train_step(model, opt))
    noisy, clean = _batch()
    start = jax.tree.map(np.asarray, params)
    traj = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, noisy, clean)
        traj.append((jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt_state),
                     float(loss)))
    return start, traj, params


def _port(params_np):
    model = GTCRNMicro.from_params(params_np, device="cpu")
    opt = make_optimizer(model, WarmupCosineConfig(**SCHED), device="cpu")
    return model, opt, make_train_step(model, opt, device="cpu")


def _check_bn(model, want):
    got = _port_flat(model)
    for k, v in _np(want).items():
        if "running" in k:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)


def _check_params(model, want):
    got = _port_flat(model)
    for k, v in _np(want).items():
        if "running" in k:
            continue
        if "erb" in k:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            tol = 2 * LR_SUM if k.endswith(".b") else 1e-4
            np.testing.assert_allclose(got[k], v, rtol=0, atol=tol, err_msg=k)


# -- scheduler and loss ------------------------------------------------------


@pytest.mark.parametrize("cfg, steps", [
    ((25000, 250000, 1e-3, 1e-6), [0, 1, 100, 24999, 25000, 100000, 249999, 250000, 300000]),
    ((10, 100, 1e-3, 1e-6), range(0, 121)),  # configs/smoke.yaml
    ((5, 100, 1e-3, 1e-6), range(0, 121)),   # SCHED
], ids=["reference", "smoke", "fast"])
def test_scheduler_bit_identical_to_jax(cfg, steps):
    for s in steps:
        want = np.asarray(j_lr(s, JSched(*cfg)))
        got = np.float32(warmup_cosine_lr(s, WarmupCosineConfig(*cfg)))
        assert got.tobytes() == want.tobytes(), (s, got, want)


def test_hybrid_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.standard_normal((2, 257, 63, 2)).astype(np.float32)
    true = rng.standard_normal((2, 257, 63, 2)).astype(np.float32)
    want, want_g = jax.value_and_grad(j_hybrid_loss)(jnp.asarray(pred), jnp.asarray(true))
    p = torch.from_numpy(pred).requires_grad_()
    got = hybrid_loss(p, torch.from_numpy(true))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    g, wg = p.grad.numpy(), np.asarray(want_g)
    assert np.abs(g - wg).max() <= 1e-4 * np.abs(wg).max()


def test_si_snr_db_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 8000)).astype(np.float32)
    est = x + rng.standard_normal((3, 8000)).astype(np.float32) * np.array([[0.1], [0.5], [2.0]],
                                                                         np.float32)
    want = np.asarray(j_si_snr_db(jnp.asarray(x), jnp.asarray(est)))
    got = si_snr_db(torch.from_numpy(x), torch.from_numpy(est)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- the training step ---------------------------------------------------------


def test_train_steps_match_jax(jax_run):
    """Three f32 steps on one batch: the loss of each, the lr-0 first update,
    the folded BatchNorm statistics, the frozen ERB filters, the params."""
    start, traj, _ = jax_run
    model, _, step = _port(start)
    noisy, clean = _batch()
    for i, (want_params, _, want_loss) in enumerate(traj):
        loss = step(noisy, clean)
        assert loss.dtype == torch.float32 and loss.dim() == 0
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
        if i < 2:  # the BatchNorm fold, before the rounding-noise biases move
            _check_bn(model, want_params)
        if i == 0:  # update 0 uses lr(0) = 0: only the running statistics move
            for k, v in _port_flat(model).items():
                if "running" not in k:
                    np.testing.assert_array_equal(v, _np(start)[k], err_msg=k)
    _check_params(model, traj[2][0])


def test_opt_state_from_jax_continues(jax_run):
    """The JAX state after two steps, carried into the port, takes the third
    step as JAX does (the BatchNorm fold at 1e-5 from the same params)."""
    _, traj, _ = jax_run
    params2, opt_state2, _ = traj[1]
    model, opt, step = _port(params2)
    opt.load_state_dict(opt_state_from_jax(opt_state2))
    assert opt.count == 2
    loss = step(*_batch())
    assert opt.count == 3
    np.testing.assert_allclose(float(loss), traj[2][2], rtol=1e-5)
    _check_bn(model, traj[2][0])
    _check_params(model, traj[2][0])


def test_trainable_set_matches_jax_labels():
    """The optimizer's leaves (the model's parameters) are JAX's "train"
    leaves, the buffers its "freeze" leaves."""
    start = JModel().init(jax.random.PRNGKey(0))
    want = flatten(jt.param_labels(start))
    model = GTCRNMicro.from_params(jax.tree.map(np.asarray, start), device="cpu")
    got = {n: "train" for n in make_optimizer(model, device="cpu").names}
    got.update({n: "freeze" for n, _ in model.named_buffers()})
    assert got == want
    n_train = sum(p.numel() for p in model.parameters())
    assert n_train == sum(np.asarray(v).size for v, lab in zip(
        jax.tree.leaves(start), jax.tree.leaves(jt.param_labels(start))) if lab == "train")
    assert n_train == 19014
    assert {k for k, v in got.items() if v == "freeze"} == {
        k for k in got if "erb" in k or "running_mean" in k or "running_var" in k}


@pytest.mark.parametrize("norm", [5.0, 1.5], ids=["above", "below"])
def test_clip_matches_optax(norm):
    model = GTCRNMicro.from_params(init_params(device="cpu"), device="cpu")
    rng = np.random.default_rng(3)
    tree = {n: np.asarray(rng.standard_normal(p.shape), np.float32)
            for n, p in model.named_parameters()}
    scale = norm / np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in tree.values()))
    tree = {n: np.asarray(v * scale, np.float32) for n, v in tree.items()}
    want, _ = optax.clip_by_global_norm(3.0).update({k: jnp.asarray(v) for k, v in tree.items()},
                                                    None)
    got = clip_by_global_norm([torch.from_numpy(v) for v in tree.values()], 3.0)
    for k, g in zip(tree, got):
        w = want[k]
        if norm < 3:  # left alone, bit for bit
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
        else:  # the norm's summation order differs: float32 rounding
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0, err_msg=k)
    if norm > 3:
        total = np.sqrt(sum(float(np.sum(g.double().numpy() ** 2)) for g in got))
        assert abs(total - 3.0) < 1e-5


def test_freeze_bn_keeps_running_stats_and_trains_gamma_beta(jax_run):
    start, _, _ = jax_run
    model = GTCRNMicro.from_params(start, device="cpu")
    opt = make_optimizer(model, WarmupCosineConfig(**SCHED), device="cpu")
    step = make_train_step(model, opt, freeze_bn=True, device="cpu")
    for _ in range(2):  # the second update has lr(1) > 0
        step(*_batch(seed=1))
    got, want = _port_flat(model), _np(start)
    for k in got:
        if "running" in k:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("encoder.en0.bn.gamma", "encoder.en0.bn.beta", "gtcn1.block0.bn2.gamma"):
        assert np.abs(got[k] - want[k]).max() > 0, k


def test_bf16_step(jax_run):
    """compute_dtype=bf16: step 1's loss within 5 % of the JAX f32 loss (the
    bound of tests/train/test_trainer.py:119), every master stays float32,
    weights and running statistics move."""
    start, traj, _ = jax_run
    model = GTCRNMicro.from_params(start, device="cpu")
    opt = make_optimizer(model, WarmupCosineConfig(**SCHED), device="cpu")
    step = make_train_step(model, opt, compute_dtype=torch.bfloat16, device="cpu")
    losses = [step(*_batch()) for _ in range(3)]
    assert all(x.dtype == torch.float32 and torch.isfinite(x) for x in losses)
    np.testing.assert_allclose(float(losses[0]), traj[0][2], rtol=0.05)
    assert all(t.dtype == torch.float32 for t in model.state_dict().values())
    assert all(m.dtype == torch.float32 for m in opt.mu + opt.nu)
    got, want = _port_flat(model), _np(start)
    for k in ("encoder.en0.conv.w", "encoder.en0.bn.running_mean"):
        assert np.abs(got[k] - want[k]).max() > 0, k


@pytest.mark.parametrize("which", ["train", "eval"])
def test_int16_batch_bit_identical_to_float(jax_run, which):
    """The int16 transfer path dequantizes on the device, bit for bit
    (tests/train/test_int16_transfer.py:71)."""
    start, _, _ = jax_run
    rng = np.random.default_rng(4)
    ni = (rng.standard_normal((2, 4096)) * 3000).astype(np.int16)
    ci = (rng.standard_normal((2, 4096)) * 3000).astype(np.int16)
    nf, cf = ni.astype(np.float32) / 32768.0, ci.astype(np.float32) / 32768.0
    outs = []
    for noisy, clean in ((ni, ci), (nf, cf)):
        model, _, step = _port(start)
        if which == "train":
            step(noisy, clean)  # lr 0: only the BN fold moves params
            outs.append((step(noisy, clean), _port_flat(model)))
        else:
            loss, spec = make_eval_step(model, device="cpu")(noisy, clean)
            outs.append((loss, {"spec": spec.numpy()}))
    (li, ti), (lf, tf) = outs
    assert float(li) == float(lf)
    for k in ti:
        np.testing.assert_array_equal(ti[k], tf[k], err_msg=k)


def test_eval_step_matches_jax(jax_run):
    """tests/train/test_trainer.py::test_eval_step's shape and batch."""
    start, _, params = jax_run
    noisy, clean = _batch(batch=2, seed=3)
    want_loss, want_spec = jax.jit(jt.make_eval_step(JModel()))(params, noisy, clean)
    model = GTCRNMicro.from_params(jax.tree.map(np.asarray, params), device="cpu")
    loss, spec = make_eval_step(model, device="cpu")(noisy, clean)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(spec.numpy(), np.asarray(want_spec), atol=1e-5)


def test_apply_bn_stats_unknown_path_raises():
    model = GTCRNMicro.from_params(init_params(device="cpu"), device="cpu")
    with pytest.raises(KeyError):
        apply_bn_stats(model, {"nonexistent/bn/batch_mean": torch.zeros(16)})


# -- data ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six noisy/clean pairs of 10,000 samples (some shorter): a DNS3 fileid
    layout and a VCTK basename layout."""
    from gtcrn_micro_tpu_torch.io.wav import write_wav

    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(5)
    for layout in ("dns", "vctk"):
        for d in ("noisy", "clean"):
            (root / layout / d).mkdir(parents=True)
        for i in range(6):
            n = 10000 if i % 3 else 700
            x = (rng.standard_normal(n) * 0.1).astype(np.float32)
            y = x + (rng.standard_normal(n) * 0.05).astype(np.float32)
            if layout == "dns":
                names = (f"clean_fileid_{i}.wav", f"noisy_snr5_fileid_{i}.wav")
            else:
                names = (f"p232_{i:03d}.wav",) * 2
            write_wav(str(root / layout / "clean" / names[0]), x, 16000)
            write_wav(str(root / layout / "noisy" / names[1]), y, 16000)
    return root


@pytest.mark.parametrize("layout, kw", [
    ("dns", dict(num_data_per_epoch=4)),
    ("dns", dict(num_data_per_epoch=5, random_start=True, transfer_dtype="int16")),
    ("vctk", dict(pairing="basename", train=False)),
], ids=["fileid-subsample", "random-start-int16", "basename"])
def test_dataloader_yields_jax_batches(corpus, layout, kw):
    """Two epochs of both loaders: the same batches, dtype and all (fs 1000
    makes 0.5 s crops of 500 samples and random starts of whole seconds)."""
    args = dict(noisy_root=str(corpus / layout / "noisy"), clean_root=str(corpus / layout / "clean"),
                fs=1000, length_seconds=0.5, seed=7, **kw)
    ds = [mod.PairedWavDataset(**args) for mod in (jdl, tdl)]
    loaders = [mod.PrefetchLoader(d, batch_size=2, num_workers=2, seed=3)
               for mod, d in zip((jdl, tdl), ds)]
    assert len(loaders[0]) == len(loaders[1]) > 0
    for _ in range(2):
        for d in ds:
            d.sample_data_per_epoch()
        assert ds[0].epoch_pairs == ds[1].epoch_pairs
        batches = [list(ld) for ld in loaders]
        assert len(batches[0]) == len(batches[1]) == len(loaders[0])
        for (jn, jc), (tn, tc) in zip(*batches):
            for j, t in ((jn, tn), (jc, tc)):
                assert j.dtype == t.dtype and j.shape == t.shape == (2, 500)
                np.testing.assert_array_equal(t, j)


def test_make_smoke_data_byte_identical(tmp_path):
    for mk, d in ((j_make_smoke_data, "jax"), (make_smoke_data, "port")):
        mk(str(tmp_path / d), n_train=3, n_val=2, seconds=0.5, seed=11)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.wav"))
    assert len(files) == 10
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


# -- checkpoints -------------------------------------------------------------


def test_checkpoint_round_trip_and_max_to_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None
    states = {s: {"params": {"a": {"w": torch.full((3,), float(s))}},
                  "opt_state": {"count": s, "mu": {"a": {"w": torch.zeros(3)}}},
                  "epoch": s, "step": s} for s in (1, 2, 3, 4)}
    for s, st in states.items():
        mgr.save(s, st)
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "4"]
    assert os.listdir(tmp_path / "ck" / "4") == ["state.pt"]  # no temporary file left
    for step in (None, 3):
        got = mgr.restore(step)
        want = states[step or 4]
        assert got["epoch"] == want["epoch"] and got["opt_state"]["count"] == want["step"]
        assert torch.equal(got["params"]["a"]["w"], want["params"]["a"]["w"])
    mgr.close()


def test_best_tracker_persists_across_resume(tmp_path):
    d = str(tmp_path / "ck")
    state = lambda s: {"params": {"w": torch.tensor([float(s)])}, "step": s}  # noqa: E731
    assert BestTracker(d).update(1, 2.0, state(1))
    resumed = BestTracker(d)
    assert (resumed.best_score, resumed.best_step) == (2.0, 1)
    assert not resumed.update(2, 1.5, state(2))  # worse: the best snapshot stays
    assert CheckpointManager(os.path.join(d, "best")).restore()["step"] == 1
    assert resumed.update(3, 3.0, state(3))
    assert CheckpointManager(os.path.join(d, "best")).steps() == [3]
    assert json.load(open(os.path.join(d, "best_score.json"))) == {"best_score": 3.0,
                                                                  "best_step": 3}


# -- train.run -------------------------------------------------------------------


def _run_cfg(root, exp, epochs=1, resume=False):
    """tests/train/test_train_run.py's config: one step of batch 8 per epoch."""
    return {
        "network": "gtcrn_micro",
        "network_config": {"n_fft": 512, "hop_len": 256, "win_len": 512},
        "seed": 43,
        "scheduler": {"kwargs": {"warmup_steps": 4, "decay_until_step": 40,
                                 "max_lr": 1e-3, "min_lr": 1e-6}},
        "loss": {"compress_factor": 0.3, "lamda_ri": 30, "lamda_mag": 70},
        "train_dataset": {"noisy_root": os.path.join(root, "train", "noisy"), "fs": 16000,
                          "length_seconds": 1.0, "num_data_per_epoch": 8, "train": True},
        "train_dataloader": {"batch_size": 8, "num_workers": 1},
        "valid_dataset": {"noisy_root": os.path.join(root, "val", "noisy"), "fs": 16000,
                          "length_seconds": 1.0, "train": False},
        "valid_dataloader": {"batch_size": 1, "num_workers": 1},
        "trainer": {"epochs": epochs, "save_checkpoint_interval": 1, "clip_grad_norm": 3.0,
                    "exp_path": exp, "resume": resume, "log_every": 1},
    }


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("smoke"))
    make_smoke_data(root, n_train=8, n_val=2, seconds=1.0)
    return root


def _metrics(exp):
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_run_val_loss_independent_of_scorer_failures(smoke_root, tmp_path, monkeypatch):
    """tests/train/test_train_run.py:46: val_loss is a mean over batches
    whatever the scorer does, and the score aggregates NaN-aware."""
    monkeypatch.setattr(train_mod, "quality_score", lambda c, e, fs: 1.0)
    ok = _metrics(train_mod.run(_run_cfg(smoke_root, str(tmp_path / "ok")), device="cpu"))
    monkeypatch.setattr(train_mod, "quality_score", lambda c, e, fs: float("nan"))
    bad = _metrics(train_mod.run(_run_cfg(smoke_root, str(tmp_path / "bad")), device="cpu"))
    ok, bad = ([m for m in ms if "val_loss" in m] for ms in (ok, bad))
    assert len(ok) == len(bad) == 1
    np.testing.assert_allclose(bad[0]["val_loss"], ok[0]["val_loss"], rtol=1e-6)
    assert ok[0]["val_score"] == 1.0 and bad[0]["val_score"] == 0.0
    assert np.isfinite(bad[0]["val_loss"])


def test_run_resume_counts_epochs_in_total(smoke_root, tmp_path, monkeypatch):
    """Two epochs, then ``resume: true`` with 3 epochs in all: one more
    epoch from the saved step, in the newest dated run; the config kept as
    ``config.yaml`` where PyYAML does not import, loading back equal."""
    monkeypatch.setattr(train_mod, "quality_score", lambda c, e, fs: 1.0)
    prefix = str(tmp_path / "exp")
    with pytest.raises(FileNotFoundError):
        train_mod.run(_run_cfg(smoke_root, prefix, resume=True), device="cpu")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "yaml", None)  # import yaml raises ImportError
        exp = train_mod.run(_run_cfg(smoke_root, prefix, epochs=2), device="cpu")
        archived = load_config(os.path.join(exp, "config.yaml")).to_dict()
    assert not os.path.exists(os.path.join(exp, "config.json"))
    want = _run_cfg(smoke_root, prefix, epochs=2)
    assert archived == want and archived["trainer"]["epochs"] == 2
    assert train_mod.run(_run_cfg(smoke_root, prefix, epochs=3, resume=True), device="cpu") == exp
    assert os.path.exists(os.path.join(exp, "config.yaml"))
    val = [m for m in _metrics(exp) if "val_loss" in m]
    assert [(m["epoch"], m["step"]) for m in val] == [(1, 1), (2, 2), (3, 3)]
    assert all(np.isfinite(m["val_loss"]) for m in val)
    ckpt = CheckpointManager(os.path.join(exp, "checkpoints"))
    assert ckpt.steps() == [1, 2, 3]
    state = ckpt.restore()
    assert (state["epoch"], state["step"], state["opt_state"]["count"]) == (3, 3, 3)
    assert os.path.exists(os.path.join(exp, "checkpoints", "best_score.json"))
