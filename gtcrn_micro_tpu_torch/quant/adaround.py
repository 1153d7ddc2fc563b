"""AdaRound: learned per-weight rounding for the full-int8 deployment path
(the JAX package's ``quant/adaround.py``).

Nearest rounding is not the best projection of a 19k-parameter model onto
the int8 grid.  AdaRound (Nagel et al., 2020, "Up or Down? Adaptive Rounding
for Post-Training Quantization") learns the round-up/round-down decision of
every weight.  As in the JAX package, ALL rounding variables are optimised
jointly against the end-to-end distillation objective (the int8 path's
output against the float32 model's), not against layer-local proxies.

Pieces:

- a rounding variable V per quantized weight element; soft rounding
  ``h(V) = clip(sigmoid(V) (zeta - gamma) + gamma, 0, 1)``, initialised so
  that ``floor(w / s) + h(V) == w / s`` (zero initial rounding error);
- the quantized weight ``w_q = s clip(floor(w / s) + h(V), qmin, qmax)`` with
  each channel's abs-max elements PINNED to nearest rounding, so that the
  baked weights give the same per-channel scale, bit for bit, when the
  exporters and the native engine observe them again (the pin takes amax
  from the weight, where JAX's takes ``127 s``: see ``_pin_mask``);
- the regulariser ``sum(1 - |2h - 1|^beta)``, beta annealed from high to low,
  which pushes every h to a hard 0 or 1;
- learned activation scales (LSQ) and float corrections: the conv and
  pointwise biases, the TRA biases and the BatchNorm betas train alongside V.

The JAX hooks' paths (``encoder/en2/pw1/w``) key the rounding variables and
the activation deltas, and the params tree's ``/``-joined paths key the
float terms, so both packages' dicts compare key by key.  The model is run
functionally (``torch.func.functional_call``) over a flat dict of those
tensors; the model's own params are never modified.

``clip`` here is ``jnp.clip``'s: a maximum then a minimum, whose gradient at
a value on the bound is one half (``torch.clamp`` passes all of it).

CLI (the JAX package's distillation protocol: noisy wavs 1-3 augmented for
training, wav 4 for early stopping, wav 5 held out)::

    python -m gtcrn_micro_tpu_torch.quant.adaround --checkpoint <ckpt> \
        --wav_dir <dir with noisy1..5.wav and enh1..5.wav> --steps 2500 \
        --out_dir <dir> [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.dsp.stft import istft, sqrt_hann_window, stft
from gtcrn_micro_tpu_torch.models.gtcrn_micro import nest
from gtcrn_micro_tpu_torch.nn.core import Ctx, exact_f32
from gtcrn_micro_tpu_torch.quant.fake_quant import QParams, _f32, fake_quant, weight_qparams
from gtcrn_micro_tpu_torch.train.trainer import _to_device, adam_update_

ZETA, GAMMA = 1.1, -0.1  # rectified-sigmoid stretch (AdaRound defaults)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``, gradient included (half at a tie)."""
    lo = torch.tensor(lo, dtype=x.dtype)  # 0-d CPU scalars: no copy to the card
    hi = torch.tensor(hi, dtype=x.dtype)
    return torch.minimum(torch.maximum(x, lo), hi)


def _h(v: torch.Tensor) -> torch.Tensor:
    """Rectified sigmoid: smooth in (0, 1), saturates at the corners."""
    return _clip(torch.sigmoid(v) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def _h_init(remainder: torch.Tensor) -> torch.Tensor:
    """V such that h(V) == remainder (training starts at w_q == w)."""
    p = torch.clamp((remainder - GAMMA) / _f32(ZETA - GAMMA, remainder), 1e-4, 1 - 1e-4)
    return torch.log(p / (1 - p))


def _pin_mask(w: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """True at each channel's abs-max element(s): these stay nearest-rounded
    so that amax, hence the per-channel scale, is invariant.

    amax comes from the weight itself, as the JAX package's GPTQ takes it
    (gptq.py:210-215).  JAX's AdaRound takes ``scale * 127`` (adaround.py:
    68-72), which the float32 scale can put an ulp above the true amax: the
    max element then goes unpinned, and rounding it down moves the channel's
    scale by 1/127 and its baked weights off their grid (ROADMAP C)."""
    a = w.detach().abs()
    axes = tuple(i for i in range(w.dim()) if i != channel_axis)
    return a >= a.amax(dim=axes, keepdim=True) - 1e-12


def soft_quant_weight(w, v, channel_axis: int, hard: bool = False, ste: bool = False):
    """AdaRounded weight (dequantized float): ``s clip(floor(w/s) + h, n, p)``.

    ``ste=True`` makes the floor and the round straight-through, so that
    gradients also reach ``w`` (the QAT x AdaRound hybrid); the clip still
    blocks them outside the representable range."""
    qp = weight_qparams(w, channel_axis)
    r = w / qp.scale
    base, rounded = torch.floor(r), torch.round(r)
    if ste:
        base = r + (base - r).detach()
        rounded = r + (rounded - r).detach()
    frac = (_h(v) >= 0.5).to(w.dtype) if hard else _h(v)
    q = torch.where(_pin_mask(w, channel_axis), rounded, base + frac)
    return _clip(q, qp.qmin, qp.qmax) * qp.scale


def fake_quant_lsq(x, qp: QParams, log_s_delta):
    """Activation fake-quant with a LEARNABLE scale (LSQ, Esser et al. 2020).

    ``scale = qp.scale * exp(log_s_delta)``; the round is straight-through,
    so gradients reach ``x`` and the scale.  The zero point stays the frozen
    calibrated integer: real 0 maps to it exactly for any scale, which keeps
    zero padding exact and the GTM8 contract (float scale, int zero)."""
    s = qp.scale * torch.exp(log_s_delta)
    r = x / s
    q = r + (torch.round(r) - r).detach() + qp.zero
    q = _clip(q, qp.qmin, qp.qmax)
    return (q - qp.zero) * s


class AdaRoundQuantizer:
    """``ctx.quant`` hook: learned-scale activation fake-quant and AdaRounded
    weights.

    ``rvars`` maps a weight path to its rounding variables (the weight's
    shape), ``avars`` an activation path to its log-scale deltas (0 is the
    calibrated scale).  With ``rvars`` None the hook collects: it registers
    zero-error rounding variables and zero deltas and fake-quantizes as
    ``FakeQuantizer`` does.  ``act_qp`` must be on the data's device."""

    def __init__(self, act_qp: dict[str, QParams], rvars: dict | None = None,
                 avars: dict | None = None, hard: bool = False, ste: bool = False):
        self.act_qp = act_qp
        self.rvars = rvars if rvars is not None else {}
        self.avars = avars if avars is not None else {}
        self.collecting = rvars is None
        self.hard = hard
        self.ste = ste
        self.axes: dict[str, int] = {}

    def act(self, path: str, x):
        qp = self.act_qp.get(path)
        if qp is None:
            raise KeyError(f"no activation qparams for {path}")
        if self.collecting:
            # one delta per scale entry (per-tensor or per-lane), in the
            # data's float type
            self.avars.setdefault(path, torch.zeros(qp.scale.shape, dtype=x.dtype,
                                                    device=qp.scale.device))
            return fake_quant(x, qp)
        delta = self.avars.get(path)
        return fake_quant(x, qp) if delta is None else fake_quant_lsq(x, qp, delta)

    def weight(self, path: str, w, channel_axis: int):
        self.axes[path] = channel_axis
        if self.collecting:
            qp = weight_qparams(w, channel_axis)
            r = w.detach() / qp.scale
            self.rvars[path] = _h_init(r - torch.floor(r))
            return fake_quant(w, qp)
        return soft_quant_weight(w, self.rvars[path], channel_axis, self.hard, self.ste)


def apply_avars(act_qp: dict[str, QParams], avars: dict) -> dict[str, QParams]:
    """Bake learned scale deltas into a new frozen ``act_qp`` dict."""
    out = {}
    for path, qp in act_qp.items():
        d = avars.get(path)
        out[path] = qp if d is None else dataclasses.replace(
            qp, scale=qp.scale * torch.exp(d.detach()))
    return out


def _flat_params(model) -> dict[str, torch.Tensor]:
    """The model's tensors (params and buffers) keyed by their ``/``-joined
    JAX tree paths (``encoder/en2/point_conv1/w``)."""
    return {k.replace(".", "/"): v for k, v in model.state_dict().items()}


def _nest(flat: dict) -> dict:
    """``/``-keyed tensors -> the nested params dict (detached copies)."""
    return nest({k.replace("/", "."): v.detach().clone() for k, v in flat.items()})


def _forward(model, flat: dict, spec, quant):
    """The model's offline forward over the tensors of ``flat`` (every
    param and buffer, ``/``-keyed) with ``quant`` as the hook; autograd
    follows the caller's grad mode."""
    named = {k.replace("/", "."): v for k, v in flat.items()}
    with exact_f32():
        return torch.func.functional_call(model, named, (spec, Ctx(quant=quant)))


def _probe_spec(model) -> torch.Tensor:
    return torch.zeros((1, model.config.n_freqs, 2, 2), dtype=model.dtype, device=model.device)


def init_rvars(model, act_qp: dict) -> tuple[dict, dict, dict]:
    """(rvars, avars, axes): zero-error rounding variables for every
    quantized weight of ``model`` (a ``GTCRNMicro`` holding the float
    params) and zero log-scale deltas for every activation boundary, in
    hook order.  ``act_qp`` must be on the model's device."""
    q = AdaRoundQuantizer(act_qp, rvars=None)
    with torch.no_grad():
        model.apply(_probe_spec(model), quant=q)
    return q.rvars, q.avars, q.axes


# Float terms co-trained with the rounding variables.  On the BN-folded
# graph (the deployment flow: GTM8 export folds BN, then quantizes) gamma
# must stay frozen: the export folds BN again, and a trained gamma would
# rescale the weights off their optimised grid.  beta and the conv/TRA
# biases fold into the engines' float/int32 bias terms, scale-free.
TRAINABLE_FLOAT_LEAVES = ("b", "depth_b", "point_b", "beta")


def _float_trainable(path_str: str) -> bool:
    return path_str.rsplit("/", 1)[-1] in TRAINABLE_FLOAT_LEAVES


def _as_batch(x, model) -> torch.Tensor:
    """A host batch on the model's device, in its dtype, without waiting."""
    return _to_device(x if torch.is_tensor(x) else np.array(x), model.device).to(model.dtype)


GROUPS = ("v", "a", "f", "w")  # rounding vars, scale deltas, float terms, weights


class AdaRound:
    """The joint optimisation of one model: rounding variables (group
    ``v``), activation log-scale deltas (``a``), float correction terms
    (``f``) and, with ``lr_w > 0``, the quantized weights themselves (``w``),
    each group with its own ``optax.adam`` (its own step count and moments),
    as JAX's ``optax.multi_transform``.  ``vars[group]`` maps a path to its
    tensor (leaf tensors, updated in place).

    ``model``: a ``GTCRNMicro`` holding the BN-folded float params, on the
    device the optimisation runs on; ``act_qp`` moves there."""

    def __init__(self, model, act_qp: dict, lr_v: float = 2e-2, lr_a: float = 3e-3,
                 lr_f: float = 1e-4, lr_w: float = 0.0, w_anchor: float = 0.0,
                 reg_weight: float = 1e-4):
        self.model = model
        dev = model.device
        self.act_qp = {p: qp.to(dev) for p, qp in act_qp.items()}
        rvars, avars, self.axes = init_rvars(model, self.act_qp)
        self.flat = _flat_params(model)
        self.train_w = lr_w > 0.0
        fvars = {k: v.clone() for k, v in self.flat.items() if _float_trainable(k)}
        wvars, self.w0, self.w_size = {}, {}, 1
        if self.train_w:
            tpaths = quantized_weight_tree_paths(model, rvars).values()
            wvars = {tp: self.flat[tp].clone() for tp in tpaths}
            self.w0 = {tp: self.flat[tp] for tp in tpaths}
            self.w_size = sum(v.numel() for v in wvars.values())
        self.vars = {"v": rvars, "a": avars, "f": fvars, "w": wvars}
        for group in self.vars.values():
            for v in group.values():
                v.requires_grad_(True)
        self.lr = {"v": lr_v, "a": lr_a, "f": lr_f, "w": lr_w if self.train_w else 0.0}
        self.w_anchor, self.reg_weight = w_anchor, reg_weight
        self.count = dict.fromkeys(GROUPS, 0)
        self.mu = {g: [torch.zeros_like(v) for v in self.vars[g].values()] for g in GROUPS}
        self.nu = {g: [torch.zeros_like(v) for v in self.vars[g].values()] for g in GROUPS}
        self.window = sqrt_hann_window(model.config.win_len, dtype=model.dtype, device=dev)
        self.n_rvars = sum(v.numel() for v in rvars.values())

    def _params(self) -> dict:
        return {**self.flat, **self.vars["f"], **self.vars["w"]}

    def loss(self, spec, target, beta):
        """(loss, mse, reg) of the soft-rounded model on spec (B, F, T, 2)
        against the target audio; ``beta`` a 0-d tensor on the device."""
        rv, av, wv = self.vars["v"], self.vars["a"], self.vars["w"]
        quant = AdaRoundQuantizer(self.act_qp, rvars=rv, avars=av, ste=self.train_w)
        out = _forward(self.model, self._params(), spec, quant)
        with exact_f32():
            wav = istft(out, self.window, length=target.shape[-1])
        mse = (wav - target).square().mean()
        reg = sum((1.0 - (2.0 * _h(v) - 1.0).abs() ** beta).sum() for v in rv.values())
        reg = reg / self.n_rvars
        loss = mse + self.reg_weight * reg
        if self.train_w and self.w_anchor > 0.0:
            loss = loss + self.w_anchor * sum(
                (wv[k] - self.w0[k]).square().sum() for k in wv) / self.w_size
        return loss, mse, reg

    def gradients(self, noisy, target, beta: float):
        """One batch of audio (B, samples), numpy or tensors: ``(loss, mse,
        reg, grads)`` with ``grads[group][path]``; no update."""
        dev = self.model.device
        with torch.enable_grad():
            with exact_f32():
                spec = stft(_as_batch(noisy, self.model), self.window)
            beta_t = torch.full((), beta, dtype=torch.float32, device=dev)
            loss, mse, reg = self.loss(spec, _as_batch(target, self.model), beta_t)
            leaves = [v for g in GROUPS for v in self.vars[g].values()]
            with exact_f32():  # the backward's convolutions too
                gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = iter(torch.zeros_like(v) if g is None else g for v, g in zip(leaves, gs))
        grads = {g: {k: next(gs) for k in self.vars[g]} for g in GROUPS}
        return loss.detach(), mse.detach(), reg.detach(), grads

    def step(self, noisy, target, beta: float):
        """One Adam update of every group from one batch.  Returns (mse,
        reg) as 0-d tensors on the device (no wait for the device)."""
        _loss, mse, reg, grads = self.gradients(noisy, target, beta)
        for g in GROUPS:
            if self.vars[g]:
                self.count[g] = adam_update_(list(self.vars[g].values()), list(grads[g].values()),
                                             self.mu[g], self.nu[g], self.count[g], self.lr[g])
        return mse, reg

    @torch.no_grad()
    def val_snr(self, spec, target) -> float:
        """SNR (dB) of the HARD-rounded model (the thing that ships) on a
        val spec against its target audio."""
        quant = AdaRoundQuantizer(apply_avars(self.act_qp, self.vars["a"]),
                                  rvars=self.vars["v"], hard=True)
        out = _forward(self.model, self._params(), spec, quant)
        with exact_f32():
            wav = istft(out, self.window, length=target.shape[-1])
        err = (wav - target).square().sum()
        return float(10.0 * torch.log10(target.square().sum() / torch.clamp_min(err, 1e-20)))

    def snapshot(self) -> dict:
        """Copies of every variable (the in-place updates leave them be)."""
        return {g: {k: v.detach().clone() for k, v in vs.items()} for g, vs in self.vars.items()}

    @torch.no_grad()
    def load(self, snapshot: dict) -> None:
        """Set every variable from a :meth:`snapshot`'s form (tensors on any
        device or of any dtype, or numpy arrays)."""
        for g, vs in self.vars.items():
            for k, v in vs.items():
                x = snapshot[g][k]
                v.copy_(x if torch.is_tensor(x) else torch.from_numpy(np.array(x)))

    def bake(self) -> tuple[dict, dict]:
        """(baked params, baked act_qp): every quantized weight hard-rounded
        to its dequantized grid value, the float terms merged in, the
        learned activation scales frozen."""
        baked = _bake_params(self.model, self.vars["v"], self._params())
        return baked, apply_avars(self.act_qp, self.vars["a"])


def adaround_optimize(model, noisy: np.ndarray, target: np.ndarray, act_qp: dict,
                      steps: int = 1500, batch_size: int = 8, lr_v: float = 2e-2,
                      lr_a: float = 3e-3, lr_f: float = 1e-4, lr_w: float = 0.0,
                      w_anchor: float = 0.0, reg_weight: float = 1e-4, beta_hi: float = 20.0,
                      beta_lo: float = 2.0, seed: int = 0, log_every: int = 100,
                      val_noisy: np.ndarray | None = None, val_target: np.ndarray | None = None,
                      eval_every: int = 250, patience: int = 4, history: list | None = None):
    """Jointly optimise weight rounding, activation scales and float
    corrections of ``model`` (the BN-folded float ``GTCRNMicro``, on its
    device) against the distillation objective: audio (N, samples) in,
    the float32 model's audio out.

    ``lr_w > 0`` also trains the quantized weights through the soft
    quantizer with straight-through floors; ``w_anchor`` L2-anchors them to
    the checkpoint's values.  ``val_noisy``/``val_target`` enable early
    stopping: every ``eval_every`` steps the HARD-rounded model is scored on
    the val split, the best variables are kept (copied: the updates are in
    place) and the loop stops after ``patience`` evals without improvement;
    ``history`` (a list) receives ``(step, val SNR)`` of each eval.  Batches
    and betas are JAX's: ``np.random.default_rng(seed).choice`` and Python
    floats.

    Returns (baked_params, baked_act_qp), on the model's device."""
    run = AdaRound(model, act_qp, lr_v=lr_v, lr_a=lr_a, lr_f=lr_f, lr_w=lr_w, w_anchor=w_anchor,
                   reg_weight=reg_weight)
    use_val = val_noisy is not None
    if use_val:
        with torch.no_grad(), exact_f32():
            val_spec = stft(_as_batch(val_noisy, model), run.window)
        val_tgt = _as_batch(val_target, model)
    rng = np.random.default_rng(seed)
    best, best_snr, since_best = run.snapshot(), -np.inf, 0
    warm = max(steps // 5, 1)  # the beta anneal starts after a free-move phase
    for i in range(steps):
        idx = rng.choice(len(noisy), size=batch_size, replace=True)
        frac = max(0.0, min(1.0, (i - warm) / max(steps - warm, 1)))
        beta = beta_hi + (beta_lo - beta_hi) * frac
        mse, reg = run.step(noisy[idx], target[idx], beta)
        if log_every and (i + 1) % log_every == 0:
            print(f"  adaround {i + 1}/{steps}  mse {float(mse):.3e}  "
                  f"soft-frac {float(reg):.3f}  beta {beta:.1f}", flush=True)
        if use_val and ((i + 1) % eval_every == 0 or i + 1 == steps):
            snr = run.val_snr(val_spec, val_tgt)
            if history is not None:
                history.append((i + 1, snr))
            mark = ""
            if snr > best_snr:
                best, best_snr, since_best = run.snapshot(), snr, 0
                mark = "  <- best"
            else:
                since_best += 1
            print(f"  adaround {i + 1}/{steps}  val SNR (hard) {snr:.2f} dB{mark}", flush=True)
            if since_best >= patience:
                print(f"  early stop: no val improvement in {patience} evals "
                      f"(best {best_snr:.2f} dB)", flush=True)
                break
    if use_val:
        run.load(best)
    return run.bake()


def bias_refine(model, noisy: np.ndarray, target: np.ndarray, act_qp: dict, steps: int = 400,
                batch_size: int = 8, lr: float = 2e-4, seed: int = 1,
                log_every: int = 100) -> dict:
    """Post-bake bias correction: ``model`` holds the baked params, whose
    int8 weights stay FROZEN on their grid (fake-quant of a baked weight is
    the identity); only the float deployment terms (biases, BN beta) train,
    through the standard fake-quant graph.  Returns the refined params."""
    from gtcrn_micro_tpu_torch.quant.ptq import FakeQuantizer

    dev = model.device
    quant = FakeQuantizer({p: qp.to(dev) for p, qp in act_qp.items()})
    window = sqrt_hann_window(model.config.win_len, dtype=model.dtype, device=dev)
    flat = _flat_params(model)
    fvars = {k: v.clone().requires_grad_(True) for k, v in flat.items() if _float_trainable(k)}
    leaves = list(fvars.values())
    mu, nu, count = [torch.zeros_like(v) for v in leaves], [torch.zeros_like(v) for v in leaves], 0
    rng = np.random.default_rng(seed)
    for i in range(steps):
        idx = rng.choice(len(noisy), size=batch_size, replace=True)
        tgt = _as_batch(target[idx], model)
        with torch.enable_grad(), exact_f32():
            spec = stft(_as_batch(noisy[idx], model), window)
            out = _forward(model, {**flat, **fvars}, spec, quant)
            loss = (istft(out, window, length=tgt.shape[-1]) - tgt).square().mean()
            grads = torch.autograd.grad(loss, leaves)
        count = adam_update_(leaves, list(grads), mu, nu, count, lr)
        if log_every and (i + 1) % log_every == 0:
            print(f"  bias-refine {i + 1}/{steps}  mse {float(loss):.3e}", flush=True)
    return _nest({**flat, **fvars})


class _BakeHook:
    """``ctx.quant`` hook that records the HARD AdaRounded value of every
    quantized weight and passes activations through."""

    def __init__(self, rvars):
        self.rvars = rvars
        self.baked: dict[str, torch.Tensor] = {}

    def act(self, path, x):
        return x

    def weight(self, path, w, channel_axis):
        wq = soft_quant_weight(w, self.rvars[path], channel_axis, hard=True)
        self.baked[path] = wq
        return wq


def _trace_bake(model, rvars, flat: dict | None = None):
    """Run the graph once with a recording hook over ``flat`` (the model's
    own tensors by default); return the scope -> tree path mapping, the
    hard-baked values by scope path, and the flat tree.

    A weight's hook path (``encoder/en2/pw1/w``) is not always its tree
    path (``encoder/en2/point_conv1/w``): the mapping matches them by
    shared prefix, layer-name alias and shape, asserted unique, as JAX's."""
    flat = dict(_flat_params(model) if flat is None else flat)
    hook = _BakeHook(rvars)
    with torch.no_grad():
        _forward(model, flat, _probe_spec(model), hook)
    mapping: dict[str, str] = {}
    used = set()
    for spath, wq in hook.baked.items():
        cands = [k for k in flat if k not in used and flat[k].shape == wq.shape
                 and _scope_matches(spath, k)]
        if len(cands) != 1:
            raise ValueError(f"ambiguous bake target {spath}: {cands}")
        mapping[spath] = cands[0]
        used.add(cands[0])
    return mapping, hook.baked, flat


def quantized_weight_tree_paths(model, rvars, flat: dict | None = None) -> dict[str, str]:
    """{hook path: params tree path} for every quantized weight."""
    return _trace_bake(model, rvars, flat)[0]


def _bake_params(model, rvars, flat: dict | None = None) -> dict:
    """The params (``flat``, by default the model's own) with every quantized
    weight replaced by its hard-rounded value: a nested dict of copies."""
    mapping, baked, flat = _trace_bake(model, rvars, flat)
    for spath, tpath in mapping.items():
        flat[tpath] = baked[spath]
    return _nest(flat)


_SCOPE_TO_TREE = {
    "pw1": ("point_conv1", "conv1", "pw1"),
    "pw2": ("point_conv2",),
    "pw3": ("conv3",),
    "conv": ("conv",),
    "depth_conv": ("depth_conv", "conv2"),
    "tra": ("tra",),
}


def _scope_matches(scope_path: str, tree_path: str) -> bool:
    """True iff a hook path and a params tree path name the same layer: the
    same weight leaf, the hook's layer name one of its tree aliases
    (Pointwise ``pw1`` is ``point_conv1`` in a GTConv block but ``conv1`` in
    a TCN), every enclosing block the same."""
    s_parts = scope_path.split("/")
    t_parts = tree_path.split("/")
    if s_parts[-1] != t_parts[-1]:
        return False
    s_layer, t_layer = s_parts[-2], t_parts[-2]
    if t_layer not in _SCOPE_TO_TREE.get(s_layer, (s_layer,)):
        return False
    return s_parts[:-2] == t_parts[:-2]


def save_act_qp(act_qp: dict, path: str) -> None:
    """Write ``act_qp`` as the JAX package's ``act_qp.npz`` (``<path>:scale``,
    ``:zero``, ``:qminmax``)."""
    def arr(t):
        return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)

    np.savez(path,
             **{f"{p}:scale": arr(qp.scale) for p, qp in act_qp.items()},
             **{f"{p}:zero": arr(qp.zero) for p, qp in act_qp.items()},
             **{f"{p}:qminmax": np.asarray([qp.qmin, qp.qmax]) for p, qp in act_qp.items()})


def load_act_qp(path: str, device=None) -> dict:
    """Read an ``act_qp.npz`` (this package's or the JAX package's) into
    ``QParams`` of float32 tensors on ``device``."""
    dev = resolve_device(device)
    with np.load(path) as data:
        paths = sorted({k.rsplit(":", 1)[0] for k in data.files})
        return {p: QParams(scale=torch.from_numpy(np.asarray(data[f"{p}:scale"], np.float32)).to(dev),
                           zero=torch.from_numpy(np.asarray(data[f"{p}:zero"], np.float32)).to(dev),
                           qmin=int(data[f"{p}:qminmax"][0]), qmax=int(data[f"{p}:qminmax"][1]))
                for p in paths}


def deploy_ranges(model, wav_dir: str, per_channel: bool = False) -> dict:
    """Deployment calibration ranges: the ``noisy*.wav`` of ``wav_dir`` (the
    model's serving inputs) through the reference's 973-frame protocol
    (``quant/calibration.py``), as the GTM8 export flow calibrates."""
    from gtcrn_micro_tpu_torch.quant.calibration import calibration_specs
    from gtcrn_micro_tpu_torch.quant.ptq import observe_ranges

    with tempfile.TemporaryDirectory(prefix="gtcrn_calib_") as calib_dir:
        for f in sorted(os.listdir(wav_dir)):
            if f.startswith("noisy") and f.endswith(".wav"):
                os.symlink(os.path.join(os.path.abspath(wav_dir), f), os.path.join(calib_dir, f))
        calib = calibration_specs(calib_dir, n_wavs=32)
    return observe_ranges(model, calib, batch_size=4, per_channel=per_channel)


def main(args=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--wav_dir", required=True,
                        help="noisy<i>.wav (and enh<i>.wav for --corpus_mode augmented)")
    parser.add_argument("--train_wavs", default="noisy1,noisy2,noisy3,noisy4")
    parser.add_argument("--held_out", default="noisy5")
    parser.add_argument("--corpus_mode", default="augmented", choices=("augmented", "examples"),
                        help="augmented: n_train augmented clips from wavs 1-3 and a val split "
                             "from wav 4 for early stopping (the held-out wav stays out of all "
                             "selection); examples: 4 s crops of --train_wavs, no val")
    parser.add_argument("--n_train", type=int, default=384)
    parser.add_argument("--n_val", type=int, default=48)
    parser.add_argument("--steps", type=int, default=2500)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--lr_v", type=float, default=2e-2)
    parser.add_argument("--lr_f", type=float, default=1e-4)
    parser.add_argument("--lr_w", type=float, default=0.0,
                        help="also train the quantized weights (straight-through); 0 = off")
    parser.add_argument("--w_anchor", type=float, default=0.0,
                        help="L2 anchor of trained weights to the checkpoint")
    parser.add_argument("--reg_weight", type=float, default=2e-3)
    parser.add_argument("--post_bias_steps", type=int, default=400)
    parser.add_argument("--act_bits", type=int, default=8, choices=(8, 16))
    parser.add_argument("--per_channel_acts", action="store_true",
                        help="per-lane activation scales (LSQ learns per-lane deltas); "
                             "requires --calib deploy")
    parser.add_argument("--calib", default="deploy", choices=("deploy", "corpus"))
    parser.add_argument("--out_dir", default="gtcrn_adaround")
    parser.add_argument("--device", default=None)
    ns = parser.parse_args(args)
    if ns.per_channel_acts and ns.calib != "deploy":
        parser.error("--per_channel_acts requires --calib deploy")
    dev = resolve_device(ns.device)

    from gtcrn_micro_tpu_torch.eval.infer import load_params
    from gtcrn_micro_tpu_torch.io.wav import read_wav
    from gtcrn_micro_tpu_torch.models.folding import fold_bn_params
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro
    from gtcrn_micro_tpu_torch.quant.ptq import QuantizedModel, qparams_from_ranges
    from gtcrn_micro_tpu_torch.quant.qat import (
        build_augmented_corpus,
        build_distill_corpus,
        calibrate_act_qparams,
        enhance_fp32,
        quant_wav_snr,
    )
    from gtcrn_micro_tpu_torch.utils.checkpoint import CheckpointManager

    # fold BN FIRST: the deployment chain quantizes the folded weights, so
    # the rounding is optimised on the folded graph
    model = GTCRNMicro.from_params(fold_bn_params(load_params(ns.checkpoint, device=dev)),
                                   device=dev)
    train_paths = [os.path.join(ns.wav_dir, f"{n}.wav") for n in ns.train_wavs.split(",")]

    print("building distillation corpus (float32 targets) ...", flush=True)
    if ns.corpus_mode == "augmented":
        noisy, target, val_noisy, val_target = build_augmented_corpus(
            model, ns.wav_dir, train_ids=(1, 2, 3), val_ids=(4,), n_train=ns.n_train,
            n_val=ns.n_val)
        print(f"  {len(noisy)} train + {len(val_noisy)} val augmented clips of "
              f"{noisy.shape[1] / 16000:.0f} s", flush=True)
    else:
        noisy, target = build_distill_corpus(model, train_paths, stride_seconds=2.0)
        val_noisy = val_target = None
        print(f"  {len(noisy)} segments of {noisy.shape[1] / 16000:.0f} s", flush=True)
    if ns.calib == "corpus":
        act_qp = calibrate_act_qparams(model, noisy, ns.act_bits)
    else:
        act_qp = qparams_from_ranges(deploy_ranges(model, ns.wav_dir, ns.per_channel_acts),
                                     ns.act_bits, device=dev)

    def mono(path):
        w, _ = read_wav(path)
        return w[:, 0] if w.ndim > 1 else w

    held = mono(os.path.join(ns.wav_dir, f"{ns.held_out}.wav"))
    seen = mono(train_paths[0])
    held_t, seen_t = enhance_fp32(model, held), enhance_fp32(model, seen)

    def snrs(m, qp):
        return quant_wav_snr(m, qp, seen, seen_t), quant_wav_snr(m, qp, held, held_t)

    s, h = snrs(model, act_qp)
    print(f"PTQ int{ns.act_bits} SNR vs fp32: train-wav {s:.1f} dB, held-out {h:.1f} dB",
          flush=True)
    baked, baked_qp = adaround_optimize(
        model, noisy, target, act_qp, steps=ns.steps, batch_size=ns.batch_size, lr_v=ns.lr_v,
        lr_f=ns.lr_f, lr_w=ns.lr_w, w_anchor=ns.w_anchor, reg_weight=ns.reg_weight,
        val_noisy=val_noisy, val_target=val_target)
    baked_model = GTCRNMicro.from_params(baked, device=dev)
    after_s, after_h = snrs(baked_model, baked_qp)
    print(f"AdaRound+LSQ int{ns.act_bits} SNR vs fp32: train-wav {after_s:.1f} dB, "
          f"held-out {after_h:.1f} dB", flush=True)

    def corpus_snr(m) -> float:
        """Hard-quantized SNR on the val split (the selection metric: the
        reported held-out wav takes part in no decision)."""
        window = sqrt_hann_window(model.config.win_len, device=dev)
        with torch.no_grad():
            spec = stft(torch.from_numpy(val_noisy).to(dev), window)
            out = istft(QuantizedModel(m, baked_qp).apply(spec), window,
                        length=val_noisy.shape[1]).cpu().numpy()
        err = float(np.sum((out - val_target) ** 2))
        return 10.0 * np.log10(float(np.sum(val_target**2)) / max(err, 1e-20))

    if ns.post_bias_steps:
        refined = bias_refine(baked_model, noisy, target, baked_qp, steps=ns.post_bias_steps)
        refined_model = GTCRNMicro.from_params(refined, device=dev)
        ref_s, ref_h = snrs(refined_model, baked_qp)
        print(f"+bias-refine int{ns.act_bits} SNR vs fp32: train-wav {ref_s:.1f} dB, "
              f"held-out {ref_h:.1f} dB", flush=True)
        if val_noisy is not None:  # select on the proxy split
            keep = corpus_snr(refined_model) > corpus_snr(baked_model)
        else:
            keep = ref_h > after_h  # examples mode: the JAX package's rule
        if keep:
            baked = refined
        else:
            print("  bias-refine regressed the selection split; keeping the pre-refine bake",
                  flush=True)

    os.makedirs(ns.out_dir, exist_ok=True)
    CheckpointManager(os.path.join(ns.out_dir, "checkpoints")).save(
        ns.steps, {"params": _to_cpu(baked)})
    save_act_qp(baked_qp, os.path.join(ns.out_dir, "act_qp.npz"))
    print(f"AdaRounded params + learned act scales saved to {ns.out_dir}", flush=True)


def _to_cpu(tree: dict) -> dict:
    return {k: _to_cpu(v) if isinstance(v, dict) else v.detach().cpu() for k, v in tree.items()}


if __name__ == "__main__":
    main()
