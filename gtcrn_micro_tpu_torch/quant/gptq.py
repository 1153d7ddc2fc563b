"""GPTQ weight rounding on deploy activation grids (per-layer OBS), the JAX
package's ``quant/gptq.py``.

GPTQ (Frantar et al. 2023, the OBS/OBQ line) minimises each layer's LOCAL
output reconstruction error ``||X W - X W_q||^2`` on calibration data:
per-layer least squares with no end-to-end co-adaptation, so it cannot trade
held-out fidelity for train fit as the global AdaRound objective can.

Method per weighted boundary (the 59 of ``quant/ptq.py``'s inventory):

1. capture the boundary's DEPLOY input X -- after activation fake-quant on
   the target grid, with every upstream weight already quantized (the
   sequential GPTQ schedule).  A convolution's geometry (stride, padding,
   dilation, groups, and the zero-stuffing of a transposed conv) is read from
   its ``conv2d`` call itself, which a ``TorchFunctionMode`` records in
   order after each weight hook, never from a table; X is the tensor that
   ``conv2d`` received, and the patch algebra is checked against the
   recorded conv output;
2. H = X^T X over calibration positions (per conv group: the output
   channels of a group share one patch matrix), in float64 on the device;
3. quantize fan-in entries one at a time onto the FROZEN per-out-channel
   symmetric int8 grid (``weight_qparams`` of the ORIGINAL folded weight),
   propagating each rounding error to the entries not yet quantized through
   the Cholesky factor of H^-1 (numpy float64, the JAX package's arithmetic).
   Each channel's abs-max entries are pinned to nearest and q is clipped to
   +-127, so the baked weights re-observe the identical scale and pass the
   native export's requantization bit for bit.

The JAX package pins all of this to the CPU because TPU convolutions miss
the patch check's bound; here the capture runs on the model's device at full
float32 (``nn.core.exact_f32``) under the same bound.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time

import numpy as np
import torch
import torch.nn.functional as tF
from torch.overrides import TorchFunctionMode

from gtcrn_micro_tpu_torch.quant.adaround import _flat_params, _forward, _nest, _scope_matches
from gtcrn_micro_tpu_torch.quant.fake_quant import fake_quant, weight_qparams

INT_LO, INT_HI = -127, 127  # symmetric: keeps the per-channel amax invariant


# ---------------------------------------------------------------------------
# Capture: deploy inputs and exact conv geometry per boundary
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Boundary:
    path: str
    leaf: str
    w: torch.Tensor  # param-space weight as the hook saw it (HWIO for a conv)
    channel_axis: int
    # the deploy-quantized input, retained only: for a conv the (B, C, T, F)
    # tensor conv2d received (zero-stuffed for a transposed conv), otherwise
    # the hook's output
    x: torch.Tensor | None = None
    cfg: dict | None = None  # conv2d geometry (conv boundaries)
    out: torch.Tensor | None = None  # conv output without bias (patch check)
    keep: bool = True  # retains its input


class _CaptureHook:
    """``ctx.quant`` hook: applies deploy activation fake-quant and records
    each weight boundary's (path, w, channel_axis, input)."""

    def __init__(self, act_qp: dict, retain: set[str] | None):
        self.act_qp = act_qp
        self.retain = retain  # None = retain all
        self.records: list[_Boundary] = []
        self.pending: _Boundary | None = None  # the conv whose conv2d comes next
        self._last_x = None

    def act(self, path: str, x):
        xq = fake_quant(x, self.act_qp[path])
        self._last_x = xq
        return xq

    def weight(self, path: str, w, channel_axis: int):
        keep = self.retain is None or path in self.retain
        rec = _Boundary(path=path, leaf=path.rsplit("/", 1)[1], w=w.detach(),
                        channel_axis=channel_axis, x=self._last_x if keep else None, keep=keep)
        self.records.append(rec)
        # a conv layer calls conv2d right after its weight hook
        self.pending = rec if w.dim() == 4 else None
        return w


def _pair(v) -> tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class _ConvRecorder(TorchFunctionMode):
    """Hands each ``conv2d`` call's geometry, input and (bias-free) output to
    the conv boundary whose weight hook came just before it."""

    ARGS = ("input", "weight", "bias", "stride", "padding", "dilation", "groups")

    def __init__(self, hook: _CaptureHook):
        super().__init__()
        self.hook = hook

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is tF.conv2d and self.hook.pending is not None:
            rec, self.hook.pending = self.hook.pending, None
            a = {"bias": None, "stride": 1, "padding": 0, "dilation": 1, "groups": 1,
                 **dict(zip(self.ARGS, args)), **kwargs}
            x = a["input"]
            f_in = rec.x.shape[2] if rec.x is not None else None
            rec.cfg = {"stride": _pair(a["stride"]), "padding": _pair(a["padding"]),
                       "dilation": _pair(a["dilation"]), "groups": a["groups"]}
            if rec.keep:
                # the hook saw (B, T, F, C); conv2d gets (B, C, T, F_up),
                # F_up = (F - 1) up + 1 for a transposed conv
                rec.cfg["freq_up"] = (x.shape[3] - 1) // (f_in - 1) if f_in > 1 else 1
                rec.x = x.detach()
                b = a["bias"]
                rec.out = (out if b is None else out - b[:, None, None]).detach()
        return out


def capture_boundaries(model, act_qp: dict, specs, retain: set[str] | None = None,
                       flat: dict | None = None) -> list[_Boundary]:
    """One offline forward of ``model`` (its own tensors, or ``flat``'s) on
    specs (N, F, T, 2) under the deploy activation grid, on the model's
    device; returns the boundary records in execution order.  ``retain``
    limits which boundaries keep their (possibly large) inputs."""
    dev = model.device
    hook = _CaptureHook({p: qp.to(dev) for p, qp in act_qp.items()}, retain)
    spec = torch.as_tensor(specs).to(dev, model.dtype)
    with torch.no_grad(), _ConvRecorder(hook):
        _forward(model, _flat_params(model) if flat is None else flat, spec, hook)
    return hook.records


def make_input_capture(model, act_qp: dict):
    """``run(flat, specs, paths) -> {path: deploy-quantized input}`` (a conv's
    as ``conv2d`` received it) for the boundaries in ``paths``, through the
    tensors of ``flat`` (``/``-keyed)."""
    def run(flat: dict, specs, paths: set[str]) -> dict:
        recs = capture_boundaries(model, act_qp, specs, retain=set(paths), flat=flat)
        return {r.path: r.x for r in recs if r.path in paths}

    return run


# ---------------------------------------------------------------------------
# Patch algebra: boundary -> (P, W_mat) per group, self-checked
# ---------------------------------------------------------------------------


def _conv_patches(rec: _Boundary) -> torch.Tensor:
    """(N, C kT kF) patch rows of a conv boundary, features in the order
    (c, kt, kf), c slowest (``conv_general_dilated_patches``' and
    ``unfold``'s), positions (b, t, f); float32 on the input's device
    (callers subsample rows before widening to float64)."""
    kT, kF = rec.w.shape[0], rec.w.shape[1]
    c = rec.cfg
    p = tF.unfold(rec.x, (kT, kF), dilation=c["dilation"], padding=c["padding"],
                  stride=c["stride"])  # (B, C kT kF, positions)
    return p.transpose(1, 2).reshape(-1, p.shape[1])


def _subsample(p: torch.Tensor, max_rows: int | None) -> torch.Tensor:
    if max_rows is not None and p.shape[0] > max_rows:
        p = p[:: p.shape[0] // max_rows + 1]
    return p.double()


def _boundary_groups(rec: _Boundary, max_rows: int | None = None):
    """Yield (P_g, W_g, scale_g, pin_g) per quantization group: P_g (N, d)
    float64 on the capture's device, W_g (d, m) float64, scale_g (m,) and
    pin_g (d, m) numpy.  Groups: conv feature groups (depthwise: one per
    channel); TRA depth taps: one per channel; matmuls: one."""
    w32 = rec.w.cpu().numpy()
    w = np.asarray(w32, np.float64)
    scale = weight_qparams(torch.from_numpy(w32), rec.channel_axis).scale.numpy().astype(np.float64)
    # channel abs-max entries stay nearest-pinned.  amax comes from the
    # weight itself, NOT scale*127: the f32 scale may round UP, putting
    # scale*127 a few ulp above the true amax and un-pinning the max entry
    axes = tuple(i for i in range(w.ndim) if i != rec.channel_axis)
    amax = np.max(np.abs(w), axis=axes, keepdims=True)
    pin = np.abs(w) >= amax - 1e-12

    if rec.cfg is not None:  # conv: HWIO weight
        kT, kF, cin_g, cout = w.shape
        g = rec.cfg["groups"]
        outg = cout // g
        patches = _conv_patches(rec)  # features (c, kt, kf), c slowest
        out = rec.out.permute(0, 2, 3, 1).reshape(-1, cout) if rec.out is not None else None
        sc = scale.reshape(cout)
        for gi in range(g):
            cols = slice(gi * outg, (gi + 1) * outg)
            rows = slice(gi * cin_g * kT * kF, (gi + 1) * cin_g * kT * kF)
            # W rows in the patch feature order (ci, kt, kf)
            w_g = w[:, :, :, cols].transpose(2, 0, 1, 3).reshape(cin_g * kT * kF, outg)
            pin_g = pin[:, :, :, cols].transpose(2, 0, 1, 3).reshape(cin_g * kT * kF, outg)
            p_g = patches[:, rows]
            if out is not None:  # check the patch algebra once
                got = p_g.double() @ torch.from_numpy(w_g).to(p_g.device)
                ref = out[:, cols].double()
                err = float((got - ref).abs().max())
                tol = 1e-3 * max(1.0, float(ref.abs().max()))
                if err > tol:
                    raise RuntimeError(f"{rec.path}: patch algebra mismatch ({err:.3e}) -- "
                                       "conv geometry or feature order wrong")
            yield _subsample(p_g, max_rows), w_g, sc[cols], pin_g
    elif rec.leaf == "depth_w":  # TRA temporal taps: y[t] = sum_i e[t+i] w[i]
        k, c = w.shape
        e = rec.x  # (B, T + L, C), already padded
        t_out = e.shape[1] - (k - 1)
        sc = scale.reshape(c)
        for ci in range(c):
            cols = torch.stack([e[:, i : i + t_out, ci].reshape(-1) for i in range(k)], dim=1)
            yield _subsample(cols, max_rows), w[:, ci : ci + 1], sc[ci : ci + 1], pin[:, ci : ci + 1]
    else:  # pointwise matmul: y = x @ w, w (C_in, C_out)
        yield _subsample(rec.x.reshape(-1, w.shape[0]), max_rows), w, scale.reshape(-1), pin


def _reassemble(rec: _Boundary, parts: list[np.ndarray]) -> np.ndarray:
    """Inverse of :func:`_boundary_groups`' W_g layout -> param-space weight."""
    if rec.cfg is not None:
        kT, kF, cin_g, cout = rec.w.shape
        outg = cout // rec.cfg["groups"]
        w_new = np.empty(tuple(rec.w.shape), dtype=np.float64)
        for gi, w_g in enumerate(parts):
            cols = slice(gi * outg, (gi + 1) * outg)
            w_new[:, :, :, cols] = w_g.reshape(cin_g, kT, kF, outg).transpose(1, 2, 0, 3)
        return w_new
    if rec.leaf == "depth_w":
        return np.concatenate(parts, axis=1)
    return parts[0]


# ---------------------------------------------------------------------------
# GPTQ core (numpy float64; W (d fan-in, m out-channels)), the JAX package's
# ---------------------------------------------------------------------------


def gptq_rows(P: np.ndarray, W: np.ndarray, scale: np.ndarray, pin: np.ndarray,
              damp: float = 0.01, act_order: bool = True) -> np.ndarray:
    """Quantize W's d fan-in rows onto per-column symmetric grids,
    compensating each row's rounding error through H = P^T P.

    ``pin`` entries are forced to the nearest rounding of the ORIGINAL value
    (per-channel amax invariance); q is clipped to +-127 so no adjusted entry
    can grow the channel's amax.  Returns the dequantized on-grid weight."""
    return gptq_hessian_rows(P.T @ P, W, scale, pin, damp, act_order)


def gptq_hessian_rows(H: np.ndarray, W: np.ndarray, scale: np.ndarray, pin: np.ndarray,
                      damp: float = 0.01, act_order: bool = True) -> np.ndarray:
    """:func:`gptq_rows` from the Hessian ``H = P^T P`` (float64, modified
    in place)."""
    d, m = W.shape
    W_orig = W
    W = W.astype(np.float64).copy()
    diag = np.diag(H).copy()
    dead = diag <= 0
    H[dead, dead] = 1.0
    H = H + damp * max(float(diag.mean()), 1e-12) * np.eye(d)
    order = np.argsort(-np.diag(H)) if act_order else np.arange(d)
    inv_order = np.argsort(order)
    Hp = H[order][:, order]
    # U upper-triangular with H^-1 = U^T U (the GPTQ propagation factor)
    U = np.linalg.cholesky(np.linalg.inv(Hp)).T
    Wp = W[order]
    Wo = W_orig[order]
    pinp = pin[order]
    deadp = dead[order]
    Q = np.empty_like(Wp)
    for i in range(d):
        q = np.clip(np.round(Wp[i] / scale), INT_LO, INT_HI)
        q_orig = np.clip(np.round(Wo[i] / scale), INT_LO, INT_HI)
        # pinned (channel amax) and dead (never fires on calibration) rows
        # take the nearest rounding of the ORIGINAL value
        q = np.where(pinp[i] | deadp[i], q_orig, q)
        dq = q * scale  # the deploy (grid) value drives the error propagation
        # pinned entries keep their ORIGINAL float value: 127*(amax/127) is
        # one f32 ulp off amax, which would drift the re-observed scale
        Q[i] = np.where(pinp[i], Wo[i], dq)
        if i + 1 < d:
            err = (Wp[i] - dq) / U[i, i]
            Wp[i + 1 :] -= np.outer(U[i, i + 1 :], err)
    return Q[inv_order]


def local_error(P: np.ndarray, W: np.ndarray, W_q: np.ndarray) -> float:
    """||P (W - W_q)||_F -- the objective GPTQ minimises per layer."""
    return float(np.linalg.norm(P @ (W - W_q)))


# ---------------------------------------------------------------------------
# Hessian corpus: input-only augmentation from any wav dir
# ---------------------------------------------------------------------------


def augmented_hessian_specs(model, wav_dir: str, n_clips: int = 96,
                            segment_seconds: float = 4.0, fs: int = 16000,
                            seed: int = 0) -> torch.Tensor:
    """(n_clips, F, T, 2) augmented Hessian corpus from ANY 16 kHz wav dir,
    on the model's device (``model`` the float ``GTCRNMicro``).

    The per-layer objective needs input DIVERSITY.  When the dir's
    ``noisy<N>.wav`` files (symlinks followed) have ``enh<N>.wav`` siblings,
    the corpus is ``quant/qat.build_augmented_corpus``'s with the LAST id as
    the val source; otherwise an input-only proxy corpus whose clean
    proxies are the model's own enhancements."""
    from gtcrn_micro_tpu_torch.dsp.stft import sqrt_hann_window, stft
    from gtcrn_micro_tpu_torch.io.wav import read_wav
    from gtcrn_micro_tpu_torch.quant.qat import (
        _mix_at_snr,
        _pink_noise,
        build_augmented_corpus,
        enhance_fp32_batch,
    )

    seg = int(segment_seconds * fs)
    rng = np.random.default_rng(seed)
    window = sqrt_hann_window(model.config.win_len, device=model.device)

    def specs_of(batch: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return stft(torch.from_numpy(np.asarray(batch, np.float32)).to(model.device), window)

    # noisy/enh pairs resolvable through symlinks: the A/B-exact recipe
    pair_ids: list[int] = []
    src_dirs = set()
    wav_names = sorted(f for f in os.listdir(wav_dir) if f.endswith(".wav"))
    for f in wav_names:
        m = re.fullmatch(r"noisy(\d+)\.wav", f)
        if m is None:
            pair_ids = []
            break
        real = os.path.realpath(os.path.join(wav_dir, f))
        if not os.path.exists(os.path.join(os.path.dirname(real), f"enh{m.group(1)}.wav")):
            pair_ids = []
            break
        pair_ids.append(int(m.group(1)))
        src_dirs.add(os.path.dirname(real))
    if len(pair_ids) >= 2 and len(src_dirs) == 1:
        ids = sorted(pair_ids)
        train_ids = tuple(ids[:-1]) if len(ids) > 2 else tuple(ids)
        noisy_tr, _, _, _ = build_augmented_corpus(
            model, src_dirs.pop(), train_ids=train_ids, val_ids=(ids[-1],), n_train=n_clips,
            n_val=4, segment_seconds=segment_seconds, fs=fs, seed=seed)
        return specs_of(noisy_tr)

    # fallback: input-only proxy corpus from ANY wav dir
    noisy_src = []
    for f in wav_names:
        w, wav_fs = read_wav(os.path.join(wav_dir, f))
        if w.ndim > 1:
            w = w[:, 0]
        if wav_fs != fs:
            raise ValueError(f"expected {fs} Hz, got {wav_fs} ({f})")
        noisy_src.append(w.astype(np.float32))
    if not noisy_src:
        raise FileNotFoundError(f"no wavs in {wav_dir}")
    # clean proxies: the model's own enhancement of fixed-length crops
    crop0 = np.stack([(np.tile(w, seg * 2 // len(w) + 1) if len(w) < seg * 2 else w)[: seg * 2]
                      for w in noisy_src])
    enh_src = list(enhance_fp32_batch(model, crop0))

    def crop(w):
        if len(w) < seg:
            w = np.tile(w, seg // len(w) + 1)
        s = rng.integers(0, len(w) - seg + 1)
        return w[s : s + seg]

    clips = []
    n = len(noisy_src)
    for _ in range(n_clips):
        r = rng.random()
        k = int(rng.integers(n))
        if r < 0.25:  # raw serving-distribution crop
            clips.append(crop(noisy_src[k]))
        elif r < 0.50:  # clean proxy + stationary noise
            noise = (_pink_noise(rng, seg) if rng.random() < 0.5
                     else rng.standard_normal(seg).astype(np.float32))
            clips.append(_mix_at_snr(rng, crop(enh_src[k]), noise, -5.0, 20.0))
        elif r < 0.70:  # clean proxy + other-wav interference
            j = (k + 1 + int(rng.integers(max(n - 1, 1)))) % n
            clips.append(_mix_at_snr(rng, crop(enh_src[k]), crop(noisy_src[j]), 0.0, 15.0))
        elif r < 0.85:  # gain sweep over the serving distribution
            clips.append(crop(noisy_src[k]) * rng.uniform(0.25, 2.0))
        else:  # synthetic tone mixture (the make_smoke_data recipe)
            t = np.arange(seg) / fs
            clean = sum(a * np.sin(2 * np.pi * f * t)
                        for a, f in zip(rng.uniform(0.05, 0.2, 3),
                                        rng.uniform(100, 2000, 3))).astype(np.float32)
            noise = rng.standard_normal(seg).astype(np.float32)
            clips.append(_mix_at_snr(rng, clean, noise, 0.0, 10.0))
    return specs_of(np.stack(clips))


# ---------------------------------------------------------------------------
# The sequential bake over the execution-ordered boundaries
# ---------------------------------------------------------------------------


def _tree_mapping(records: list[_Boundary], flat: dict) -> dict[str, str]:
    """{hook path: params tree path} (``quant/adaround._trace_bake``'s
    matching: shared prefix, layer alias and shape, asserted unique)."""
    mapping: dict[str, str] = {}
    used: set[str] = set()
    for rec in records:
        cands = [k for k in flat if k not in used and flat[k].shape == rec.w.shape
                 and _scope_matches(rec.path, k)]
        if len(cands) != 1:
            raise ValueError(f"ambiguous target {rec.path}: {cands}")
        mapping[rec.path] = cands[0]
        used.add(cands[0])
    return mapping


def _nearest(W: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return np.clip(np.round(W / scale), INT_LO, INT_HI) * scale


def _sq_err(P: torch.Tensor, dW: np.ndarray) -> float:
    """``local_error(P, dW, 0) ** 2`` on P's device."""
    return float((P @ torch.from_numpy(dW).to(P.device)).square().sum())


def gptq_params(model, act_qp: dict, specs, *, damp: float = 0.01, act_order: bool = True,
                max_rows: int = 250_000, log=None, report: list | None = None) -> dict:
    """Bake every quantized weight of ``model`` (the BN-folded float
    ``GTCRNMicro``, on the device the capture runs on) with GTPQ on the
    deploy grid ``act_qp``.

    ``specs``: (N, F, T, 2) calibration batch.  Sequential: boundary k's
    inputs are captured with boundaries < k already baked.  Returns the
    params (nested dict of tensors on the model's device); every baked
    weight is on its grid (``fake_quant`` is the identity) with the
    original's per-channel scale bit for bit (checked; a failure raises).
    ``report`` (a list) receives one dict per boundary: path, size, flips
    against nearest rounding, calibration rows, seconds, and the local error
    ``||P (W - W_q)||_F`` of GPTQ and of nearest rounding on the same rows."""
    dev = model.device
    act_qp = {p: qp.to(dev) for p, qp in act_qp.items()}
    specs = torch.as_tensor(specs).to(dev, model.dtype)
    # probe on a small slice: conv geometry, patch check, boundary order
    probe = capture_boundaries(model, act_qp, specs[: min(2, specs.shape[0]), :, :33])
    for rec in probe:
        for _ in _boundary_groups(rec):  # runs the patch checks
            pass
    flat = dict(_flat_params(model))
    mapping = _tree_mapping(probe, flat)
    capture = make_input_capture(model, act_qp)
    for k, b in enumerate(probe):
        t0 = time.perf_counter()
        rec = dataclasses.replace(b, w=flat[mapping[b.path]], out=None)
        rec.x = capture(flat, specs, {b.path})[b.path]
        orig_w = rec.w.cpu().numpy()
        scale0 = weight_qparams(torch.from_numpy(orig_w), rec.channel_axis).scale
        parts, n_pos, err2, near2 = [], 0, 0.0, 0.0
        for P, W, sc, pin in _boundary_groups(rec, max_rows=max_rows):
            n_pos = P.shape[0]
            Q = gptq_hessian_rows((P.T @ P).cpu().numpy(), W, sc, pin, damp, act_order)
            parts.append(Q)
            if report is not None:
                err2 += _sq_err(P, W - Q)
                near2 += _sq_err(P, W - _nearest(W, sc))
        w_new = _reassemble(rec, parts)
        # clamp to the original per-channel amax: a +-127 code is one f32 ulp
        # above amax when the scale rounded up, which would drift the
        # re-observed scale (fake_quant recomputes the deploy value anyway)
        axes = tuple(i for i in range(orig_w.ndim) if i != rec.channel_axis)
        amax0 = np.max(np.abs(orig_w), axis=axes, keepdims=True)
        w_new = np.clip(w_new, -amax0, amax0).astype(orig_w.dtype)
        w_t = torch.from_numpy(w_new)
        qp1 = weight_qparams(w_t, rec.channel_axis)
        if not torch.equal(qp1.scale, scale0):
            raise RuntimeError(f"{rec.path}: scale drifted")
        tol = 1e-6 * float(np.max(np.abs(w_new)) + 1e-12)
        if float((fake_quant(w_t, qp1) - w_t).abs().max()) > tol:
            raise RuntimeError(f"{rec.path}: baked weight off-grid")
        flat[mapping[rec.path]] = w_t.to(dev)
        nearest = np.clip(np.round(orig_w / scale0.numpy()), INT_LO, INT_HI) * scale0.numpy()
        flips = int(np.sum(w_new != nearest.astype(orig_w.dtype)))
        if log is not None:
            log(f"[{k + 1:2d}/{len(probe)}] {rec.path}: {flips}/{orig_w.size} flips vs "
                f"nearest ({n_pos} calib rows)")
        if report is not None:
            report.append({"path": rec.path, "size": int(orig_w.size), "flips": flips,
                           "rows": int(n_pos), "seconds": time.perf_counter() - t0,
                           "local_err": err2 ** 0.5, "nearest_err": near2 ** 0.5})
    return _nest(flat)
