"""The whole per-frame GTCRN-Micro forward as one CUDA kernel (kernel B1).

Counterpart of the JAX package's ``ops/fused_step.py``.  What is here:

- ``RING_DEFS``: the 20 ring caches (name, length L, tap stride d, frame
  shape).  The port keeps every ring as ``(L, *frame, B)`` with the stream
  batch innermost -- the JAX grid layout without its pad of F to 40 -- and
  one integer ``step`` counter that wraps ``& 15``.
- :func:`pack_weights`: the 158 kernel weights in the JAX order, BatchNorm
  folded, in ONE contiguous buffer with an offset table (no Mosaic trailing
  singleton dims).  :func:`unpack` reverses it.
- :func:`kernel_weights`: the same entries as the CUDA kernels read them:
  float32, 16-byte aligned, the ERB matrices as band tables
  (:func:`band_table`).
- :func:`forward_plain`: the plain PyTorch version of the kernel on the
  ``(C, F, B)`` layout, computed in float32 like the kernel.
- :class:`LayoutGTCRNMicro`: a serving model whose step is the plain version
  on any device; the reference the kernels are held against.
- :class:`FusedGTCRNMicro`: the same step protocol with kernel B1 on CUDA
  tensors.  Its wrapper takes the two tap frames of each ring (slots
  ``t mod L`` and ``(t+d) mod L``), launches B1 once over all stream tiles
  with slot ``t mod L`` as each new frame's destination, and advances the
  counter.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as tF

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicroConfig
from gtcrn_micro_tpu_torch.ops import _build

F_FULL = 257
F_ERB = 129
F_DOWN = 33
C = 16
H = C // 2  # channel-split half

# (state key, ring length L, tap stride d, frame shape minus batch)
RING_DEFS = (
    [(f"enc{i}_dw", 2, 1, (C, F_DOWN)) for i in range(3)]
    + [(f"enc{i}_tra", 2, 1, (H,)) for i in range(3)]
    + [(f"dec{i}_dw", 2, 1, (C, F_DOWN)) for i in range(3)]
    + [(f"dec{i}_tra", 2, 1, (H,)) for i in range(3)]
    + [(f"tcn{s}{j}", 2 * 2**j, 2**j, (C, F_DOWN))
       for s in range(2) for j in range(4)]
)

_GT_KEYS = ["pw1_w", "pw1_b", "a1", "dw_w", "dw_b", "a2", "pw2_w", "pw2_b",
            "tra_dw", "tra_db", "tra_pw", "tra_pb"]
_TCN_KEYS = ["pw1_w", "pw1_b", "a1", "dw_w", "dw_b", "a2", "pw3_w", "pw3_b",
             "a3"]
N_WEIGHTS = 3 + 2 * 3 + 6 * len(_GT_KEYS) + 8 * len(_TCN_KEYS) + 3 + 2


# ---------------------------------------------------------------------------
# weight packing (BN folded), same order and values as the JAX package
# ---------------------------------------------------------------------------


def _bn_fold(w_out_axis_last, b, bn, eps=1e-5):
    """Fold eval-mode BatchNorm into a conv weight (out-channel on the LAST
    axis) and bias, in float32 numpy as the JAX package does."""
    s = bn["gamma"] / np.sqrt(np.asarray(bn["running_var"]) + eps)
    w = np.asarray(w_out_axis_last) * s
    b = (np.asarray(b) * s + np.asarray(bn["beta"])
         - np.asarray(bn["running_mean"]) * s)
    return w, b


def _gtconv_pack(p, deconv: bool) -> list:
    w, b = _bn_fold(p["point_conv1"]["w"], p["point_conv1"]["b"], p["point_bn1"])
    out = [w.T, b, p["point_act"]["alpha"]]  # pw1_w (16, 8), pw1_b, a1
    w, b = _bn_fold(p["depth_conv"]["w"], p["depth_conv"]["b"], p["depth_bn"])
    if deconv:  # HWIO (3,3,16,16) -> (kt, kf, Cout, Cin)
        out.append(w.transpose(0, 1, 3, 2))
    else:  # HWIO (3,3,1,16) depthwise -> (kt*3+kf, C)
        out.append(w[:, :, 0, :].reshape(9, C))
    out += [b, p["depth_act"]["alpha"]]
    w, b = _bn_fold(p["point_conv2"]["w"], p["point_conv2"]["b"], p["point_bn2"])
    out += [w.T, b]  # pw2_w (8, 16), pw2_b
    tra = p["tra"]
    out += [tra["depth_w"], tra["depth_b"], np.asarray(tra["point_w"]).T,
            tra["point_b"]]  # tra_dw (3, 8), tra_db, tra_pw (8, 8), tra_pb
    return out


def _tcn_pack(p) -> list:
    w, b = _bn_fold(p["conv1"]["w"], p["conv1"]["b"], p["bn1"])
    out = [w.T, b, p["act1"]["alpha"]]
    # depthwise (k,1) time conv: HWIO (3,1,1,16) -> (3, C)
    w, b = _bn_fold(p["conv2"]["w"], p["conv2"]["b"], p["bn2"])
    out += [w[:, 0, 0, :], b, p["act2"]["alpha"]]
    w, b = _bn_fold(p["conv3"]["w"], p["conv3"]["b"], p["bn3"])
    out += [w.T, b, p["act3"]["alpha"]]
    return out


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().float().numpy()
    return np.asarray(tree, np.float32)


@dataclasses.dataclass(frozen=True)
class PackedWeights:
    """The kernel weights: one contiguous 1-D ``buf`` plus, per entry, its
    element offset and shape, in the JAX ``pack_weights`` order."""

    buf: torch.Tensor
    offsets: tuple
    shapes: tuple

    @property
    def dtype(self):
        return self.buf.dtype

    def entries(self) -> list:
        return [self.buf[o : o + int(np.prod(s))].view(s)
                for o, s in zip(self.offsets, self.shapes)]


def pack_weights(params, dtype=torch.float32, device=None) -> PackedWeights:
    """Flatten the model's params into the kernel's weight buffer (fixed order,
    BN folded).  ``params`` is the nested dict of ``init_params`` (tensors)
    or of the JAX package (arrays)."""
    p = _numpy_tree(params)
    W: list = [p["erb"]["bm_w"].T,  # (64, 192)
               p["erb"]["bs_w"].T,  # (192, 64)
               p["sfe"]["depth_conv"]["w"][0, :, 0, :]]  # HWIO (1,3,1,3) -> (kf, c)
    for name in ("en0", "en1"):
        q = p["encoder"][name]
        w, b = _bn_fold(q["conv"]["w"], q["conv"]["b"], q["bn"])
        W += [w[0].transpose(0, 2, 1), b, q["act"]["alpha"]]  # (5, Cout, Cin)
    for name in ("en2", "en3", "en4"):
        W += _gtconv_pack(p["encoder"][name], deconv=False)
    for stack in ("gtcn1", "gtcn2"):
        for j in range(4):
            W += _tcn_pack(p[stack][f"block{j}"])
    for name in ("de0", "de1", "de2"):
        W += _gtconv_pack(p["decoder"][name], deconv=True)
    for name, is_last in (("de3", False), ("de4", True)):
        q = p["decoder"][name]
        w, b = _bn_fold(q["conv"]["w"], q["conv"]["b"], q["bn"])
        W += [w[0].transpose(0, 2, 1), b]  # (5, Cout, Cin)
        if not is_last:
            W.append(q["act"]["alpha"])
    assert len(W) == N_WEIGHTS, len(W)

    arrs = [np.asarray(w, np.float32) for w in W]
    sizes = [a.size for a in arrs]
    offsets = tuple(int(o) for o in np.cumsum([0] + sizes[:-1]))
    flat = np.concatenate([a.reshape(-1) for a in arrs])
    buf = torch.from_numpy(flat).to(resolve_device(device), dtype)
    return PackedWeights(buf, offsets, tuple(a.shape for a in arrs))


def band_table(m: np.ndarray) -> np.ndarray:
    """A matrix whose rows are zero outside one span, as the kernels' band
    table: per row the first column of the span from its first to its last
    nonzero, the span's length and where its weights start (from the table's
    start), then every row's span of weights, contiguously.  All float32 (the
    integers are exact); an all-zero row has length 0."""
    starts, spans = [], []
    for r in np.asarray(m, np.float32):
        nz = np.flatnonzero(r)
        first, end = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        starts.append(first)
        spans.append(r[first:end])
    lens = [w.size for w in spans]
    woff = 3 * len(spans) + np.cumsum([0] + lens[:-1])
    head = np.stack([starts, lens, woff], axis=1).reshape(-1)
    return np.concatenate([head.astype(np.float32)] + spans)


# The kernels' entry order: the pack order with bs_w (entry 1, used last) at
# the end, so that the entries of each layer the kernels stage into shared
# memory together lie in one span of the buffer.
KERNEL_ORDER = (0, *range(2, N_WEIGHTS), 1)
_BANDED = (0, 1)  # bm_w, bs_w: stored as band tables


@dataclasses.dataclass(frozen=True)
class KernelWeights:
    """The kernels' weight buffer: float32 ``buf`` holding the 158 entries of
    :class:`PackedWeights` at ``offsets`` (pack order; each a multiple of 4
    floats, 16 bytes), bm_w and bs_w as :func:`band_table`\\ s, the others
    exactly as packed, widened to float32."""

    buf: torch.Tensor
    offsets: tuple


def kernel_weights(packed: PackedWeights) -> KernelWeights:
    """Build the kernels' weight buffer from the packed weights, on their
    device.  bf16 values widen to float32 exactly."""
    entries = [e.detach().float().cpu().numpy() for e in packed.entries()]
    offsets, parts, n = [0] * N_WEIGHTS, [], 0
    for i in KERNEL_ORDER:
        a = band_table(entries[i]) if i in _BANDED else entries[i].reshape(-1)
        offsets[i] = n
        pad = -a.size % 4
        parts += [a, np.zeros(pad, np.float32)]
        n += a.size + pad
    buf = torch.from_numpy(np.concatenate(parts)).to(packed.buf.device)
    return KernelWeights(buf, tuple(offsets))


def unpack(packed: PackedWeights) -> dict:
    """Mirror of :func:`pack_weights`: nested dict of float32 tensors (the
    PReLU slopes are 0-d)."""
    it = iter(e.float() for e in packed.entries())
    W = {"bm_w": next(it), "bs_w": next(it), "sfe_w": next(it)}
    for name in ("en0", "en1"):
        W[name] = {k: next(it) for k in ("w", "b", "a")}
    for name in ("en2", "en3", "en4"):
        W[name] = {k: next(it) for k in _GT_KEYS}
    for stack in ("gtcn1", "gtcn2"):
        for j in range(4):
            W[f"{stack}b{j}"] = {k: next(it) for k in _TCN_KEYS}
    for name in ("de0", "de1", "de2"):
        W[name] = {k: next(it) for k in _GT_KEYS}
    W["de3"] = {k: next(it) for k in ("w", "b", "a")}
    W["de4"] = {k: next(it) for k in ("w", "b")}
    return W


# ---------------------------------------------------------------------------
# the plain PyTorch version of the kernel (float32, layout (C, F, B))
# ---------------------------------------------------------------------------


def _prelu(x, a):
    return x.clamp_min(0) + a * x.clamp_max(0)


def _cdot(w, x):
    """Channel mix: (Co, Ci) @ (Ci, ...) -> (Co, ...)."""
    return torch.tensordot(w, x, dims=1)


def _col(v):
    """(C,) bias -> (C, 1, 1) to broadcast over (C, F, B)."""
    return v[:, None, None]


def _pad_f(x, lo, hi):
    return tF.pad(x, (0, 0, lo, hi))


def _conv5_stride2(x, w, b, a):
    """(1,5) freq conv, stride 2, pad 2, folded bias + PReLU:
    x (Ci, F, B), w (5, Co, Ci) -> (Co, (F-1)//2+1, B)."""
    Ci, F, B = x.shape
    out_f = (F + 4 - 5) // 2 + 1
    xp = _pad_f(x, 2, 2 + (F + 4) % 2)
    r = xp.reshape(Ci, xp.shape[1] // 2, 2, B)
    ev, od = r[:, :, 0], r[:, :, 1]  # xp[2i], xp[2i+1]
    acc = sum(_cdot(w[k], (ev if k % 2 == 0 else od)[:, k // 2 : k // 2 + out_f])
              for k in range(5))
    return _prelu(acc + _col(b), a)


def _deconv5_up2(x, w, b):
    """(1,5) transposed freq conv, stride 2, pad 2 (zero-stuff, then pad 2):
    x (Ci, F, B) -> (Co, 2F-1, B)."""
    Ci, F, B = x.shape
    out_f = 2 * F - 1
    xd = torch.stack([x, torch.zeros_like(x)], dim=2).reshape(Ci, 2 * F, B)
    xp = _pad_f(xd[:, : 2 * F - 1], 2, 2)
    acc = sum(_cdot(w[k], xp[:, k : k + out_f]) for k in range(5))
    return acc + _col(b)


def _dw_freq3(x, w9, kt):
    """Depthwise 3-tap freq conv (pad 1): x (C,F,B), w9 (9,C) row kt*3+kf."""
    xp = _pad_f(x, 1, 1)
    F = x.shape[1]
    return (_col(w9[kt * 3]) * xp[:, 0:F] + _col(w9[kt * 3 + 1]) * xp[:, 1 : F + 1]
            + _col(w9[kt * 3 + 2]) * xp[:, 2 : F + 2])


def _full_freq3(x, w, kt):
    """Full 3-tap freq conv (pad 1): x (Ci,F,B), w (3,3,Co,Ci) row kt."""
    xp = _pad_f(x, 1, 1)
    F = x.shape[1]
    return sum(_cdot(w[kt, kf], xp[:, kf : kf + F]) for kf in range(3))


def _gtconv(x, W, dw_taps, tra_taps, deconv):
    """GTConvBlock.  Returns (out (16,F,B), dw ring frame h, tra ring frame e).
    Output channel 2i is the gated half, 2i+1 the passive half."""
    x1, x2 = x[:H], x[H:]
    h = _prelu(_cdot(W["pw1_w"], x1) + _col(W["pw1_b"]), W["a1"])

    tap0, tap1 = dw_taps  # x_{t-2}, x_{t-1}
    freq = _full_freq3 if deconv else _dw_freq3
    y = (freq(tap0, W["dw_w"], 0) + freq(tap1, W["dw_w"], 1)
         + freq(h, W["dw_w"], 2) + _col(W["dw_b"]))
    h2 = _prelu(y, W["a2"])
    h3 = _cdot(W["pw2_w"], h2) + _col(W["pw2_b"])  # (8,F,B)

    e = (h3 * h3).mean(dim=1)  # (8,B)
    e0, e1 = tra_taps  # e_{t-2}, e_{t-1}
    dw = W["tra_dw"][:, :, None]
    yg = W["tra_db"][:, None] + dw[0] * e0 + dw[1] * e1 + dw[2] * e
    g = torch.sigmoid(_cdot(W["tra_pw"], yg) + W["tra_pb"][:, None])
    h4 = h3 * g[:, None, :]
    out = torch.stack([h4, x2], dim=1).reshape(C, x.shape[1], x.shape[2])
    return out, h, e


def _tcn(x, W, taps):
    """Residual TCN block.  Returns (out, ring frame h)."""
    h = _prelu(_cdot(W["pw1_w"], x) + _col(W["pw1_b"]), W["a1"])
    tap0, tap1 = taps  # x_{t-2d}, x_{t-d}
    dw = W["dw_w"][:, :, None, None]
    y = dw[0] * tap0 + dw[1] * tap1 + dw[2] * h + _col(W["dw_b"])
    h2 = _prelu(y, W["a2"])
    h3 = _cdot(W["pw3_w"], h2) + _col(W["pw3_b"])
    return _prelu(h3 + x, W["a3"]), h


def _erb_features(W, spec):
    """spec (2,257,B) -> (mag, re, im) ERB-merged (3,129,B); mag is
    sqrt(re^2 + im^2 + 1e-12) and bins 0-64 pass through unchanged."""
    re, im = spec[0], spec[1]
    mag = torch.sqrt(re * re + im * im + 1e-12)
    return torch.stack([torch.cat([ch[:65], _cdot(W["bm_w"], ch[65:])])
                        for ch in (mag, re, im)])


def _sfe(W, x):
    """SFE-Lite: depthwise 3-tap freq conv, no bias, on (3, 129, B)."""
    sfe = W["sfe_w"][:, :, None, None]  # (kf, c, 1, 1)
    xp = _pad_f(x, 1, 1)
    return (sfe[0] * xp[:, 0:F_ERB] + sfe[1] * xp[:, 1 : F_ERB + 1]
            + sfe[2] * xp[:, 2 : F_ERB + 2])


def _apply_mask(W, m, spec):
    """ERB band split of the mask m (2,129,B), then the complex ratio mask on
    spec (2,257,B)."""
    re, im = spec[0], spec[1]
    m_r, m_i = (torch.cat([m[ch, :65], _cdot(W["bs_w"], m[ch, 65:])])
                for ch in range(2))
    return torch.stack([re * m_r - im * m_i, im * m_r + re * m_i])


def forward_plain(W: dict, spec: torch.Tensor, taps: dict):
    """The whole forward: spec (2,257,B) + taps {ring: (x_{t-2d}, x_{t-d})}
    -> (out (2,257,B), {ring: new frame}).  All float32."""
    frames = {}
    x = _sfe(W, _erb_features(W, spec))
    skips = []
    for name in ("en0", "en1"):
        x = _conv5_stride2(x, W[name]["w"], W[name]["b"], W[name]["a"])
        skips.append(x)  # (16, 65, B), (16, 33, B)
    for i, name in enumerate(("en2", "en3", "en4")):
        x, frames[f"enc{i}_dw"], frames[f"enc{i}_tra"] = _gtconv(
            x, W[name], taps[f"enc{i}_dw"], taps[f"enc{i}_tra"], False)
        skips.append(x)

    for s, stack in enumerate(("gtcn1", "gtcn2")):
        for j in range(4):
            x, frames[f"tcn{s}{j}"] = _tcn(x, W[f"{stack}b{j}"], taps[f"tcn{s}{j}"])

    # decoder with additive skips: skips[4-i] for de0-de2, then [1] and [0]
    for i, name in enumerate(("de0", "de1", "de2")):
        x, frames[f"dec{i}_dw"], frames[f"dec{i}_tra"] = _gtconv(
            x + skips[4 - i], W[name], taps[f"dec{i}_dw"], taps[f"dec{i}_tra"], True)
    x = _prelu(_deconv5_up2(x + skips[1], W["de3"]["w"], W["de3"]["b"]),
               W["de3"]["a"])  # (16, 65, B)
    m = torch.tanh(_deconv5_up2(x + skips[0], W["de4"]["w"], W["de4"]["b"]))

    return _apply_mask(W, m, spec), frames


# ---------------------------------------------------------------------------
# serving models (step protocol: step(state, spec) -> (out, state))
# ---------------------------------------------------------------------------


def _slots(t: int, L: int, d: int) -> tuple[int, int]:
    """Ring slots of the taps x_{t-2d} and x_{t-d}; the new frame goes to
    the first of them."""
    return t % L, (t + d) % L


def _check_spec(spec: torch.Tensor) -> int:
    if spec.dim() != 4 or spec.shape[1] != F_FULL or spec.shape[2:] != (1, 2):
        raise ValueError(f"spec must be (B, {F_FULL}, 1, 2), got {tuple(spec.shape)}")
    return spec.shape[0]


class LayoutGTCRNMicro:
    """Serving model whose step is the plain PyTorch version of the fused
    kernels, on any device.  The layout of the JAX package's
    ``LayoutGTCRNMicro`` ((C, F, B), batch innermost); unlike it, this one
    computes in float32 whatever the storage dtype, as the kernels do."""

    batch_axis = -1  # rings are (L, *frame, B)
    chunk_sizes = (1,)

    def __init__(self, params, dtype=torch.float32, device=None):
        self.config = GTCRNMicroConfig()
        self.dtype = dtype
        self.device = resolve_device(device)
        self.weights = pack_weights(params, dtype, self.device)
        self._W = unpack(self.weights)

    def init_state(self, batch: int, dtype=None) -> dict:
        dtype = dtype or self.dtype
        state = {name: torch.zeros((L,) + shape + (batch,), dtype=dtype,
                                   device=self.device)
                 for name, L, _d, shape in RING_DEFS}
        state["step"] = 0
        return state

    def step(self, state: dict, spec: torch.Tensor):
        """spec (B, 257, 1, 2) -> (enhanced, same shape, in the model dtype;
        state).  The rings are updated in place."""
        _check_spec(spec)
        t = state["step"]
        spec_t = spec[:, :, 0, :].permute(2, 1, 0).float()  # (2, 257, B)
        taps = {}
        for name, L, d, _shape in RING_DEFS:
            s0, s1 = _slots(t, L, d)
            taps[name] = (state[name][s0].float(), state[name][s1].float())
        out, frames = forward_plain(self._W, spec_t, taps)
        for name, L, d, _shape in RING_DEFS:
            state[name][_slots(t, L, d)[0]].copy_(frames[name])
        state["step"] = (t + 1) & 15
        return out.permute(2, 1, 0)[:, :, None, :].to(self.dtype), state


class FusedGTCRNMicro(LayoutGTCRNMicro):
    """Serving model: the whole per-frame forward as kernel B1 on CUDA
    tensors (the plain version on CPU tensors).  ``launches`` counts kernel
    launches."""

    def __init__(self, params, dtype=torch.float32, device=None):
        super().__init__(params, dtype, device)
        self.kernel_weights = kernel_weights(self.weights)
        self.launches = 0

    def step(self, state: dict, spec: torch.Tensor):
        if spec.device.type == "cpu":
            return super().step(state, spec)
        if spec.device.type != "cuda":
            raise ValueError(f"no kernel for device {spec.device}")
        B = _check_spec(spec)
        spec = spec.to(self.dtype).contiguous()
        rings = [_build.check_ring(state[name], name, (L,) + shape + (B,), spec)
                 for name, L, _d, shape in RING_DEFS]
        out = torch.empty_like(spec)
        self._launch(spec, out, rings, state["step"])
        state["step"] = (state["step"] + 1) & 15
        return out, state

    def _launch(self, spec, out, rings, t):
        """B1: pass the two tap frames of each ring; each new frame goes to
        the slot of its ring's tap 0 (t mod L), which the kernel writes only
        after its last read of that tap, so the rings update in place."""
        taps = []
        for ring, (_name, L, d, _shape) in zip(rings, RING_DEFS):
            s0, s1 = _slots(t, L, d)
            taps += [ring[s0], ring[s1]]
        _build.launch_b1(self.kernel_weights, spec, out, taps, taps[0::2])
        self.launches += 1
