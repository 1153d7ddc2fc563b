"""Full-integer int8 serving step: int8 ring state and int8 x int8 -> int32
channel mixes.

Counterpart of the JAX package's ``ops/int8_step.py`` (an XLA program there,
not a Pallas kernel).  The main-chain rings are stored as int8, half the
bytes of bf16, and every channel mix is an int8 x int8 -> int32 product with
the zero-point correction, dequantization and bias in its epilogue:
``(acc - z colsum) (s_in s_w) + b``.  The quantization is that of
``quant.ptq.FakeQuantizer`` on BN-folded params (per-out-channel symmetric
int8 weights, per-tensor asymmetric int8 activations at the 59 calibrated
boundaries), so the step agrees with the fake-quant ``step`` to float
association.  Values the simulation keeps in float stay float here: the
GTConv passive halves, the skips (carried in ``carry_dtype``), the TRA gate
(float fake-quant, its weight params computed once at construction) and the
ERB/mask head.

The products: on a CUDA tensor each contraction is ``torch._int_mm`` on
``(B F, K) x (K, N)``, which needs ``B F > 16`` and ``K``, ``N`` multiples
of 8, so the weights are zero-padded to that at construction (en0's ``K =
15``, de4's ``N = 2``, the TRA-free 8-channel halves) and an activation's
``K`` with it; a shape the card refuses raises, nothing falls back.  On a
CPU tensor the plain version is an int32 matmul of the same padded
operands.  Both are exact integers, so the accumulators agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.nn.core import exact_f32

F_FULL, F_ERB, F_65, F_33, C, H = 257, 129, 65, 33, 16, 8

_GT_NAMES = ("en2", "en3", "en4", "de0", "de1", "de2")
_TCN_DIL = (1, 2, 4, 8, 1, 2, 4, 8)


def _wq(w: np.ndarray, axis: int):
    """Per-out-channel symmetric int8 (bit-matching ``quant.weight_qparams``)."""
    w = np.asarray(w, np.float32)
    red = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.abs(w).max(axis=red)
    scale = np.maximum((amax / np.float32(127.0)).astype(np.float32), np.float32(1e-12))
    shape = [1] * w.ndim
    shape[axis] = w.shape[axis]
    q = np.clip(np.rint(w / scale.reshape(shape)), -128, 127).astype(np.int8)
    return q, scale


def _fq_np(x: np.ndarray, scale, zero, qmin: int, qmax: int) -> np.ndarray:
    """Float32 fake-quant in numpy (the simulation's arithmetic)."""
    q = np.clip(np.round(x / scale) + zero, qmin, qmax).astype(np.float32)
    return ((q - zero) * scale).astype(np.float32)


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 ``a`` (M, K) x int8 ``w`` (K, N) -> int32 (M, N): ``torch._int_mm``
    on a CUDA tensor (which raises on a shape it refuses), an int32 matmul on
    a CPU tensor."""
    if a.is_cuda:
        return torch._int_mm(a, w)
    return a.to(torch.int32) @ w.to(torch.int32)


class _Act:
    """One boundary's activation params: host float32 scale and integer zero
    point, and the scale and zero as float32 tensors on the device (a CUDA
    division by a host scalar multiplies by its reciprocal instead)."""

    def __init__(self, qp, dev):
        if int(qp.qmax) != 127:
            raise ValueError("int8 serving needs act_bits=8 qparams")
        self.scale = np.float32(_np(qp.scale).reshape(()))
        self.zero = int(_np(qp.zero).reshape(()))
        self.s = torch.tensor(self.scale, device=dev)
        self.z = torch.tensor(float(self.zero), device=dev)

    def quant(self, x: torch.Tensor) -> torch.Tensor:
        """f32 -> int8 on this grid: divide, round half to even, add zero."""
        return torch.clamp(torch.round(x / self.s) + self.z, -128, 127).to(torch.int8)

    def pad_f(self, q: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """Pad the frequency axis of (B, F, C) with the zero point."""
        return tF.pad(q, (0, 0, lo, hi), value=self.zero)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class Int8Serving:
    """Prepared int8 serving program: :meth:`init_state` and :meth:`step`.

    Built from float params (a nested dict of tensors or arrays; BatchNorm is
    folded here) and calibrated act_bits=8 activation params
    (``quant.ptq.observe_ranges`` / ``quant.qat.calibrate_act_qparams``), on
    ``device`` (None: CUDA).  The state is a flat dict of 20 int8 rings keyed
    by their boundary paths, filled with each boundary's zero point, and the
    integer ``step`` counter; :meth:`step` updates it in place.
    """

    def __init__(self, params: dict, act_qp: dict, carry_dtype=torch.bfloat16, device=None):
        from gtcrn_micro_tpu_torch.models.folding import fold_bn_params
        from gtcrn_micro_tpu_torch.models.gtcrn_micro import flatten, nest

        self.device = dev = resolve_device(device)
        self.carry_dtype = carry_dtype
        self.A = {k: _Act(v, dev) for k, v in act_qp.items()}
        flat = {k: torch.from_numpy(np.array(_np(v), np.float32)) for k, v in flatten(params).items()}
        p = fold_bn_params(nest(flat))

        def t(v, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(v), device=dev, dtype=dtype)

        def mix(q: np.ndarray, s: np.ndarray, a: _Act, b=None) -> dict:
            """An int8 (K, N) product's weights, zero-padded to multiples of 8,
            its column sums ``cs`` and zero-point correction ``z cs`` (int32),
            and ``s_in * s_w`` (float32)."""
            k, n = q.shape
            qp = np.zeros((_pad8(k), _pad8(n)), np.int8)
            qp[:k, :n] = q
            cs = q.astype(np.int32).sum(axis=0)
            return dict(w=t(qp), cs=t(cs), zcs=t(np.int32(a.zero) * cs), n=n,
                        sc=t(np.float32(a.scale) * s), b=None if b is None else t(_np(b)))

        W: dict = {}
        W["bm"] = t(_np(p["erb"]["bm_w"]), torch.float32)  # (192, 64)
        W["bs"] = t(_np(p["erb"]["bs_w"]), torch.float32)  # (64, 192)
        # sfe: HWIO (1, 3, 1, 3) depthwise -> (3, c) int32 rows, no bias
        q, s = _wq(_np(p["sfe"]["depth_conv"]["w"]), 3)
        a = self.A["sfe/depth_conv/in"]
        W["sfe"] = dict(w=t(q[0, :, 0, :], torch.int32), sc=t(np.float32(a.scale) * s))

        for name in ("en0", "en1"):
            blk = p["encoder"][name]
            q, s = _wq(_np(blk["conv"]["w"]), 3)  # HWIO (1, 5, Ci, Co)
            W[name] = mix(q[0].reshape(5 * q.shape[2], -1), s, self.A[f"encoder/{name}/conv/in"],
                          blk["conv"]["b"])
            W[name]["a"] = t(_np(blk["act"]["alpha"]).reshape(1))

        for name in _GT_NAMES:
            side = "encoder" if name.startswith("en") else "decoder"
            root = p[side][name]
            A = {k: self.A[f"{side}/{name}/{k}"] for k in ("pw1/in", "depth_conv/in", "pw2/in")}
            g: dict = {}
            q, s = _wq(_np(root["point_conv1"]["w"]), 1)
            g["pw1"] = mix(q, s, A["pw1/in"], root["point_conv1"]["b"])
            g["pw1"]["a"] = t(_np(root["point_act"]["alpha"]).reshape(1))
            dw = _np(root["depth_conv"]["w"])  # HWIO (3, 3, Ci/g, 16)
            q, s = _wq(dw, 3)
            sc = t(np.float32(A["depth_conv/in"].scale) * s)
            if dw.shape[2] == 1:  # encoder depthwise -> (kt, kf, C) int32
                g["dw"] = dict(w=t(q[:, :, 0, :], torch.int32), sc=sc, full=False)
            else:  # decoder full conv -> per time tap an int8 (3 Ci, Co) product
                g["dw"] = dict(taps=[mix(q[kt].reshape(3 * C, C), s, A["depth_conv/in"])
                                     for kt in range(3)], sc=sc, full=True)
            g["dw"]["b"] = t(_np(root["depth_conv"]["b"]))
            g["dw"]["a"] = t(_np(root["depth_act"]["alpha"]).reshape(1))
            q, s = _wq(_np(root["point_conv2"]["w"]), 1)
            g["pw2"] = mix(q, s, A["pw2/in"], root["point_conv2"]["b"])
            # the TRA gate: float fake-quant, weight params fixed at construction
            tra = {k: _np(v).astype(np.float32) for k, v in root["tra"].items()}
            ez, gq = act_qp[f"{side}/{name}/tra/energy"], act_qp[f"{side}/{name}/tra/gate_in"]
            g["tra"] = dict(
                depth_w=t(_fq_np(tra["depth_w"], *_wq(tra["depth_w"], 1)[1:], 0, -128, 127)),
                point_w=t(_fq_np(tra["point_w"], *_wq(tra["point_w"], 1)[1:], 0, -128, 127)),
                depth_b=t(tra["depth_b"]), point_b=t(tra["point_b"]),
                e_s=t(_np(ez.scale).astype(np.float32)), e_z=t(_np(ez.zero).astype(np.float32)),
                g_s=t(_np(gq.scale).astype(np.float32)), g_z=t(_np(gq.zero).astype(np.float32)),
                g_min=int(gq.qmin), g_max=int(gq.qmax))
            W[name] = g

        for i in range(8):
            stack, j = ("gtcn1", "gtcn2")[i // 4], i % 4
            blk = p[stack][f"block{j}"]
            tc: dict = {}
            for key, conv, act in (("pw1", "conv1", "act1"), ("pw3", "conv3", "act3")):
                q, s = _wq(_np(blk[conv]["w"]), 1)
                tc[key] = mix(q, s, self.A[f"{stack}/block{j}/{key}/in"], blk[conv]["b"])
                tc[key]["a"] = t(_np(blk[act]["alpha"]).reshape(1))
            q, s = _wq(_np(blk["conv2"]["w"]), 3)  # HWIO (3, 1, 1, 16)
            tc["dw"] = dict(w=t(q[:, 0, 0, :], torch.int32),
                            sc=t(np.float32(self.A[f"{stack}/block{j}/conv2/in"].scale) * s),
                            b=t(_np(blk["conv2"]["b"])), a=t(_np(blk["act2"]["alpha"]).reshape(1)))
            W[f"{stack}b{j}"] = tc

        for name in ("de3", "de4"):
            blk = p["decoder"][name]
            q, s = _wq(_np(blk["conv"]["w"]), 3)  # canonical HWIO (1, 5, Ci, Co)
            a = self.A[f"decoder/{name}/conv/in"]
            W[name] = dict(even=mix(np.concatenate([q[0, k] for k in (0, 2, 4)], 0), s, a,
                                    blk["conv"]["b"]),
                           odd=mix(np.concatenate([q[0, k] for k in (1, 3)], 0), s, a,
                                   blk["conv"]["b"]))
            if name == "de3":
                W[name]["a"] = t(_np(blk["act"]["alpha"]).reshape(1))
        self.W = W

    # -- the integer building blocks -----------------------------------------

    @staticmethod
    def _mm(q: torch.Tensor, m: dict) -> torch.Tensor:
        """int8 (B, F, K) x the padded (K', N') weights -> int32 (B, F, N)."""
        B, F, K = q.shape
        w = m["w"]
        if K < w.shape[0]:
            q = tF.pad(q, (0, w.shape[0] - K))
        acc = int_matmul(q.reshape(B * F, w.shape[0]), w)
        return acc[:, : m["n"]].reshape(B, F, m["n"])

    def _mix(self, q: torch.Tensor, m: dict) -> torch.Tensor:
        """The product with its epilogue ``(acc - z colsum) s_in s_w + b``."""
        return (self._mm(q, m) - m["zcs"]).float() * m["sc"] + m["b"]

    def _conv5_s2(self, q, a: _Act, m: dict, f_out: int):
        """(1, 5) stride-2 frequency conv as im2col and one int8 product; the
        zero-point padding cancels in the epilogue's ``z colsum``."""
        qp = a.pad_f(q, 2, 2)
        taps = torch.cat([qp[:, k : k + 2 * f_out : 2] for k in range(5)], dim=-1)
        return self._mix(taps, m)

    def _deconv5_up2(self, q, a: _Act, w: dict):
        """(1, 5) transposed frequency conv, stride 2, split by output parity
        into two im2col products (even outputs: taps 0, 2, 4; odd: 1, 3),
        interleaved: (B, F, Ci) -> (B, 2F - 1, Co)."""
        B, F, _ = q.shape
        qp = a.pad_f(q, 1, 1)
        even = self._mix(torch.cat([qp[:, k : k + F] for k in range(3)], dim=-1), w["even"])
        odd = self._mix(torch.cat([qp[:, 1:F], qp[:, 2 : F + 1]], dim=-1), w["odd"])
        out = even.new_empty((B, 2 * F - 1, even.shape[-1]))
        out[:, 0::2] = even
        out[:, 1::2] = odd
        return out

    @staticmethod
    def _dw_freq3(q_taps, a: _Act, w: dict):
        """Encoder depthwise 3x3: per time tap a 3-tap frequency conv per
        channel, elementwise in int32."""
        acc = None
        for kt, q in enumerate(q_taps):
            qp = a.pad_f(q, 1, 1).to(torch.int32) - a.zero
            for kf in range(3):
                term = qp[:, kf : kf + F_33] * w["w"][kt, kf]
                acc = term if acc is None else acc + term
        return acc.float() * w["sc"] + w["b"]

    def _dw_full3(self, q_taps, a: _Act, w: dict):
        """Decoder full 3x3: per time tap an im2col int8 frequency product."""
        acc = None
        for q, m in zip(q_taps, w["taps"]):
            qp = a.pad_f(q, 1, 1)
            taps = torch.cat([qp[:, kf : kf + F_33] for kf in range(3)], dim=-1)
            term = self._mm(taps, m) - m["zcs"]
            acc = term if acc is None else acc + term
        return acc.float() * w["sc"] + w["b"]

    @staticmethod
    def _dw_time3(q_taps, a: _Act, w: dict):
        """TCN depthwise k = 3 time conv: elementwise integer taps."""
        acc = None
        for kt, q in enumerate(q_taps):
            term = (q.to(torch.int32) - a.zero) * w["w"][kt]
            acc = term if acc is None else acc + term
        return acc.float() * w["sc"] + w["b"]

    # -- state -------------------------------------------------------------

    def init_state(self, batch: int) -> dict:
        """20 int8 rings (6 GTConv ``depth_conv/in`` (B, 2, 33, 16), 6 TRA
        energy rings (B, 2, 8), 8 TCN ``conv2/in`` (B, 2d, 33, 16)) filled
        with their boundaries' zero points, and ``step`` 0."""
        st: dict = {"step": 0}

        def ring(path, shape, zkey=None):
            st[path] = torch.full((batch,) + shape, self.A[zkey or path].zero,
                                  dtype=torch.int8, device=self.device)

        for name in _GT_NAMES:
            side = "encoder" if name.startswith("en") else "decoder"
            ring(f"{side}/{name}/depth_conv/in", (2, F_33, C))
            ring(f"{side}/{name}/tra/ring", (2, H), f"{side}/{name}/tra/energy")
        for i in range(8):
            ring(f"{('gtcn1', 'gtcn2')[i // 4]}/block{i % 4}/conv2/in", (2 * _TCN_DIL[i], F_33, C))
        return st

    # -- blocks --------------------------------------------------------------

    def _gtconv(self, name: str, x, st, t: int):
        """x: (B, 33, 16) f32 -> the same.  Encoder or decoder GTConvBlock."""
        side = "encoder" if name.startswith("en") else "decoder"
        g = self.W[name]
        a_pw1 = self.A[f"{side}/{name}/pw1/in"]
        a_dw = self.A[f"{side}/{name}/depth_conv/in"]
        a_pw2 = self.A[f"{side}/{name}/pw2/in"]

        h = tF.prelu(self._mix(a_pw1.quant(x[..., :H]), g["pw1"]), g["pw1"]["a"])
        qh = a_dw.quant(h)
        ring = st[f"{side}/{name}/depth_conv/in"]
        t0, t1 = t % 2, (t + 1) % 2
        taps = [ring[:, t0], ring[:, t1], qh]
        if g["dw"]["full"]:
            y = self._dw_full3(taps, a_dw, g["dw"])
        else:
            y = self._dw_freq3(taps, a_dw, g["dw"])
        ring[:, t0] = qh  # after the taps are read
        y = tF.prelu(y, g["dw"]["a"])
        h3 = self._mix(a_pw2.quant(y), g["pw2"])

        # TRA gate: 8-wide vectors in the simulation's float arithmetic
        tra = g["tra"]
        ez = self.A[f"{side}/{name}/tra/energy"]
        e = (h3 * h3).mean(dim=1)  # (B, 8)
        e = (torch.clamp(torch.round(e / tra["e_s"]) + tra["e_z"], -128, 127) - tra["e_z"]) * tra["e_s"]
        ering = st[f"{side}/{name}/tra/ring"]
        e0 = (ering[:, t0].float() - tra["e_z"]) * tra["e_s"]
        e1 = (ering[:, t1].float() - tra["e_z"]) * tra["e_s"]
        ering[:, t0] = ez.quant(e)
        dw = tra["depth_w"]
        yg = tra["depth_b"] + e0 * dw[0] + e1 * dw[1] + e * dw[2]
        q = torch.clamp(torch.round(yg / tra["g_s"]) + tra["g_z"], tra["g_min"], tra["g_max"])
        yg = (q - tra["g_z"]) * tra["g_s"]
        gate = torch.sigmoid(yg @ tra["point_w"] + tra["point_b"])
        # channel shuffle: the gated half at even channels, the passive at odd
        return torch.stack([h3 * gate[:, None, :], x[..., H:]], dim=-1).flatten(-2)

    def _tcn(self, i: int, x, st, t: int):
        stack, j = ("gtcn1", "gtcn2")[i // 4], i % 4
        d = _TCN_DIL[i]
        L = 2 * d
        w = self.W[f"{stack}b{j}"]
        a1 = self.A[f"{stack}/block{j}/pw1/in"]
        ad = self.A[f"{stack}/block{j}/conv2/in"]
        a3 = self.A[f"{stack}/block{j}/pw3/in"]

        h = tF.prelu(self._mix(a1.quant(x), w["pw1"]), w["pw1"]["a"])
        qh = ad.quant(h)
        ring = st[f"{stack}/block{j}/conv2/in"]
        s0 = t % L
        y = self._dw_time3([ring[:, s0], ring[:, (t + d) % L], qh], ad, w["dw"])
        ring[:, s0] = qh
        y = tF.prelu(y, w["dw"]["a"])
        h3 = self._mix(a3.quant(y), w["pw3"])
        return tF.prelu(h3 + x, w["pw3"]["a"])

    # -- the step --------------------------------------------------------------

    def step(self, state: dict, spec: torch.Tensor):
        """spec (B, 257, 1, 2) -> (enhanced (B, 257, 1, 2), the same state,
        updated in place)."""
        with torch.no_grad(), exact_f32():
            out = self._forward(state, spec)
        state["step"] = (state["step"] + 1) & 15
        return out, state

    def _forward(self, state: dict, spec: torch.Tensor):
        t = state["step"]
        x = spec[:, :, 0, :].float()  # (B, 257, 2)
        real, imag = x[..., 0], x[..., 1]
        mag = torch.sqrt(real * real + imag * imag + 1e-12)
        chans = torch.stack([mag, real, imag], dim=-1)  # (B, 257, 3)
        erb = (chans[:, F_65:].transpose(1, 2) @ self.W["bm"]).transpose(1, 2)
        feat = torch.cat([chans[:, :F_65], erb], dim=1)  # (B, 129, 3)

        a_sfe = self.A["sfe/depth_conv/in"]
        qp = a_sfe.pad_f(a_sfe.quant(feat), 1, 1).to(torch.int32) - a_sfe.zero
        w3 = self.W["sfe"]["w"]
        acc = qp[:, 0:F_ERB] * w3[0] + qp[:, 1 : F_ERB + 1] * w3[1] + qp[:, 2 : F_ERB + 2] * w3[2]
        sfe = acc.float() * self.W["sfe"]["sc"]

        a0, a1 = self.A["encoder/en0/conv/in"], self.A["encoder/en1/conv/in"]
        en0, en1 = self.W["en0"], self.W["en1"]
        skip0 = tF.prelu(self._conv5_s2(a0.quant(sfe), a0, en0, F_65), en0["a"])
        skip1 = tF.prelu(self._conv5_s2(a1.quant(skip0), a1, en1, F_33), en1["a"])
        skip0 = skip0.to(self.carry_dtype)

        x = skip1
        skips = []
        for name in ("en2", "en3", "en4"):
            x = self._gtconv(name, x, state, t)
            skips.append(x.to(self.carry_dtype))
        for i in range(8):
            x = self._tcn(i, x, state, t)
        for i, name in enumerate(("de0", "de1", "de2")):
            x = self._gtconv(name, x + skips[2 - i].float(), state, t)
        x = x + skip1

        a3, a4 = self.A["decoder/de3/conv/in"], self.A["decoder/de4/conv/in"]
        x65 = tF.prelu(self._deconv5_up2(a3.quant(x), a3, self.W["de3"]), self.W["de3"]["a"])
        x65 = x65 + skip0.float()
        m = torch.tanh(self._deconv5_up2(a4.quant(x65), a4, self.W["de4"]))  # (B, 129, 2)

        m_hi = (m[:, F_65:].transpose(1, 2) @ self.W["bs"]).transpose(1, 2)
        m_full = torch.cat([m[:, :F_65], m_hi], dim=1)  # (B, 257, 2)
        m_r, m_i = m_full[..., 0], m_full[..., 1]
        out = torch.stack([real * m_r - imag * m_i, imag * m_r + real * m_i], dim=-1)
        return out[:, :, None, :].to(spec.dtype)
