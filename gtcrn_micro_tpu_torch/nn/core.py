"""Layer core of the layered GTCRN-Micro model: one definition for the offline,
streaming and training paths.

Counterpart of the JAX package's ``nn/core.py``.  The offline path and every
streaming mode run the same layer code; only the left context of a temporal
op differs:

- offline: zeros (the reference's causal left zero-padding);
- shift cache (``ring=False``): the last ``L`` input frames in time order;
- ring (``ring=True``, the serving path): the last ``L`` frames stored at
  slot ``t mod L`` of a ring indexed by a step counter ``t``; a step over a
  T-frame chunk reads T-frame slabs and writes one (T a power of two <= 16);
- ``l2_psum``: the ``L == 2`` convs carry their two partial OUTPUT frames
  instead of a 2-frame input ring.

Activations are ``(B, T, F, C)``, the JAX layout.  A convolution hands
``torch.nn.functional.conv2d`` the channels-last view ``(B, C, T, F)`` of the
same memory (no copy) and permutes the result back.  Weights keep the JAX
canonical layouts: convs HWIO ``(kT, kF, C_in/groups, C_out)``, transposed
convs as flipped-kernel plain convs over a zero-stuffed frequency axis,
pointwise ``(C_in, C_out)``.

Streaming states are flat dicts keyed by the JAX paths
(``encoder/en2/depth_conv/ring``); each layer knows its own path, set from
its place in the module tree (:func:`name_paths`), so no scope stack is
threaded through the calls.  A streaming step updates the state tensors in
place.

Quantization hooks (``ctx.quant``, see ``quant/ptq.py``): every conv and
matmul boundary calls ``quant.act(path, x)`` on its input and then
``quant.weight(path, w, channel_axis)`` on its weight, always in that order
(``FakeQuantizerV4`` pairs a weight with the act before it).  The paths are
the JAX package's scope names, which differ from the param names for the
pointwise layers (``pw1`` for ``point_conv1``, ``pw3`` for ``conv3``): each
layer's ``qpath`` comes from :func:`name_paths` with its ``quant_name``.
Offline the hook sees the time-padded input, so the padding zeros enter an
observed range as in JAX; a streaming step hooks the incoming chunk before
the cache stores it, so the cache holds quantized frames (fake-quant is
idempotent and 0 is on the grid).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as tF


@contextlib.contextmanager
def exact_f32():
    """Run float32 products and convolutions at full float32 precision:
    TF32 off for cuBLAS and cuDNN inside the block, the caller's flags
    restored after it (the JAX graph runs at ``Precision.HIGHEST``)."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = mm.allow_tf32, cudnn.allow_tf32
    mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved


class Ctx:
    """Per-call context threaded through the layer tree.

    - ``training``: BatchNorm uses batch statistics and records them in
      ``stats`` (path -> value);
    - ``state``: the streaming state (flat dict path -> tensor, updated in
      place), or None for the offline path;
    - ``initializing``: run as offline and record each streaming state
      entry's per-stream shape in ``new_state`` (``init_state`` builds the
      state from it);
    - ``ring``, ``step``, ``l2_psum``, ``store_dtype``: the streaming mode,
      as in the JAX package (``store_dtype`` only matters for
      ``init_state``: a step casts on read and on write to the state's own
      dtypes);
    - ``quant``: a quantization hook (``quant/ptq.py``: ``RangeObserver``,
      ``FakeQuantizer``), or None for the float path;
    - ``rank_mean``: data-parallel training (``parallel/mesh.RankMean``): a
      differentiable mean over the ranks, each holding an equal shard of the
      batch, with their count ``world``, so that the BatchNorm statistics
      are the global batch's; None on one process.
    """

    def __init__(self, *, training: bool = False, state: dict | None = None,
                 initializing: bool = False, ring: bool = False, step: int = 0,
                 l2_psum: bool = False, store_dtype: Any = None, quant: Any = None,
                 rank_mean: Any = None):
        self.training = training
        self.rank_mean = rank_mean
        self.state = state
        self.initializing = initializing
        self.ring = ring
        self.step = step
        self.l2_psum = l2_psum
        self.store_dtype = store_dtype
        self.quant = quant
        self.new_state: dict[str, tuple] = {}
        self.stats: dict[str, torch.Tensor] = {}

    @property
    def offline(self) -> bool:
        """Zero left context: the offline path, and the initializing run."""
        return self.state is None or self.initializing


class Layer(nn.Module):
    """A module that knows its path in the model tree (``encoder/en2/tra``),
    which prefixes its state and stats keys, and its quantization path
    ``qpath``, the same with its own name replaced by ``quant_name``."""

    path = ""
    qpath = ""
    quant_name: str | None = None

    def key(self, leaf: str) -> str:
        return f"{self.path}/{leaf}"

    def q_act(self, ctx: Ctx, leaf: str, x):
        return x if ctx.quant is None else ctx.quant.act(f"{self.qpath}/{leaf}", x)

    def q_weight(self, ctx: Ctx, leaf: str, w, channel_axis: int):
        if ctx.quant is None:
            return w
        return ctx.quant.weight(f"{self.qpath}/{leaf}", w, channel_axis)


def name_paths(root: nn.Module) -> None:
    """Give every :class:`Layer` under ``root`` its ``/``-joined path and
    quantization path."""
    for name, m in root.named_modules():
        if isinstance(m, Layer):
            m.path = name.replace(".", "/")
            parent, _, own = m.path.rpartition("/")
            own = m.quant_name or own
            m.qpath = f"{parent}/{own}" if parent else own


# ---------------------------------------------------------------------------
# Elementwise layers
# ---------------------------------------------------------------------------


class PReLU(nn.Module):
    """Single-scalar PReLU, ``max(x, 0) + a * min(x, 0)`` (torch nn.PReLU()
    with one parameter, initialised to 0.25)."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((), 0.25))

    def forward(self, x):
        return tF.prelu(x, self.alpha.reshape(1))


class BatchNorm(Layer):
    """Per-channel batchnorm over the last axis (torch BatchNorm2d
    semantics, eps 1e-5), written out rather than ``nn.BatchNorm2d``.

    Training normalises with the batch statistics, computed in float32 over
    every axis but the channel (biased variance), and records ``batch_mean``
    and the unbiased ``batch_var`` in ``ctx.stats``.  The running statistics
    are buffers that the forward never updates: a trainer folds the recorded
    batch statistics in, as the JAX trainer does.

    Under data parallelism (``ctx.rank_mean``) the statistics are the global
    batch's, as under JAX's sharded jit: the ranks' means are averaged, then
    the ranks' variances about that global mean, and the unbiased variance
    counts the global batch.  Each local mean is the one-process mean, so one
    rank gives the one-process numbers bit for bit.
    """

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, ctx: Ctx, x):
        if ctx.training:
            xf = x.float()
            dims = tuple(range(x.dim() - 1))
            sync = ctx.rank_mean or (lambda t: t)
            mean = sync(xf.mean(dims))
            var = sync((xf - mean).square().mean(dims))
            n = math.prod(x.shape[:-1]) * (ctx.rank_mean.world if ctx.rank_mean else 1)
            ctx.stats[self.key("batch_mean")] = mean.detach()
            ctx.stats[self.key("batch_var")] = (var * (n / max(n - 1, 1))).detach()
            mean, var = mean.to(x.dtype), var.to(x.dtype)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.gamma
        return (x - mean) * inv + self.beta


# ---------------------------------------------------------------------------
# Streaming left context, shared by the temporal convs and the TRA gate
# ---------------------------------------------------------------------------


def _window(ctx: Ctx, cache, x, d: int, taps: int):
    """The input of one streaming step of a causal op with ``taps`` past
    taps ``d`` frames apart, and the cache advanced past the chunk ``x``
    (B, T, ...) in place.  Returns ``(xin, dil)``: the op runs over ``xin``
    with time dilation ``dil``.

    Ring with ``d >= T``: tap ``j`` is the T-frame slab at ring slot
    ``(t + j d) mod L``, and ``xin = [slab_0 | ... | x]`` with dilation T;
    the chunk overwrites the oldest slab (slot ``t mod L``).  The step
    counter starts at 0 and advances by T, so every slab is T-aligned and
    never wraps.  Shift cache, or ring with ``d < T``: ``xin = [cache | x]``
    in time order with dilation d, and the cache keeps its last L frames.
    Rings stored narrower than ``x`` are cast on read and on write.
    """
    T, L = x.shape[1], cache.shape[1]
    if ctx.ring and d >= T:
        t = ctx.step
        slabs = [cache[:, (t + j * d) % L : (t + j * d) % L + T].to(x.dtype)
                 for j in range(taps)]
        xin = torch.cat(slabs + [x], dim=1)
        cache[:, t % L : t % L + T].copy_(x)
        return xin, T
    xin = torch.cat([cache.to(x.dtype), x], dim=1)
    cache.copy_(xin[:, xin.shape[1] - L :])
    return xin, d


def _psum(ctx: Ctx, layer: Layer, c0, c1, c2):
    """Direct-form-II-transposed step of a 3-tap, d = 1 causal op from its
    per-tap partials ``c_j`` (tap j applied to every frame of the chunk).
    The carried pair is ``psum_b = c1(x_{t-1}) + c0(x_{t-2})`` and
    ``psum_a = c0(x_{t-1})``, updated in place.  For T >= 2 the carried pair
    enters the first two frames and the chunk's own partials slide in."""
    a = ctx.state[layer.key("psum_a")]
    b = ctx.state[layer.key("psum_b")]
    T = c2.shape[1]
    if T == 1:
        out = c2 + b
        new_b = c1 + a
    else:
        shift1 = torch.cat([b, c1[:, : T - 1]], dim=1)
        shift0 = torch.cat([torch.zeros_like(a), a, c0[:, : T - 2]], dim=1)
        out = c2 + shift1 + shift0
        new_b = c1[:, T - 1 :] + c0[:, T - 2 : T - 1]
    b.copy_(new_b)
    a.copy_(c0[:, T - 1 :])
    return out


# ---------------------------------------------------------------------------
# The unified temporal/frequency conv
# ---------------------------------------------------------------------------


class CausalConv2d(Layer):
    """Causal-in-time 2-D conv over (B, T, F, C_in) -> (B, T, F', C_out).

    Plain, grouped and strided frequency convs (``freq_up = 1``), and
    transposed frequency convs (``freq_up > 1``: canonical flipped-kernel
    weights over the input with ``freq_up - 1`` zeros between frequency
    samples, padded by ``dil (kF - 1) - freq_pad`` on each side -- the
    geometry of the JAX ``lhs_dilation``).  Time is always causal: a left
    context of ``(kT - 1) dT`` frames, zeros offline and the cache when
    streaming, before one valid conv.
    """

    def __init__(self, c_in: int, c_out: int, kernel: tuple[int, int],
                 freq_stride: int = 1, freq_pad: int = 0,
                 dilation: tuple[int, int] = (1, 1), groups: int = 1,
                 bias: bool = True, freq_up: int = 1):
        super().__init__()
        self.kernel = kernel
        self.freq_stride = freq_stride
        self.freq_pad = freq_pad
        self.dilation = dilation
        self.groups = groups
        self.freq_up = freq_up
        kT, kF = kernel
        self.w = nn.Parameter(torch.zeros(kT, kF, c_in // groups, c_out))
        self.b = nn.Parameter(torch.zeros(c_out)) if bias else None

    @property
    def time_context(self) -> int:
        return (self.kernel[0] - 1) * self.dilation[0]

    def _conv(self, xin, w=None, time_dilation=None, bias=True):
        """The conv over a time window xin (B, T', F, C_in), HWIO ``w``."""
        w = self.w if w is None else w
        if self.freq_up > 1:
            B, T, F, C = xin.shape
            up = xin.new_zeros((B, T, (F - 1) * self.freq_up + 1, C))
            up[:, :, :: self.freq_up] = xin
            xin = up
            pad_f, stride_f = self.dilation[1] * (self.kernel[1] - 1) - self.freq_pad, 1
        else:
            pad_f, stride_f = self.freq_pad, self.freq_stride
        y = tF.conv2d(xin.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                      self.b if bias else None, stride=(1, stride_f),
                      padding=(0, pad_f),
                      dilation=(time_dilation or self.dilation[0], self.dilation[1]),
                      groups=self.groups)
        return y.permute(0, 2, 3, 1)

    def forward(self, ctx: Ctx, x):
        L = self.time_context
        if L == 0 or ctx.offline:
            xin = self.q_act(ctx, "in", tF.pad(x, (0, 0, 0, 0, L, 0)) if L else x)
        else:  # the chunk is quantized before the cache stores it
            x = self.q_act(ctx, "in", x)
        w = self.q_weight(ctx, "w", self.w, 3)
        if L == 0:
            return self._conv(xin, w)
        kT, d = self.kernel[0], self.dilation[0]
        psum = ctx.ring and ctx.l2_psum and kT == 3 and d == 1
        if ctx.initializing:
            B, _, F, C = x.shape
            if psum:  # the partial-output pair has the shape of one output frame
                shape = self._conv(x[:, :1], self.w[0:1], bias=False).shape[1:]
                ctx.new_state[self.key("psum_b")] = ctx.new_state[self.key("psum_a")] = shape
            else:
                ctx.new_state[self.key("ring" if ctx.ring else "cache")] = (L, F, C)
        if ctx.offline:
            return self._conv(xin, w)
        if psum:
            c0, c1, c2 = (self._conv(x, w[j : j + 1], bias=False) for j in range(3))
            out = _psum(ctx, self, c0, c1, c2)
            return out if self.b is None else out + self.b
        cache = ctx.state[self.key("ring" if ctx.ring else "cache")]
        xin, dil = _window(ctx, cache, x, d, kT - 1)
        return self._conv(xin, w, time_dilation=dil)


class Pointwise(Layer):
    """1x1 conv over channels, ``x @ W + b`` on (B, T, F, C).  ``quant_name``
    is the JAX scope name of the layer (``pw1``), its quantization path."""

    def __init__(self, c_in: int, c_out: int, quant_name: str | None = None):
        super().__init__()
        self.quant_name = quant_name
        self.w = nn.Parameter(torch.zeros(c_in, c_out))
        self.b = nn.Parameter(torch.zeros(c_out))

    def forward(self, ctx: Ctx, x):
        x = self.q_act(ctx, "in", x)
        w = self.q_weight(ctx, "w", self.w, 1)
        return tF.linear(x, w.t(), self.b)


class TRALite(Layer):
    """Frame-energy gate (reference gtcrn_micro.py:94-139): energy
    ``e = mean(x * x)`` over frequency -> causal depthwise conv1d (k = 3,
    context L = 2) -> pointwise -> sigmoid -> ``x * g``.  The streaming state
    holds energy frames ``(B, 2, C)``, or the partial-output pair under
    ``l2_psum``."""

    def __init__(self, channels: int, kernel: int = 3):
        super().__init__()
        self.kernel = kernel
        self.depth_w = nn.Parameter(torch.zeros(kernel, channels))
        self.depth_b = nn.Parameter(torch.zeros(channels))
        self.point_w = nn.Parameter(torch.zeros(channels, channels))
        self.point_b = nn.Parameter(torch.zeros(channels))

    def forward(self, ctx: Ctx, x):
        """x: (B, T, F, C) -> gated x, same shape."""
        e = (x * x).mean(dim=2)  # (B, T, C)
        k, L, T = self.kernel, self.kernel - 1, e.shape[1]
        psum = ctx.ring and ctx.l2_psum
        if ctx.initializing:
            if psum:
                ctx.new_state[self.key("psum_b")] = ctx.new_state[self.key("psum_a")] = (1, e.shape[2])
            else:
                ctx.new_state[self.key("ring" if ctx.ring else "cache")] = (L, e.shape[2])
        if ctx.offline:
            e_cat, dil = self.q_act(ctx, "energy", tF.pad(e, (0, 0, L, 0))), 1
        else:  # the energies are quantized before the cache stores them
            e = self.q_act(ctx, "energy", e)
        w = self.q_weight(ctx, "depth_w", self.depth_w, 1)
        if psum and not ctx.offline:
            y = self.depth_b + _psum(ctx, self, e * w[0], e * w[1], e * w[2])
        else:
            if not ctx.offline:
                cache = ctx.state[self.key("ring" if ctx.ring else "cache")]
                e_cat, dil = _window(ctx, cache, e, 1, L)
            y = self.depth_b
            for i in range(k):
                y = y + e_cat[:, i * dil : i * dil + T] * w[i]
        y = self.q_act(ctx, "gate_in", y)
        point_w = self.q_weight(ctx, "point_w", self.point_w, 1)
        g = torch.sigmoid(tF.linear(y, point_w.t(), self.point_b))
        return x * g[:, :, None, :]
