"""TF-Locoformer's FFN sub-layer, ``x + FFN(RMSGroupNorm(x))``, as one CUDA
kernel (``csrc/loco_ffn.cu``): the norm, the conv1d as an implicit-window
GEMM, SwiGLU, the transposed conv1d as four shifted GEMMs, the bias, the
residual and the mask past each sequence's frames, in one pass on tensor
cores at three TF32 products a float32 product, intermediates on chip.

:func:`takes` is the routing rule, a pure function of the device, dtype,
grad mode and widths: the kernel serves CUDA float32 with grad off at 128
channels in 4 norm groups, 384 hidden units and a kernel of 4 at stride 1,
over a contiguous (N, S, 128) input.  ``nn/blocks.LocoformerBlock`` calls
:func:`run` where :func:`routes` holds and keeps its layered path (the CPU,
training, other widths) everywhere else.  There is no fallback: a CUDA
tensor routed here launches the kernel or raises.
"""

from __future__ import annotations

import torch

from gtcrn_micro_tpu_torch.ops import _build

CHANNELS = 128  # C in csrc/loco_ffn.cu
HIDDEN = 384  # HID
KERNEL = 4  # TAPS
GROUPS = 4  # the norm's groups: 32 channels each, one group to 8 lanes
CHUNK = 32  # HC: hidden units a chunk
DEPTH1, DEPTH2 = 64, 32  # KD1, KD2: depth of a conv1d and of a transposed-conv stage


def takes(device: torch.device, dtype: torch.dtype, grad: bool, channels: int, hidden: int,
          kernel: int, stride: int, groups: int, contiguous: bool) -> bool:
    """Whether the kernel serves an FFN sub-layer of this device, dtype, grad
    mode and widths: CUDA, float32, grad off, 128 channels in 4 norm groups,
    384 hidden units, a conv of kernel 4 at stride 1, a contiguous input."""
    return (device.type == "cuda" and dtype == torch.float32 and not grad
            and channels == CHANNELS and hidden == HIDDEN and kernel == KERNEL and stride == 1
            and groups == GROUPS and contiguous)


def routes(x: torch.Tensor, norm, ffn) -> bool:
    """:func:`takes` for x (N, S, C) as it comes, grad mode as it stands,
    ``norm`` an ``RMSGroupNorm`` and ``ffn`` a ``ConvSwiGLU``."""
    conv = ffn.conv1d
    return (x.dim() == 3 and x.shape[0] * x.shape[1] > 0
            and takes(x.device, x.dtype, torch.is_grad_enabled(), x.shape[2],
                      conv.out_channels // 2, conv.kernel_size[0], conv.stride[0], norm.groups,
                      x.is_contiguous()))


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest,
    ties away from zero; the 13 low bits zero)."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tile(w: torch.Tensor, depth: int, cols: torch.Tensor, steps: int) -> torch.Tensor:
    """A stage's B, w[depth + d, cols[n]] for its ``steps`` 8-deep steps and
    its len(cols) columns, as the kernel's wgmma reads it, then split: a hi
    and a lo tile, each of 8-row x 16-byte core matrices [step][half][n / 8]
    [n % 8][4], K-major; core matrix (step kk, half h) holds depths
    kk 8 + 2 i + h for i in 0..3 (logical k = h 4 + i)."""
    kk, h, ng, r, i = torch.meshgrid(
        *(torch.arange(m, device=w.device) for m in (steps, 2, len(cols) // 8, 8, 4)),
        indexing="ij")
    v = w[depth + kk * 8 + 2 * i + h, cols[ng * 8 + r]]
    hi = _tf32(v)
    return torch.cat([hi.flatten(), _tf32(v - hi).flatten()])


def pack(conv1d_weight: torch.Tensor, deconv_weight: torch.Tensor) -> torch.Tensor:
    """The conv1d's (768, 128, 4) and the transposed conv's (384, 128, 4)
    weights -> (144, 8192) float32, the stages in the order the kernel reads
    them: for each of the 12 chunks of 32 hidden units, 8 conv1d stages
    (depth tap-major, 64 input channels a stage; columns the chunk's 32 u
    units, then its 32 g units 384 higher) then 4 transposed-conv stages (one
    a tap; depth the chunk's 32 units; columns the 128 output channels),
    each as :func:`_tile` lays it out."""
    dev = conv1d_weight.device
    w1 = conv1d_weight.detach().float().permute(2, 1, 0).reshape(KERNEL * CHANNELS, 2 * HIDDEN)
    w2 = deconv_weight.detach().float()  # (unit, channel, tap)
    channels = torch.arange(CHANNELS, device=dev)
    stages = []
    for c in range(HIDDEN // CHUNK):
        units = c * CHUNK + torch.arange(CHUNK, device=dev)
        cols = torch.cat([units, units + HIDDEN])
        stages += [_tile(w1, ks * DEPTH1, cols, DEPTH1 // 8)
                   for ks in range(KERNEL * CHANNELS // DEPTH1)]
        stages += [_tile(w2[c * CHUNK : (c + 1) * CHUNK, :, j], 0, channels, DEPTH2 // 8)
                   for j in range(KERNEL)]
    return torch.stack(stages)


def packed(ffn) -> torch.Tensor:
    """:func:`pack` of a ``ConvSwiGLU``'s weights, kept on the module until
    either weight changes (a new tensor or an in-place write)."""
    w1, w2 = ffn.conv1d.weight, ffn.deconv1d.weight
    key = (w1.data_ptr(), w1._version, w2.data_ptr(), w2._version)
    cached = getattr(ffn, "_kernel_pack", None)
    if cached is None or cached[0] != key:
        cached = (key, pack(w1, w2))
        ffn._kernel_pack = cached
    return cached[1]


def run(x: torch.Tensor, norm, ffn, frames=None) -> torch.Tensor:
    """x (N, S, 128) -> x + ffn(norm(x)), zero at positions s >= frames[n]
    where ``frames`` (N,) is given.  Raises on a wrong dtype, width, layout
    or device before any launch."""
    if x.dtype != torch.float32:
        raise ValueError(f"the FFN kernel takes float32, got {x.dtype}")
    if x.dim() != 3 or x.shape[2] != CHANNELS or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, S, {CHANNELS}) tensor, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    conv, deconv = ffn.conv1d, ffn.deconv1d
    if (tuple(conv.weight.shape) != (2 * HIDDEN, CHANNELS, KERNEL)
            or tuple(deconv.weight.shape) != (HIDDEN, CHANNELS, KERNEL)
            or conv.stride[0] != 1 or deconv.stride[0] != 1 or norm.groups != GROUPS):
        raise ValueError(f"want conv1d (768, 128, 4), deconv (384, 128, 4) at stride 1 and "
                         f"{GROUPS} norm groups")
    if frames is not None and (frames.dtype != torch.int64 or tuple(frames.shape) != x.shape[:1]):
        raise ValueError(f"frames must be ({x.shape[0]},) int64, got {tuple(frames.shape)} "
                         f"{frames.dtype}")
    params = (conv.bias, deconv.bias, norm.gamma)
    tensors = [x, conv.weight, deconv.weight, *params] + ([] if frames is None else [frames])
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"the FFN kernel takes CUDA tensors on one device, got x on {x.device}")
    if any(p.dtype != torch.float32 for p in tensors[1:6]):
        raise ValueError("the FFN kernel takes float32 weights")
    y = torch.empty_like(x)
    _build.launch_loco_ffn(x, packed(ffn), *(p.contiguous() for p in params),
                           None if frames is None else frames.contiguous(), y, norm.eps)
    return y
