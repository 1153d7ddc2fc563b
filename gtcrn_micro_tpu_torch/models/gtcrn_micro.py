"""GTCRN-Micro configuration and parameter initialisation.

``init_params`` returns the same nested dict as the JAX package's
``GTCRNMicro().init``: 342 leaves, 44,938 floats, with the same paths, shapes
and distributions (torch-default kaiming-uniform convs, identity BatchNorm
statistics, PReLU 0.25, the frozen ERB filters).  Weights keep the JAX
canonical layouts: convs are HWIO ``(kT, kF, C_in/groups, C_out)`` with
transposed convs stored as flipped-kernel plain convs, pointwise weights are
``(C_in, C_out)``.  The numbers differ from JAX's for the same seed
(``torch.Generator`` is not ``jax.random``); tests hand both packages the
same numpy params instead.

The layered forward (``nn/core.py``, ``nn/blocks.py``) is not part of this
package yet; the served path runs the fused forward of ``ops/fused_step.py``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.dsp.erb import ErbBands


@dataclasses.dataclass(frozen=True)
class GTCRNMicroConfig:
    n_fft: int = 512
    hop_len: int = 256
    win_len: int = 512
    erb_subband_1: int = 65
    erb_subband_2: int = 64
    channels: int = 16

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) * bound


def _conv(gen, kT, kF, c_in, c_out, groups=1, bias=True):
    """torch Conv2d default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for w and b."""
    cin_g = c_in // groups
    bound = 1.0 / math.sqrt(kT * kF * cin_g)
    p = {"w": _uniform(gen, (kT, kF, cin_g, c_out), bound)}
    if bias:
        p["b"] = _uniform(gen, (c_out,), bound)
    return p


def _pointwise(gen, c_in, c_out):
    bound = 1.0 / math.sqrt(c_in)
    return {"w": _uniform(gen, (c_in, c_out), bound),
            "b": _uniform(gen, (c_out,), bound)}


def _bn(c):
    return {"gamma": torch.ones(c), "beta": torch.zeros(c),
            "running_mean": torch.zeros(c), "running_var": torch.ones(c)}


def _prelu():
    return {"alpha": torch.full((), 0.25)}


def _conv_block(gen, c_in, c_out, is_last=False):
    p = {"conv": _conv(gen, 1, 5, c_in, c_out), "bn": _bn(c_out)}
    if not is_last:
        p["act"] = _prelu()
    return p


def _gtconv_block(gen, deconv):
    c, half = 16, 8
    bound_d, bound_p = 1.0 / math.sqrt(3), 1.0 / math.sqrt(half)
    return {
        "point_conv1": _pointwise(gen, half, c),
        "point_bn1": _bn(c),
        "point_act": _prelu(),
        "depth_conv": _conv(gen, 3, 3, c, c, groups=1 if deconv else c),
        "depth_bn": _bn(c),
        "depth_act": _prelu(),
        "point_conv2": _pointwise(gen, c, half),
        "point_bn2": _bn(half),
        "tra": {
            "depth_w": _uniform(gen, (3, half), bound_d),
            "depth_b": _uniform(gen, (half,), bound_d),
            "point_w": _uniform(gen, (half, half), bound_p),
            "point_b": _uniform(gen, (half,), bound_p),
        },
    }


def _tcn_block(gen, c=16):
    return {
        "conv1": _pointwise(gen, c, c), "bn1": _bn(c), "act1": _prelu(),
        "conv2": _conv(gen, 3, 1, c, c, groups=c), "bn2": _bn(c), "act2": _prelu(),
        "conv3": _pointwise(gen, c, c), "bn3": _bn(c), "act3": _prelu(),
    }


def init_params(generator: torch.Generator | None = None, device=None,
                config: GTCRNMicroConfig = GTCRNMicroConfig()) -> dict:
    """Fresh GTCRN-Micro params (float32) drawn from ``generator`` on the CPU,
    then placed on ``device``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    c = config
    params = {
        "erb": ErbBands(c.erb_subband_1, c.erb_subband_2, c.n_fft).init_params("cpu"),
        "sfe": {"depth_conv": _conv(gen, 1, 3, 3, 3, groups=3, bias=False)},
        "encoder": {
            "en0": _conv_block(gen, 3, c.channels),
            "en1": _conv_block(gen, c.channels, c.channels),
            **{f"en{i}": _gtconv_block(gen, deconv=False) for i in (2, 3, 4)},
        },
        "gtcn1": {f"block{j}": _tcn_block(gen) for j in range(4)},
        "gtcn2": {f"block{j}": _tcn_block(gen) for j in range(4)},
        "decoder": {
            **{f"de{i}": _gtconv_block(gen, deconv=True) for i in (0, 1, 2)},
            "de3": _conv_block(gen, c.channels, c.channels),
            "de4": _conv_block(gen, c.channels, 2, is_last=True),
        },
    }
    return _to(params, dev)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
