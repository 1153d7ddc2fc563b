"""Model complexity: the parameter count and the multiply-accumulates
(reference: ptflops, gtcrn_micro.py:539-544, published 19.01k parameters and
45.92 MMACs per second of audio, gtcrn_micro/README.md:25-26).

The JAX package counts MACs on the traced jaxpr; here a ``TorchFunctionMode``
counts them on the calls the forward makes: ``conv2d`` (output elements x
kernel taps x input channels per group, as JAX's ``_conv_macs``; the
transposed convs are convs over a zero-stuffed input, whose taps count as
JAX's lhs-dilated conv counts them), ``linear``, ``matmul``/``@`` and
``einsum`` (output elements x contracted size).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tF
from torch.overrides import TorchFunctionMode


def param_count(params: dict, trainable_only: bool = True) -> int:
    """Number of values in a nested param dict; ``trainable_only`` leaves
    out the frozen ERB filters and the BatchNorm running statistics."""
    total = 0

    def walk(node, path):
        nonlocal total
        for k, v in node.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                walk(v, p)
            elif not (trainable_only and ("erb" in p or "running" in p)):
                total += math.prod(v.shape)

    walk(params, "")
    return total


def _einsum_macs(eq: str, ops) -> int:
    """Product of every index's size over a two-operand contraction."""
    ins = eq.replace(" ", "").split("->")[0].split(",")
    sizes = {}
    for spec, t in zip(ins, ops):
        sizes.update(zip(spec, t.shape))
    return math.prod(sizes.values())


class _MacCounter(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is tF.conv2d:
            w = args[1] if len(args) > 1 else kwargs["weight"]
            self.total += out.numel() * math.prod(w.shape[1:])  # C_in/groups x kH x kW
        elif func is tF.linear:
            self.total += out.numel() * args[0].shape[-1]
        elif func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__):
            self.total += out.numel() * args[0].shape[-1]
        elif func is torch.einsum:
            eq, *ops = args
            ops = ops[0] if len(ops) == 1 and isinstance(ops[0], (list, tuple)) else ops
            self.total += _einsum_macs(eq, ops)
        return out


def macs(fn, *example_args) -> int:
    """Total multiply-accumulates of ``fn(*example_args)``, counted on the
    contractions it calls (it runs ``fn`` once, without gradients)."""
    counter = _MacCounter()
    with torch.no_grad(), counter:
        fn(*example_args)
    return counter.total


def model_complexity(model, seconds: float = 1.0, fs: int = 16000) -> tuple[int, int]:
    """(params, MACs per ``seconds`` of audio) of a ``GTCRNMicro`` on its
    device, ptflops-comparable: the offline forward over the frames of that
    much audio."""
    frames = int(seconds * fs) // model.config.hop_len + 1
    spec = torch.zeros((1, model.config.n_freqs, frames, 2), dtype=model.dtype,
                       device=model.device)
    return param_count(model.params()), macs(model.apply, spec)


def main(argv=None) -> tuple[int, int]:
    """``python -m gtcrn_micro_tpu_torch.utils.complexity [--device cpu]``:
    the full-width model's parameters and MACs per second of audio against
    the published figures.  The MAC count leaves out JAX's one-hot channel
    shuffle (3,193,344 MACs), which this port interleaves by a copy."""
    import argparse

    from gtcrn_micro_tpu_torch import resolve_device
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, init_params

    parser = argparse.ArgumentParser(description="parameters and MACs per second of audio")
    parser.add_argument("--device", default=None, help="default: cuda")
    ns = parser.parse_args(argv)
    dev = resolve_device(ns.device)
    model = GTCRNMicro.from_params(init_params(torch.Generator().manual_seed(0), device=dev),
                                   device=dev)
    n_params, n_macs = model_complexity(model)
    print(f"params: {n_params / 1e3:.2f} k (published 19.01 k)")
    print(f"MACs/s audio: {n_macs / 1e6:.2f} M (published 45.92 M)")
    return n_params, n_macs


if __name__ == "__main__":
    main()
