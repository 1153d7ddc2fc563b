"""GTCRN-Micro streaming speech enhancement on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of ``gtcrn_micro_tpu``: module names follow the JAX package
so each counterpart is easy to find, and the public functions keep the JAX
layouts (spectra ``(B, 257, T, 2)``, audio ``(B, 256*T)``).  The served
path -- online STFT, one fused per-frame network kernel, online iSTFT --
runs through :class:`gtcrn_micro_tpu_torch.serve.CohortServer`.

Every entry point takes ``device=``.  ``None`` means ``"cuda"``; a CUDA
request on a host without a GPU raises instead of silently running on the
CPU.  Pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gtcrn_micro_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev
