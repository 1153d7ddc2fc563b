"""Bridges from the JAX package's params and serving states to this port.

- :func:`params_from_numpy`: a JAX params pytree given as nested numpy
  arrays (``jax.tree.map(np.asarray, params)``) -> the port's tensors.
- :func:`load_params_npz`: a flat ``.npz`` keyed by ``/``-joined paths.
- :func:`state_from_jax`: a JAX fused serving state -> the port's ring state.
"""

from __future__ import annotations

import numpy as np
import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.ops.fused_step import RING_DEFS


def params_from_numpy(tree, device=None) -> dict:
    """Nested dict of array-likes -> nested dict of float32 tensors."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)

    return conv(tree)


def load_params_npz(path: str, device=None) -> dict:
    """Read a flat ``.npz`` whose keys are ``/``-joined param paths."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return params_from_numpy(tree, device)


def state_from_jax(state_np: dict, dtype=torch.float32, device=None) -> dict:
    """JAX ``FusedGTCRNMicro`` / ``GridFusedGTCRNMicro`` / ``LayoutGTCRNMicro``
    state (numpy arrays) -> the port's ring state ``{name: (L, *frame, B)}``
    plus the integer ``step`` counter.

    - FusedGTCRNMicro rings are tile-major ``(L, n_tiles, *frame, tile)``;
    - GridFusedGTCRNMicro rings are ``(L, *frame, B)`` with the frequency
      axis of the (16, 33) frames padded to 40;
    - LayoutGTCRNMicro rings already have the port's layout.
    """
    dev = resolve_device(device)
    out = {"step": int(np.asarray(state_np["step"]))}
    for name, L, _d, shape in RING_DEFS:
        v = np.asarray(state_np[name])
        if v.ndim == len(shape) + 3:  # tile-major: (L, nt, *frame, tile)
            nt, tile = v.shape[1], v.shape[-1]
            v = np.moveaxis(v, 1, -2).reshape((L,) + shape + (nt * tile,))
        elif v.ndim != len(shape) + 2:
            raise ValueError(f"{name}: unexpected ring shape {v.shape}")
        v = v[(slice(None),) + tuple(slice(0, n) for n in shape)]  # drop pad
        v = np.ascontiguousarray(v.astype(np.float32))
        out[name] = torch.from_numpy(v).to(dev, dtype)
    return out
