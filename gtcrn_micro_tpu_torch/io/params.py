"""Bridges from the JAX package's params and serving states to this port.

- :func:`params_from_numpy`: a JAX params pytree given as nested numpy
  arrays (``jax.tree.map(np.asarray, params)``) -> the port's tensors.
- :func:`load_params_npz`: a flat ``.npz`` keyed by ``/``-joined paths.
- :func:`state_from_jax`: a JAX serving state (fused, layered or int8)
  -> the port's state.
- :func:`act_qp_from_jax`: JAX activation ``QParams`` -> the port's.
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


# numpy has no bfloat16 or float8: JAX hands them over as ml_dtypes arrays,
# which convert bit for bit through an integer view of the same width
_VIEWS = {"bfloat16": (np.int16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _tensor(a: np.ndarray, dev) -> torch.Tensor:
    """A numpy (or ml_dtypes) array -> a tensor of the same dtype and bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name in _VIEWS:
        view, dtype = _VIEWS[a.dtype.name]
        return torch.from_numpy(a.view(view).copy()).view(dtype).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def state_from_jax(state_np: dict, dtype=torch.float32, device=None) -> dict:
    """JAX serving state (numpy arrays) -> the port's state for the same
    stream history.

    - Layered ``GTCRNMicro`` or ``Int8Serving`` state (keys are
      ``/``-joined paths): the same dict, ``(B, L, F, C)`` caches, ``psum_*``
      pairs, narrow and int8 rings with their dtypes kept (``dtype`` is not
      used), ``step`` as an integer.
    - Fused state, ``{name: (L, *frame, B)}`` rings in ``dtype``:
      FusedGTCRNMicro rings are tile-major ``(L, n_tiles, *frame, tile)``;
      GridFusedGTCRNMicro rings are ``(L, *frame, B)`` with the frequency
      axis of the (16, 33) frames padded to 40; LayoutGTCRNMicro rings
      already have the port's layout.
    """
    dev = resolve_device(device)
    if any("/" in k for k in state_np):
        return {k: int(np.asarray(v)) if k == "step" else _tensor(np.asarray(v), dev)
                for k, v in state_np.items()}
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


def act_qp_from_jax(act_qp: dict, device=None) -> dict:
    """JAX activation params ``{path: QParams}`` (scale and zero as arrays,
    scalar or per-lane) -> the port's ``quant.fake_quant.QParams``, float32
    bit for bit."""
    from gtcrn_micro_tpu_torch.quant.fake_quant import QParams

    dev = resolve_device(device)
    return {path: QParams(_tensor(np.asarray(qp.scale, np.float32), dev),
                          _tensor(np.asarray(qp.zero, np.float32), dev),
                          int(qp.qmin), int(qp.qmax))
            for path, qp in act_qp.items()}
