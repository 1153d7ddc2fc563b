"""One LSTM layer over a whole sequence as one persistent CUDA kernel
(``csrc/lstm.cu``): both directions at once, each cluster of 8 CTAs walking
one direction of up to 80 rows with its slice of the weights resident in
shared memory, lengths read on the device.

:func:`takes` is the routing rule, a pure function of the device, dtype,
grad mode and shape: the kernel serves CUDA float32 with grad off at 192
hidden units when the rows fit one resident wave of its clusters (80 rows a
cluster, a cluster a direction).  ``nn/core.LSTM`` calls :func:`run` where
:func:`takes` holds and keeps its plain path (aten's loop, the gathers)
everywhere else.  There is no fallback: a CUDA tensor routed here launches
the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from gtcrn_micro_tpu_torch.ops import _build

HIDDEN = 192  # the kernel's one width (HID in csrc/lstm.cu)
CLUSTER = 8  # CTAs a cluster (CL)
ROWS = 80  # rows a cluster (ROWS)
CHUNK = 32  # input columns a staged chunk (KC); inputs a multiple of it
MAX_INPUT = 192  # IN_MAX


def takes(device: torch.device, dtype: torch.dtype, grad: bool, rows: int, input_size: int,
          hidden: int, directions: int, clusters: int) -> bool:
    """Whether the kernel serves an LSTM layer of this device, dtype, grad
    mode and shape, on a card that holds ``clusters`` of its clusters at
    once: CUDA, float32, grad off, 192 hidden units, inputs a multiple of 32
    up to 192, and ceil(rows / 80) groups a direction resident together."""
    return (device.type == "cuda" and dtype == torch.float32 and not grad
            and hidden == HIDDEN and 0 < input_size <= MAX_INPUT and input_size % CHUNK == 0
            and rows > 0 and -(-rows // ROWS) * directions <= clusters)


@functools.cache
def resident_clusters(device: torch.device) -> int:
    """Clusters of the kernel that ``device`` holds at once (builds it)."""
    return _build.lstm_clusters(device)


def routes(x: torch.Tensor, hidden: int, directions: int) -> bool:
    """:func:`takes` for x (N, S, I) as it comes, grad mode as it stands;
    the card's residency is asked (and the kernel built) only for a layer
    that meets every other condition."""
    args = (x.device, x.dtype, torch.is_grad_enabled(), x.shape[0], x.shape[2], hidden,
            directions)
    needed = directions * -(-x.shape[0] // ROWS)
    return takes(*args, needed) and takes(*args, resident_clusters(x.device))


def pack(weights: list, directions: int) -> tuple[torch.Tensor, torch.Tensor]:
    """torch's ``(w_ih, w_hh, b_ih, b_hh)`` of each direction -> w (D, 8, I +
    192, 96) and b (D, 8, 96): CTA q's slice of [W_ih | W_hh] input column
    by input column, its 24 units' i, f, g, o gates unit-major (column 4 u +
    gate), and b_ih + b_hh in the same order."""
    w, b = [], []
    for d in range(directions):
        w_ih, w_hh, b_ih, b_hh = weights[4 * d : 4 * d + 4]
        u = w_hh.shape[1] // CLUSTER
        wc = torch.cat([w_ih, w_hh], dim=1)  # (4 H, I + H), rows gate-major
        w.append(wc.view(4, CLUSTER, u, -1).permute(1, 3, 2, 0).reshape(CLUSTER, -1, 4 * u))
        b.append((b_ih + b_hh).view(4, CLUSTER, u).permute(1, 2, 0).reshape(CLUSTER, 4 * u))
    return torch.stack(w).contiguous(), torch.stack(b).contiguous()


def run(x: torch.Tensor, lengths, weights: list, directions: int) -> torch.Tensor:
    """x (N, S, I), lengths None or (N,) valid steps a row, weights torch's
    flat LSTM weights -> y (N, S, directions * 192): the forward direction
    then the backward one, each row's backward chain from its own last
    step, zero past each row's length.  Raises on a wrong dtype, layout or
    device before any launch."""
    if x.dtype != torch.float32 or any(w.dtype != torch.float32 for w in weights):
        raise ValueError(f"the LSTM kernel takes float32, got {x.dtype}")
    if lengths is not None and lengths.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"lengths must be integers, got {lengths.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, S, I) tensor, got {tuple(x.shape)} "
                         f"with strides {x.stride()}")
    N, S, I = x.shape
    if len(weights) != 4 * directions or tuple(weights[1].shape) != (4 * HIDDEN, HIDDEN) or (
            tuple(weights[0].shape) != (4 * HIDDEN, I)):
        raise ValueError(f"want {directions} direction(s) of (w_ih (768, {I}), w_hh (768, 192), "
                         f"b_ih, b_hh)")
    if not (0 < I <= MAX_INPUT and I % CHUNK == 0):
        raise ValueError(f"inputs must be a multiple of {CHUNK} up to {MAX_INPUT}, got {I}")
    if lengths is not None and tuple(lengths.shape) != (N,):
        raise ValueError(f"lengths must be ({N},), got {tuple(lengths.shape)}")
    tensors = [x, *weights] + ([] if lengths is None else [lengths])
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"the LSTM kernel takes CUDA tensors on one device, got x on {x.device}")
    if lengths is not None:
        lengths = lengths.to(torch.int64).contiguous()
    w, b = pack(weights, directions)
    y = torch.empty((N, S, directions * HIDDEN), dtype=x.dtype, device=x.device)
    _build.launch_lstm(x, lengths, w, b, y, directions)
    return y
