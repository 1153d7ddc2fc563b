"""Data parallelism: device meshes, batch sharding, process groups and the
cross-rank BatchNorm hook.

Counterpart of the JAX package's ``parallel/mesh.py``.  JAX runs one
controller over a ``jax.sharding.Mesh`` and lets XLA insert the collectives.
Here:

- a *mesh* is a list of ``torch.device`` (:func:`make_mesh`: the first n CUDA
  devices; any list works, ``[cpu, cpu]`` is a two-device mesh in tests);
- training runs one process per GPU (``torchrun``) in a
  ``torch.distributed`` group (:func:`init_distributed`: NCCL on CUDA, gloo
  on the CPU).  Each rank feeds its rows of the global batch
  (:func:`shard_batch_multiprocess`); the trainer averages the gradients
  with one all-reduce, and the BatchNorms take their statistics over the
  global batch through :class:`RankMean`, as XLA's sharded jit does.

Serving over a mesh (every cohort's streams split across the devices, with
no collectives) is ``serve.CohortServer(mesh=...)``.
"""

from __future__ import annotations

import hashlib
import os

import torch
import torch.distributed as dist

from gtcrn_micro_tpu_torch import resolve_device


def make_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The first ``n_devices`` CUDA devices (default: all)."""
    resolve_device(None)
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"asked for {n} devices, {count} present")
    return [torch.device("cuda", i) for i in range(n)]


def canonical(device) -> torch.device:
    """``device`` with its index: ``cuda`` means the current CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def _rows(x, n: int) -> int:
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not divide into {n} equal shards")
    return x.shape[0] // n


def shard_batch(mesh: list, batch):
    """Split every leaf of ``batch`` (tensors or numpy arrays, batch on dim 0)
    into ``len(mesh)`` equal contiguous pieces, piece ``i`` on ``mesh[i]``.
    Returns one tree per device; raises when a batch does not divide."""
    def piece(i, d):
        def take(x):
            per = _rows(x, len(mesh))
            return torch.as_tensor(x[i * per : (i + 1) * per]).to(d)
        return take

    return [_map(piece(i, d), batch) for i, d in enumerate(mesh)]


def replicate(mesh: list, tree) -> list:
    """One copy of ``tree`` per device (a device that already holds a leaf
    shares it)."""
    return [_map(lambda x: torch.as_tensor(x).to(d), tree) for d in mesh]


def shard_batch_multiprocess(batch, rank: int, world: int):
    """This rank's rows ``[r B/W, (r+1) B/W)`` of every leaf of a global
    batch that every rank holds whole (the JAX package's per-process rows,
    ``scripts/multiproc_dp.py``).  Raises when a batch does not divide."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")

    def take(x):
        per = _rows(x, world)
        return x[rank * per : (rank + 1) * per]

    return _map(take, batch)


def _digest(tensors: list) -> int:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return int.from_bytes(h.digest()[:7], "little")


def replicate_multiprocess(tree, group=None):
    """Broadcast every tensor leaf of ``tree`` from the group's first rank,
    in place, then check that every rank holds the same bytes (a digest of
    all leaves, compared by all-reduce).  Returns ``tree``."""
    leaves = _leaves(tree)
    if not leaves:
        return tree
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for t in leaves:
        dist.broadcast(t, src=src, group=group)
    d = _digest(leaves)
    both = torch.tensor([d, -d], dtype=torch.int64, device=leaves[0].device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    if int(both[0]) != d or -int(both[1]) != d:
        raise RuntimeError("the ranks hold different bytes after the broadcast")
    return tree


def init_distributed(device=None):
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``).
    ``device`` ``None`` or ``"cuda"``: NCCL on ``cuda:LOCAL_RANK``, which
    becomes the current device; ``"cpu"``: gloo.  Reuses a group that is
    already initialised.  Returns ``(rank, world, device, group)``."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"{missing} unset: start the processes with torchrun")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://", rank=rank, world_size=world)
    return rank, world, dev, dist.group.WORLD


class _RankSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum of
    every rank's output gradient (each rank's loss depends on every rank's
    input)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class RankMean:
    """The BatchNorm hook of data-parallel training (``nn.core.Ctx``'s
    ``rank_mean``): the mean over the ranks of ``group`` of a per-rank
    tensor, by a differentiable all-reduce whose backward sums the gradients
    over the ranks.  Every rank holds an equal shard, so the mean of the
    ranks' batch means is the global batch's mean; ``world`` scales the
    count of the unbiased variance."""

    def __init__(self, group=None):
        self.group = group if group is not None else dist.group.WORLD
        self.world = dist.get_world_size(self.group)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return _RankSum.apply(t, self.group) / self.world
