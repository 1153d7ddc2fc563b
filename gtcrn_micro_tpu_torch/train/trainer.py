"""The training step: STFT -> forward -> loss -> backward -> clip -> Adam ->
BatchNorm running-statistics fold (the JAX package's ``train/trainer.py``).

The JAX step is a pure function ``(params, opt_state, noisy, clean) ->
(params, opt_state, loss)``.  Here the layered model holds the float32
master params (its ``nn.Parameter``s, the trainable set) and the frozen
leaves (its buffers: the ERB filters and the BatchNorm running statistics,
exactly the JAX ``param_labels`` "freeze" set); the optimizer holds the Adam
state; ``step(noisy, clean) -> loss`` updates both in place and leaves the
step's raw gradients in each parameter's ``.grad``.

Numerics kept from the JAX recipe (and where PyTorch's defaults differ):

- the whole step, backward included, runs with TF32 off (``exact_f32``):
  autograd runs the backward convolutions after a forward's own
  ``exact_f32`` block has closed, and cuDNN defaults to TF32;
- the analysis STFT uses plain Hann, the loss's iSTFT sqrt-Hann (loss.py);
- clipping is ``optax.clip_by_global_norm``: the gradients are left alone
  when their global norm is below ``max_norm`` and scaled by ``max_norm /
  norm`` otherwise, with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds
  1e-6); the norm covers the trainable leaves only;
- Adam is written out (b1 0.9, b2 0.999, eps 1e-8, the optax form
  ``mu_hat / (sqrt(nu_hat) + eps)``), and update ``k`` (``count`` = k before
  the update, starting at 0) uses ``warmup_cosine_lr(k)``, as
  ``optax.scale_by_learning_rate`` does: a fresh run's first update has a
  learning rate of 0 under warmup;
- ``compute_dtype=torch.bfloat16`` casts every param and buffer, the ERB
  filters included, and the noisy spectrum to bf16 inside the step, through
  ``torch.func.functional_call``; the gradients flow back through the cast to
  the float32 masters, and the loss, the STFTs, the Adam state and the
  BatchNorm statistics stay float32.  This is JAX's cast, not
  ``torch.autocast`` (which keeps elementwise ops in their input dtype).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.dsp.stft import hann_window, stft
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, flatten, nest
from gtcrn_micro_tpu_torch.nn.core import Ctx, exact_f32
from gtcrn_micro_tpu_torch.parallel.mesh import RankMean
from gtcrn_micro_tpu_torch.train.loss import HybridLossConfig, hybrid_loss
from gtcrn_micro_tpu_torch.train.scheduler import WarmupCosineConfig, warmup_cosine_lr

BN_MOMENTUM = 0.1  # torch BatchNorm2d default
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam's defaults


def _dequant_audio(x: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float32 in [-1, 1) on the device, identity for float
    input: bit-identical to converting on the host (``io/wav.read_wav``),
    since int16 is exact in float32 and the scale is a power of two."""
    if x.dtype == torch.int16:
        return x.float() * (1.0 / 32768.0)
    return x


def _to_device(x, dev: torch.device) -> torch.Tensor:
    """A host batch (numpy or tensor) on ``dev``; from pinned memory without
    waiting for the device, so the copy queues behind the previous step."""
    x = torch.as_tensor(x)
    if dev.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(dev, non_blocking=True)
    return x.to(dev)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    epochs: int = 400
    clip_grad_norm: float = 3.0
    save_checkpoint_interval: int = 1
    exp_path: str = "exp/gtcrn_micro"
    resume: bool = False
    samplerate: int = 16000
    n_fft: int = 512
    hop_len: int = 256
    win_len: int = 512
    log_every: int = 50
    # "fp32" (the reference's exact recipe) or "bf16" (bf16 forward and
    # backward on float32 masters, see make_train_step's compute_dtype)
    precision: str = "fp32"


def _check_model(model: GTCRNMicro, dev: torch.device) -> None:
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, not on {dev}")
    if model.dtype != torch.float32:
        raise ValueError(f"the model holds the float32 masters, not {model.dtype}")


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """``optax.clip_by_global_norm``: ``grads`` unchanged when their global
    norm is below ``max_norm``, else each scaled by ``max_norm / norm``; no
    epsilon, and no wait for the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    return torch._foreach_mul(grads, scale)


class Adam:
    """Clip by global norm, then Adam with the learning rate of
    ``warmup_cosine_lr(count)`` (``count`` before the update), over the
    model's parameters; updates them in place from their ``.grad``.

    The state is ``count`` and the moments ``mu``, ``nu`` (float32, one per
    parameter); :meth:`state_dict` gives them as ``{"count", "mu", "nu"}``
    with the moments nested by JAX path, the checkpoint's ``opt_state``."""

    def __init__(self, model: GTCRNMicro, sched_cfg: WarmupCosineConfig = WarmupCosineConfig(),
                 clip_grad_norm: float = 3.0, device=None):
        _check_model(model, resolve_device(device))
        self.names, self.params = map(list, zip(*model.named_parameters()))
        self.sched_cfg, self.clip_grad_norm = sched_cfg, clip_grad_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        grads = clip_by_global_norm([p.grad for p in self.params], self.clip_grad_norm)
        lr = warmup_cosine_lr(self.count, self.sched_cfg)
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, grads, alpha=1 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - B2)
        self.count += 1
        mu_hat = torch._foreach_div(self.mu, 1 - B1 ** self.count)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1 - B2 ** self.count))
        torch._foreach_add_(denom, EPS)
        torch._foreach_addcdiv_(self.params, mu_hat, denom, value=-lr)

    def state_dict(self) -> dict:
        """``{"count": int, "mu": nested, "nu": nested}``, CPU copies."""
        def tree(ts):
            return nest({n: t.detach().cpu().clone() for n, t in zip(self.names, ts)})
        return {"count": self.count, "mu": tree(self.mu), "nu": tree(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Set the state from :meth:`state_dict`'s form (array-likes too);
        the moments must name exactly the model's parameters."""
        for name, mine in (("mu", self.mu), ("nu", self.nu)):
            flat = flatten(state[name])
            if set(flat) != set(self.names):
                raise KeyError(f"opt_state {name}: leaves {sorted(set(flat) ^ set(self.names))} "
                               f"differ from the trainable set")
            for n, t in zip(self.names, mine):
                v = flat[n]
                t.copy_(v if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32)))
        self.count = int(state["count"])


def make_optimizer(model: GTCRNMicro, sched_cfg: WarmupCosineConfig = WarmupCosineConfig(),
                   clip_grad_norm: float = 3.0, device=None) -> Adam:
    """Clip by global norm -> Adam with the per-step warmup-cosine rate over
    the trainable leaves (reference train.py:90-92,282)."""
    return Adam(model, sched_cfg, clip_grad_norm, device=device)


def opt_state_from_jax(tree_np: Any) -> dict:
    """The Adam ``count``, ``mu`` and ``nu`` of a JAX ``opt_state`` given as
    numpy (``jax.tree.map(np.asarray, opt_state)``, or its
    ``ScaleByAdamState`` alone) in :meth:`Adam.load_state_dict`'s form.  The
    frozen leaves' masked placeholders are dropped."""
    def find(node):
        if hasattr(node, "_fields") and {"count", "mu", "nu"} <= set(node._fields):
            return node
        children = node.values() if isinstance(node, dict) else (
            node if isinstance(node, (tuple, list)) else ())
        for child in children:
            found = find(child)
            if found is not None:
                return found
        return None

    def arrays(node):
        if not isinstance(node, dict):
            return node if isinstance(node, np.ndarray) else None
        out = {k: arrays(v) for k, v in node.items()}
        return {k: v for k, v in out.items() if v is not None and not (isinstance(v, dict) and not v)}

    adam = find(tree_np)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the JAX opt_state")
    return {"count": int(np.asarray(adam.count)), "mu": arrays(adam.mu), "nu": arrays(adam.nu)}


@torch.no_grad()
def apply_bn_stats(model: GTCRNMicro, stats: dict, momentum: float = BN_MOMENTUM) -> None:
    """Fold the batch statistics a training forward recorded (``path ->``
    ``batch_mean`` / unbiased ``batch_var``) into the model's running
    statistics in place: ``(1 - momentum) * running + momentum * batch``
    (the torch rule: the biased variance normalises inside the forward, the
    unbiased one accumulates here).  An unknown path raises ``KeyError``."""
    buffers = dict(model.named_buffers())
    leaf = {"batch_mean": "running_mean", "batch_var": "running_var"}
    running, batch, missing = [], [], []
    for path, value in stats.items():
        *parts, name = path.split("/")
        key = ".".join(parts + [leaf.get(name, name)])
        if name not in leaf or key not in buffers:
            missing.append(path)
            continue
        running.append(buffers[key])
        batch.append(value)
    if missing:
        raise KeyError(f"BN stats with no matching params: {sorted(missing)}")
    if running:
        torch._foreach_mul_(running, 1.0 - momentum)
        torch._foreach_add_(running, torch._foreach_mul(batch, momentum))


@contextlib.contextmanager
def _without_onednn(active: bool):
    """PyTorch's CPU oneDNN returns a wrong weight gradient for a bf16
    depthwise conv with time dilation >= 2 (ROADMAP section C): a bf16 step
    on the CPU runs without it."""
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = saved and not active
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = saved


def _spectra(noisy, clean, window, cfg: TrainerConfig, dev):
    noisy, clean = (_dequant_audio(_to_device(x, dev)) for x in (noisy, clean))
    return tuple(stft(x, window, cfg.n_fft, cfg.hop_len, cfg.win_len) for x in (noisy, clean))


def _average_over_ranks(group, grads: list[torch.Tensor], loss: torch.Tensor) -> torch.Tensor:
    """DDP's reduction: every gradient and the loss replaced by their mean
    over the ranks of ``group``, by one all-reduce of one flat buffer.
    Returns the mean loss."""
    world = dist.get_world_size(group)
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
    dist.all_reduce(flat, group=group)
    flat /= world
    parts = flat[:-1].split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [p.view_as(g) for p, g in zip(parts, grads)])
    return flat[-1]


def make_train_step(model: GTCRNMicro, optimizer: Adam,
                    loss_cfg: HybridLossConfig = HybridLossConfig(),
                    trainer_cfg: TrainerConfig = TrainerConfig(),
                    quantizer=None, freeze_bn: bool = False, compute_dtype=None,
                    device=None, group=None) -> Callable:
    """Returns ``step(noisy, clean) -> loss``: one update of ``model`` and
    ``optimizer`` in place from a batch of noisy/clean audio (B, samples),
    float or int16, numpy or tensors.  The loss is a 0-d float32 tensor on
    the device (no wait for the device).

    ``group``: a ``torch.distributed`` process group for data parallelism,
    each rank stepping on its equal shard of the global batch: the
    BatchNorms take the global batch's statistics (``parallel/mesh.RankMean``),
    the gradients and the loss are averaged over the ranks by one all-reduce
    after the backward and before the clip (DDP's semantics, written out so
    that the bf16 ``functional_call`` path takes it too), and the statistics
    folded are the global ones.  Each rank then takes the same update.
    ``None``: one process, no collective.

    ``quantizer``: a ``ctx.quant`` hook (``quant.ptq.FakeQuantizer``) for
    quantization-aware training: fake-quant is a straight-through estimator,
    so the same step trains through the int8 grid.
    ``freeze_bn``: normalise with the running statistics and leave them
    alone (fine-tuning a trained checkpoint); gamma and beta still train.
    ``compute_dtype``: ``torch.bfloat16`` for bf16 forward and backward on
    the float32 masters (module docstring); ``None`` is the exact float32
    recipe of the reference (train.py:245-299)."""
    dev = resolve_device(device)
    _check_model(model, dev)
    window = hann_window(trainer_cfg.win_len, device=dev)
    params = optimizer.params
    cpu_bf16 = dev.type == "cpu" and compute_dtype is not None
    rank_mean = RankMean(group) if group is not None else None

    def forward(spec, ctx):
        if compute_dtype is None:
            return model(spec, ctx)
        cast = {n: t.to(compute_dtype)
                for n, t in itertools.chain(model.named_parameters(), model.named_buffers())}
        return torch.func.functional_call(model, cast, (spec.to(compute_dtype), ctx))

    def train_step(noisy, clean):
        with torch.enable_grad(), exact_f32(), _without_onednn(cpu_bf16):
            noisy_spec, clean_spec = _spectra(noisy, clean, window, trainer_cfg, dev)
            ctx = Ctx(training=not freeze_bn, quant=quantizer, rank_mean=rank_mean)
            enhanced = forward(noisy_spec, ctx).float()  # the loss is always float32
            loss = hybrid_loss(enhanced, clean_spec, loss_cfg)
            for p in params:
                p.grad = None
            loss.backward()
        if group is not None:
            loss = _average_over_ranks(group, [p.grad for p in params], loss)
        optimizer.step()
        apply_bn_stats(model, ctx.stats)  # nothing to fold under freeze_bn
        return loss.detach()

    return train_step


def make_eval_step(model: GTCRNMicro, loss_cfg: HybridLossConfig = HybridLossConfig(),
                   trainer_cfg: TrainerConfig = TrainerConfig(), device=None) -> Callable:
    """Returns ``eval_step(noisy, clean) -> (loss, enhanced_spec)`` with the
    running statistics (eval mode), on the device."""
    dev = resolve_device(device)
    _check_model(model, dev)
    window = hann_window(trainer_cfg.win_len, device=dev)

    @torch.no_grad()
    def eval_step(noisy, clean):
        with exact_f32():
            noisy_spec, clean_spec = _spectra(noisy, clean, window, trainer_cfg, dev)
            enhanced = model.apply(noisy_spec)
            return hybrid_loss(enhanced, clean_spec, loss_cfg), enhanced

    return eval_step
