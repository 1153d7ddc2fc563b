"""Cohort serving engine: phase-staggered batched streaming on one GPU, or
on a mesh of GPUs with each cohort's streams split across them (``mesh=``).

Counterpart of the JAX package's ``serve.py``.  Streams are admitted into
slots of K independent *cohorts*; each cohort is stepped once per 16 ms
frame interval (one 256-sample hop per stream), with the cohorts' phases
staggered across the interval.  In ``mode="audio"`` a step is audio in ->
audio out: online STFT, the per-frame network, online iSTFT
(``dsp/stream_dsp.py``); with ``dft="mxu"`` the windowed DFT pair is two
GEMMs.

    srv = CohortServer(None, params, batch=8192, n_cohorts=2, mode="audio")
    sid = srv.admit(cohort=srv.next_cohort())
    out = srv.step(cohort_idx, chunk)     # (B, 256) -> (B, 256), one hop behind

The model backends, all with the step protocol ``step(state, spec) ->
(out, state)``; each declares the axis of its state that holds the stream
batch (``batch_axis``):

- ``GridFusedGTCRNMicro`` (the default): one launch of CUDA kernel B2;
- ``FusedGTCRNMicro``: CUDA kernel B1;
- ``LayoutGTCRNMicro``: the plain PyTorch version of the fused kernels, on
  any device.  These three keep ring states ``(L, *frame, B)``, batch last,
  and step one hop at a time;
- ``models.gtcrn_micro.GTCRNMicro``: the layered model (cuDNN convolutions
  and cuBLAS products on the GPU), state ``(B, L, F, C)``, batch first.  It
  also serves throughput mode (``chunk_hops`` T in {2, 4, 8, 16} hops per
  step) and the state options of its ``init_state`` (``state_opts``:
  ``l2_psum``, ``store_dtype``).  ``models.gtcrn.GTCRN`` is the same
  backend over GTCRN's layers (its state also holds GRU hidden states,
  batch first).

Model states and DSP buffers update in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.dsp.stft import sqrt_hann_window
from gtcrn_micro_tpu_torch.dsp.stream_dsp import init_dsp_state, make_audio_step
from gtcrn_micro_tpu_torch.parallel.mesh import canonical, make_mesh
from gtcrn_micro_tpu_torch.utils.profiling import span, tracing

FRAME_S = 0.016
LATENCY_BUDGET_S = 0.010
BACKENDS = ("grid", "step", "layered")


def make_backend(name: str, params: dict, dtype=torch.bfloat16, device=None,
                 model: str = "gtcrn_micro"):
    """The model backend ``name`` (one of :data:`BACKENDS`: kernel B2, kernel
    B1, the layered model) built from ``params`` in ``dtype`` on ``device``.
    ``model`` is the registry name (``models/registry.py``) of the layered
    backend's model; the fused kernels run ``gtcrn_micro`` only."""
    from gtcrn_micro_tpu_torch.models.registry import get_model
    from gtcrn_micro_tpu_torch.ops.fused_grid import GridFusedGTCRNMicro
    from gtcrn_micro_tpu_torch.ops.fused_step import FusedGTCRNMicro

    if name == "layered":
        layered = get_model(model, dtype=dtype, device=device)
        layered.load_params(params)
        return layered
    if name not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {name!r}")
    if model != "gtcrn_micro":
        raise ValueError(f"the fused backend {name!r} runs gtcrn_micro, not {model!r}")
    cls = GridFusedGTCRNMicro if name == "grid" else FusedGTCRNMicro
    return cls(params, dtype=dtype, device=device)


@dataclasses.dataclass
class CohortPlan:
    """A validated (batch, n_cohorts) serving plan.

    ``chunk_hops`` (T) > 1 is *throughput mode*: each step consumes T hops
    per stream, so a cohort is stepped once per ``T * 16 ms`` interval, and
    buffering T hops adds ``(T-1) * 16 ms`` to the latency.
    """

    batch: int
    n_cohorts: int
    step_time_s: float
    chunk_hops: int = 1

    @property
    def streams(self) -> int:
        return self.batch * self.n_cohorts

    @property
    def interval_s(self) -> float:
        """Wall-clock between two steps of the same cohort."""
        return self.chunk_hops * FRAME_S

    @property
    def keep_up_ok(self) -> bool:
        return self.n_cohorts * self.step_time_s <= self.interval_s

    @property
    def worst_latency_s(self) -> float:
        """Arrival of a hop -> its enhanced samples: chunk buffering,
        worst-case phase offset to the cohort's slot, then the step."""
        if self.n_cohorts == 0:
            return float("inf")
        return ((self.chunk_hops - 1) * FRAME_S
                + self.interval_s / self.n_cohorts + self.step_time_s)

    @property
    def realtime_ok(self) -> bool:
        return self.keep_up_ok and self.worst_latency_s <= LATENCY_BUDGET_S

    def phase_of(self, cohort: int) -> float:
        """Start offset (seconds) of a cohort's step inside each interval."""
        return (cohort % self.n_cohorts) * self.interval_s / self.n_cohorts


def plan_cohorts(step_time_s: float, batch: int,
                 budget_s: float = LATENCY_BUDGET_S,
                 chunk_hops: int = 1) -> CohortPlan:
    """Largest keep-up plan within a latency budget for a measured per-step
    time."""
    k = 0
    for cand in range(1, 65):
        plan = CohortPlan(batch=batch, n_cohorts=cand,
                          step_time_s=step_time_s, chunk_hops=chunk_hops)
        if plan.keep_up_ok and plan.worst_latency_s <= budget_s:
            k = cand
    return CohortPlan(batch=batch, n_cohorts=k, step_time_s=step_time_s,
                      chunk_hops=chunk_hops)


def _replica(model, params, device: torch.device):
    """The serving backend ``model`` on ``device``: itself where it lives,
    else a copy (the layered model from its own params, a fused backend from
    ``params``)."""
    if canonical(model.device) == device:
        return model
    if hasattr(model, "from_params"):
        return type(model).from_params(model.params(), dtype=model.dtype, device=device,
                                       config=model.config)
    if params is None:
        raise ValueError(f"{type(model).__name__} is replicated from params: got None")
    return type(model)(params, dtype=model.dtype, device=device)


class _Shard(NamedTuple):
    """One shard: ``batch / len(mesh)`` streams of every cohort on
    ``device``, its backend and the step that advances them: the backend's
    ``step(state, spec) -> (out, state)`` in spec mode, ``step(dsp_state,
    state, chunk) -> (out, dsp_state, state)``
    (``dsp/stream_dsp.make_audio_step``) in audio mode."""

    device: torch.device
    backend: object
    step: Callable


class CohortServer:
    """K independent ring-state cohorts over one model backend per device.

    ``model`` is a backend instance (see the module docstring) or ``None``
    for a ``GridFusedGTCRNMicro`` built from ``params`` in ``dtype`` on
    ``device``.  ``step(i, chunk)`` advances cohort ``i`` by ``chunk_hops``
    hops for all its streams (throughput mode, see :class:`CohortPlan`; a
    power of two <= 16 that the backend's ``chunk_sizes`` holds: the fused
    backends step one hop at a time, as the JAX fused steps do).
    ``state_opts`` go to the backend's ``init_state`` (the layered model's
    ``l2_psum`` and ``store_dtype``).

    ``mesh``: a list of devices (``parallel.mesh.make_mesh``), given instead
    of ``device``, over which every cohort's ``batch`` streams are split
    evenly into shards, with no collectives: the server is on the mesh's
    first device, where ``model`` lives and chunks are given and returned,
    and every other device gets a replica of ``model`` (shards on one device
    share one).  Each shard keeps its own state per cohort:
    ``_states[c][i]`` is cohort ``c``'s model state on shard ``i`` and, in
    audio mode, ``_dsp[c][i]`` holds its DSP state (``[dsp_state]``; ``[]``
    in spec mode).  Slots stay numbered over the whole cohort: slot ``s`` is
    local slot ``s mod (batch / len(mesh))`` of shard ``s // (batch /
    len(mesh))``.
    """

    def __init__(self, model, params, batch: int, n_cohorts: int,
                 dtype=torch.bfloat16, mode: str = "spec", dft: str = "mxu",
                 device=None, chunk_hops: int = 1, mesh=None,
                 state_opts: dict | None = None):
        if mode not in ("spec", "audio"):
            raise ValueError(f"mode must be 'spec' or 'audio', got {mode!r}")
        if chunk_hops not in (1, 2, 4, 8, 16):
            raise ValueError(f"chunk_hops must be a power of two <= 16, got {chunk_hops}")
        if mesh is not None and device is not None:
            raise ValueError("give device or mesh, not both: the server is on mesh[0]")
        devices = [canonical(resolve_device(d)) for d in (mesh or [device])]
        self.device = devices[0]
        if batch % len(devices):
            raise ValueError(f"batch {batch} does not divide over {len(devices)} devices")
        if model is None:
            from gtcrn_micro_tpu_torch.ops.fused_grid import GridFusedGTCRNMicro

            model = GridFusedGTCRNMicro(params, dtype=dtype, device=self.device)
        if model.dtype != dtype or canonical(model.device) != self.device:
            raise ValueError(f"model is {model.dtype} on {model.device}, the "
                             f"server {dtype} on {self.device}")
        if chunk_hops != 1 and chunk_hops not in model.chunk_sizes:
            raise ValueError(f"{type(model).__name__} steps chunks of "
                             f"{model.chunk_sizes} hops, not {chunk_hops}")
        self.model = model
        self.batch = batch
        self.n_cohorts = n_cohorts
        self.dtype = dtype
        self.mode = mode
        self.chunk_hops = chunk_hops
        self._rows = batch // len(devices)  # streams a shard
        replicas: dict = {}
        self._shards = []
        for d in devices:
            if d not in replicas:
                replicas[d] = _replica(model, params, d)
            b = replicas[d]
            step = (b.step if mode == "spec" else
                    make_audio_step(b, sqrt_hann_window(b.config.win_len, device=d), dft=dft))
            self._shards.append(_Shard(d, b, step))
        # the DSP buffers are allocated before the rings: the rings' placement
        # moves B2's time (~0.4 % of stream capacity on an H100 at 9 x 8192)
        self._dsp = [[[init_dsp_state(self._rows, dtype, s.device)] if mode == "audio" else []
                      for s in self._shards] for _ in range(n_cohorts)]
        self._states = [[s.backend.init_state(self._rows, dtype=dtype, **(state_opts or {}))
                         for s in self._shards] for _ in range(n_cohorts)]
        self._frames = [0] * n_cohorts
        # clean free slots (rings are zeros) and recycled free slots (rings
        # still carry a previous stream's history); admit() prefers clean
        # slots and resets a recycled one before handing it out, so no
        # stream ever sees another stream's state
        self._free: list[list[int]] = [list(range(batch)) for _ in range(n_cohorts)]
        self._recycled: list[list[int]] = [[] for _ in range(n_cohorts)]

    @property
    def backends(self) -> list:
        """The backend of each shard, in stream order."""
        return [s.backend for s in self._shards]

    # -- admission ---------------------------------------------------------

    def next_cohort(self) -> int:
        """Cohort with the most free slots (load balancing)."""
        return max(range(self.n_cohorts),
                   key=lambda i: len(self._free[i]) + len(self._recycled[i]))

    def admit(self, cohort: int) -> int:
        """Claim a stream slot in ``cohort``; its state is guaranteed zero.
        Clean slots go first; a recycled slot is reset here."""
        if self._free[cohort]:
            return self._free[cohort].pop()
        if self._recycled[cohort]:
            slot = self._recycled[cohort].pop()
            self.reset_slot(cohort, slot)
            return slot
        raise RuntimeError(f"cohort {cohort} full")

    def release(self, cohort: int, slot: int) -> None:
        """Return a slot to the recycled pool; it is zeroed when next
        admitted."""
        self._recycled[cohort].append(slot)

    def reset_slot(self, cohort: int, slot: int) -> None:
        """Zero one stream's state (idempotent): in its shard, its slice of
        every state tensor along the backend's ``batch_axis`` (last for the
        fused rings, first for the layered state) and its row of the DSP
        buffers.  A slot waiting in the recycled pool moves back to the clean
        pool."""
        if slot in self._recycled[cohort]:
            self._recycled[cohort].remove(slot)
            self._free[cohort].append(slot)
        for view in self._slot_rows(cohort, slot):
            view.zero_()

    def slot_absmax(self, cohort: int, slot: int) -> torch.Tensor:
        """The largest magnitude in one stream's state and DSP rows, as a
        float32 scalar on the device (no synchronize): 0 after
        :meth:`reset_slot`."""
        return torch.stack([r.float().abs().amax() for r in self._slot_rows(cohort, slot)]).amax()

    def _slot_rows(self, cohort: int, slot: int) -> list:
        """Views of one stream's slice of every state tensor in its shard and,
        in audio mode, of its DSP rows."""
        shard, local = divmod(slot, self._rows)
        axis = self._shards[shard].backend.batch_axis
        rows = [v.select(axis, local) for k, v in self._states[cohort][shard].items()
                if k != "step"]
        return rows + [buf[local] for d in self._dsp[cohort][shard]
                       for buf in (d.in_buf, d.ola_buf)]

    # -- serving -----------------------------------------------------------

    def step(self, cohort: int, frame: torch.Tensor) -> torch.Tensor:
        """Advance ``cohort`` by ``chunk_hops`` (T) hops.

        mode "spec":  frame is (batch, 257, T, 2) spectra -> enhanced spectra.
        mode "audio": frame is (batch, 256 T) samples -> enhanced samples one
        hop behind (the first emitted hop per stream is the center trim).

        The frame is split along dim 0 into the shards' rows, every shard's
        step is launched before any output is read, and the outputs are
        gathered on the server's device in stream order; one shard takes
        the frame whole.  Under ``torch.profiler`` the call is the span
        ``serve.cohort_step`` (request: the cohort and its frames served
        before the call), over the spans of the DSP and model step
        (``dsp/stream_dsp.py``).
        """
        request = (cohort, self._frames[cohort]) if tracing() else None
        with span("serve.cohort_step", request):
            frame = frame.to(self.device, self.dtype)
            # every piece is copied before any step: a copy to another device
            # runs on the source's stream, behind the steps queued there
            xs = ([frame] if len(self._shards) == 1 else
                  [x.to(s.device, non_blocking=True)
                   for s, x in zip(self._shards, frame.tensor_split(len(self._shards)))])
            dsps, states = self._dsp[cohort], self._states[cohort]
            outs = []
            for i, (shard, x) in enumerate(zip(self._shards, xs)):
                out, *dsps[i], states[i] = shard.step(*dsps[i], states[i], x)
                outs.append(out)
            out = (outs[0] if len(outs) == 1 else
                   torch.cat([o.to(self.device, non_blocking=True) for o in outs]))
            self._frames[cohort] += self.chunk_hops
        return out

    def round_robin(self, frames: list) -> list:
        """One full interval: step every cohort once, in phase order."""
        if len(frames) != self.n_cohorts:
            raise ValueError(f"need {self.n_cohorts} frames, got {len(frames)}")
        return [self.step(i, f) for i, f in enumerate(frames)]

    @property
    def frames_served(self) -> int:
        return sum(self._frames)


def _snr_db(ref, x) -> float:
    ref, x = ref.double(), x.double()
    err = float(((x - ref) ** 2).sum())
    return 10.0 * torch.log10(torch.tensor(max(float((ref ** 2).sum()), 1e-20)
                                           / max(err, 1e-20))).item()


def main(args=None) -> dict:
    """Demo CLI: enhance audio through the audio-mode cohort server.

    Admits one stream into a cohort, feeds ``--chunk-hops`` hops per
    (virtual) interval, and reports the backend's SNR against the plain
    PyTorch version of the fused kernels fed the same audio one hop at a
    time.  Without ``--wav`` the input is a seeded synthetic signal.  The
    weights come from ``--checkpoint`` (what ``eval.infer.load_params``
    reads: a trainer's checkpoint directory, a ``.npz`` or the reference
    ``.tar``) or ``--params`` (a flat ``.npz`` of JAX params), else a seeded
    random init.  Returns the enhanced audio of the stream by backend name
    and ``"plain"``.
    """
    import argparse

    import numpy as np

    from gtcrn_micro_tpu_torch.eval.infer import load_params
    from gtcrn_micro_tpu_torch.io.params import load_params_npz
    from gtcrn_micro_tpu_torch.io.wav import read_wav, write_wav
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params
    from gtcrn_micro_tpu_torch.ops.fused_step import LayoutGTCRNMicro

    parser = argparse.ArgumentParser(description="cohort serving demo")
    parser.add_argument("--wav", default="", help="input wav (16 kHz mono)")
    parser.add_argument("--out", default="", help="write the enhanced wav here")
    weights = parser.add_mutually_exclusive_group()
    weights.add_argument("--params", default="", help="flat .npz of JAX params")
    weights.add_argument("--checkpoint", default="",
                         help="a trainer's checkpoint directory (its latest step), a .npz "
                              "or the reference .tar")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--seconds", type=float, default=4.0,
                        help="length of the synthetic input without --wav")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--cohorts", type=int, default=2)
    parser.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    parser.add_argument("--backend", choices=BACKENDS, default="grid",
                        help="kernel B2, kernel B1, or the layered model")
    parser.add_argument("--chunk-hops", type=int, default=1,
                        help="hops per step (throughput mode; layered backend only)")
    parser.add_argument("--device", default=None)
    parser.add_argument("--devices", type=int, default=1,
                        help="split each cohort over this many GPUs (with --device cpu: "
                             "this many CPU shards)")
    ns = parser.parse_args(args)

    device = resolve_device(ns.device)
    mesh = [device] * ns.devices if device.type == "cpu" else make_mesh(ns.devices)
    device = canonical(mesh[0])
    if ns.checkpoint:
        params = load_params(ns.checkpoint, device=device)
    elif ns.params:
        params = load_params_npz(ns.params, device=device)
    else:
        params = init_params(torch.Generator().manual_seed(ns.seed), device=device)
    if ns.wav:
        wav, fs = read_wav(ns.wav)
        if wav.ndim > 1:
            wav = wav[:, 0]
    else:
        fs = 16000
        rng = np.random.default_rng(ns.seed)
        n = int(ns.seconds * fs)
        tt = np.arange(n) / fs
        wav = (0.3 * np.sin(2 * np.pi * 220 * tt) * (1 + np.sin(2 * np.pi * 3 * tt))
               + 0.05 * rng.standard_normal(n)).astype(np.float32)
    dtype = torch.bfloat16 if ns.dtype == "bf16" else torch.float32
    hop, T = 256, ns.chunk_hops
    hops = len(wav) // (hop * T) * T
    wav = torch.from_numpy(np.ascontiguousarray(wav[: hops * hop], np.float32))

    model = make_backend(ns.backend, params, dtype, device)
    runs = {}
    for label, m, t_hops in ((ns.backend, model, T),
                             ("plain", LayoutGTCRNMicro(params, dtype=dtype, device=device), 1)):
        srv = CohortServer(m, params, batch=ns.batch, n_cohorts=ns.cohorts, dtype=dtype,
                           mode="audio", chunk_hops=t_hops, mesh=mesh)
        cohort = srv.next_cohort()
        slot = srv.admit(cohort)
        feed = torch.zeros((ns.batch, hop * t_hops), dtype=dtype, device=device)
        zeros = torch.zeros_like(feed)
        outs = []
        for t in range(0, hops + t_hops, t_hops):  # the last step flushes the OLA tail
            feed[slot] = wav[hop * t : hop * (t + t_hops)] if t < hops else 0.0
            for c in range(srv.n_cohorts):  # phase-ordered interval
                got = srv.step(c, feed if c == cohort else zeros)
                if c == cohort:
                    outs.append(got[slot].float().cpu())
        runs[label] = torch.cat(outs)[hop : hop * (hops + 1)]  # drop the center-trim hop
        print(f"{label}: served {hops} hops, {t_hops} per step, through cohort {cohort} "
              f"slot {slot} ({srv.n_cohorts} cohorts x {srv.batch} slots, {ns.dtype}, "
              f"{len(mesh)} x {device.type})")
    note = (" (on the CPU the kernel backends run the plain version)"
            if device.type == "cpu" and ns.backend != "layered" else "")
    print(f"{ns.backend} vs plain SNR: {_snr_db(runs['plain'], runs[ns.backend]):.1f} dB{note}")
    if ns.out:
        write_wav(ns.out, runs[ns.backend].numpy(), fs)
        print(f"wrote {ns.out}")
    return runs


if __name__ == "__main__":
    main()
