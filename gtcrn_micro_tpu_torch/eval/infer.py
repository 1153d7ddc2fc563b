"""Bulk offline enhancement (reference infer.py:26-119).

``python -m gtcrn_micro_tpu_torch.eval.infer -C configs/cfg_infer.yaml``

Per wav: read -> resample to 16 kHz -> STFT -> the layered model's offline
forward -> iSTFT -> length-match to clean -> write ``<uid>_enh.wav``; writes
the ``inf.scp`` / ``ref.scp`` manifests the reference's eval stack reads
(infer.py:113-119).  The STFT's size, hop and window, and whether the input
is scaled by its standard deviation, are the model's (``stft_config``,
``window``, ``scale_by_std``): GTCRN-Micro and GTCRN take a 512-sample
sqrt-Hann window at a 256-sample hop, TF-GridNet a 256-sample Hann window
at a 128-sample hop and its input over its standard deviation.

As in the JAX package, wavs are padded to power-of-two frame buckets and
batched within a bucket.  Each wav's tail is reflect-padded (torch.stft
``center=True``) before the bucket's zero pad.  For a ``causal`` model
(GTCRN-Micro, GTCRN) no frame reads a later one, so a wav enhanced in a
batch matches the wav enhanced alone except for the overlap-add of the
padding frames into its last ~2 hops.  A model that is not causal
(TF-GridNet) gets each row's own frame count, and each wav's output is the
wav enhanced alone: its standard deviation over its own samples, its frames
past its own zeroed, and the iSTFT's envelope of its own frames.

On a card each batch shape (rows, samples, sample dtype) runs its scale,
STFT, forward and iSTFT as one CUDA graph: the first batch of a shape runs
as it comes and the graph is captured behind it; every later batch of the
shape, in that call or a later one, is a replay, one launch in place of
some 600.  The graphs are kept per model and freed with it.
"""

from __future__ import annotations

import argparse
import itertools
import math
import os
import threading
import weakref

import numpy as np
import torch
from torch import nn

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.dsp.stft import (
    istft_ola,
    ola_envelope,
    ola_envelope_rows,
    stft,
    window_of,
)
from gtcrn_micro_tpu_torch.io.wav import (
    extract_fileid,
    read_pcm16_into,
    read_wav,
    resample,
    wav_info,
    write_wav,
)
from gtcrn_micro_tpu_torch.nn.core import exact_f32
from gtcrn_micro_tpu_torch.utils.profiling import count, span, tracing

FS = 16000


def _bucket_frames(n_frames: int, min_bucket: int = 64) -> int:
    b = min_bucket
    while b < n_frames:
        b *= 2
    return b


def enhance_wavs(model, wav_paths: list[str], batch_size: int = 8, device=None,
                 progress: bool = True) -> dict[str, np.ndarray]:
    """Enhance wavs with ``model`` (a layered model of ``models/registry.py``
    on ``device``, or a ``quant.ptq.QuantizedModel``) in bucket-padded
    batches, at the model's STFT; returns path -> float32 waveform at 16 kHz.

    The lengths come from the wavs' headers, and the wavs are read batch by
    batch: the host reads and assembles a batch while the device runs the
    one before.  On a card each batch passes through page-locked host
    buffers, and the waveforms returned are views of them; each batch
    shape after its first runs as a replay of a CUDA graph of the model's
    (:class:`_Graphs`), which reads the model's parameters and buffers
    where they were at its capture: a weight changed in place shows in the
    next call, a model whose tensors moved is captured anew.  Calls on one
    model run one at a time.

    Under ``torch.profiler`` the call is the span ``infer.call`` over
    ``infer.read`` (the headers; then, a batch, its wav reads and
    resampling), ``infer.batch`` (assembly and reflect pad; the trim) and
    ``infer.forward`` (scale, STFT, ``apply``, iSTFT and the copy back
    enqueued, or on a card the copies and the replay; the wait for the copy
    back is the call's own time); the counters ``infer.frames`` (each wav's
    own frames at the model's hop), ``infer.frames_computed`` (bucket frames
    times rows) and ``infer.frame_pairs`` (rows times bucket frames squared:
    the query-key pairs of a full-band attention over the batch), and on a
    card ``infer.frames_graphed`` (bucket frames times rows of a
    batch run as a replay, 0 for a shape's first) and
    ``infer.graph_captures`` (one a capture)
    (``utils/profiling.span``, ``count``)."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, not on {dev}")
    with span("infer.call"):
        if dev.type != "cuda":
            return _enhance(model, wav_paths, batch_size, dev, progress, None)
        graphs = _graphs_of(model, dev)
        with graphs.lock:
            return _enhance(model, wav_paths, batch_size, dev, progress, graphs)


def _length_16k(n: int, fs: int) -> int:
    """Samples of ``n`` at ``fs`` after :func:`resample` to 16 kHz (scipy's
    ``resample_poly`` gives ceil(n up / down))."""
    g = math.gcd(fs, FS)
    return -(-n * (FS // g) // (fs // g))


def _read_16k(path: str) -> np.ndarray:
    """A wav's first channel at 16 kHz, float32."""
    x, fs = read_wav(path)
    if x.ndim > 1:
        x = x[:, 0]
    if fs != FS:
        x = resample(x, fs, FS)
    return x.astype(np.float32, copy=False)


def _forward(model, x: torch.Tensor, n: torch.Tensor | None, window: torch.Tensor,
             envelope: torch.Tensor | None) -> torch.Tensor:
    """A batch's samples on the device, (rows, samples) int16 or float32, to
    its enhanced waveforms (rows, samples) float32 at the model's STFT.

    ``n`` None (a causal model): the rows run as they are, with
    ``envelope``, the iSTFT's of the batch's shape.  Otherwise (a model
    that is not causal) ``n`` (rows,) int64 on the device is each row's own
    sample count: the scaling (``scale_by_std``: by the unbiased standard
    deviation of the row's own samples) reads only those, ``apply`` gets
    each row's own frames ``n // hop + 1``, and the iSTFT divides by each
    row's own envelope; nothing of ``n`` reaches the host."""
    if x.dtype == torch.int16:
        x = x.float().mul_(1 / 32768)
    cfg = model.stft_config
    std = None
    if n is not None and model.scale_by_std:
        own = torch.arange(x.shape[-1], device=x.device) < n[:, None]
        mean = torch.where(own, x, 0.0).sum(dim=-1, keepdim=True) / n[:, None]
        var = torch.where(own, x - mean, 0.0).square().sum(dim=-1, keepdim=True)
        std = torch.sqrt(var / (n[:, None] - 1))
        x = x / std
    spec = stft(x, window, cfg.n_fft, cfg.hop_len, cfg.win_len).to(model.dtype)
    if n is None:
        enh = model.apply(spec)
    else:
        frames = n // cfg.hop_len + 1
        enh = model.apply(spec, frames)
        envelope = ola_envelope_rows(window, frames, spec.shape[-2], x.shape[-1], cfg.hop_len)
    y = istft_ola(enh.float(), window, x.shape[-1], envelope, cfg.hop_len)
    return y if std is None else y * std


def _envelope(window: torch.Tensor, samples: int, hop_len: int) -> torch.Tensor:
    return ola_envelope(window, samples // hop_len + 1, samples, hop_len)


class _Replay:
    """One batch shape's :func:`_forward` as a CUDA graph: copy a batch into
    ``x`` (and its rows' lengths into ``n``, where the model takes them),
    replay ``graph``, and read ``out`` before the next replay of any graph of
    its pool."""

    def __init__(self, model, x: torch.Tensor, n: torch.Tensor | None, window: torch.Tensor,
                 envelope: torch.Tensor | None, pool):
        """Capture the graph on the current stream (not the device's default),
        after a pass as it comes has loaded cuFFT's plans and cuDNN's engines;
        the graph reads ``x``, ``n``, ``window`` and ``envelope`` where they
        are."""
        self.x, self.n, self.window, self.envelope = x, n, window, envelope
        self.graph = torch.cuda.CUDAGraph()
        # capture_begin, not torch.cuda.graph: that one would first sync and
        # empty the device's and the page-locked caches
        self.graph.capture_begin(pool=pool)
        try:
            self.out = _forward(model, x, n, window, envelope)
        finally:
            self.graph.capture_end()
        if tracing():
            count("infer.graph_captures")


def _weights_at(model: nn.Module) -> tuple:
    """Where the parameters and buffers of ``model`` live."""
    return tuple(t.data_ptr() for t in itertools.chain(model.parameters(), model.buffers()))


class _Graphs:
    """A model's replays by (rows, samples, sample dtype), in one memory
    pool: each replay's output is copied out before the next replay, so the
    graphs may reuse one another's intermediates.  ``weights``: where the
    model's tensors were at the captures; ``window``: the model's."""

    def __init__(self, weights: tuple, window: torch.Tensor):
        self.weights = weights
        self.window = window
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(window.device)  # the captures'
        self.replays: dict = {}
        self.lock = threading.Lock()  # one input and one output buffer a shape

    def run(self, model, host: torch.Tensor,
            host_n: torch.Tensor | None) -> tuple[torch.Tensor, bool]:
        """The enhanced waveforms of the page-locked batch ``host`` (with its
        rows' lengths ``host_n``, page-locked, where the model takes them),
        and whether they came from a replay: the first batch of a shape runs
        as it comes, and the shape's graph is captured behind it."""
        key = (*host.shape, host.dtype)
        r = self.replays.get(key)
        if r is not None:
            r.x.copy_(host, non_blocking=True)
            if r.n is not None:
                r.n.copy_(host_n, non_blocking=True)
            r.graph.replay()
            return r.out, True
        dev = self.window.device
        cur = torch.cuda.current_stream(dev)
        x = torch.empty(host.shape, dtype=host.dtype, device=dev)
        n = None if host_n is None else torch.empty(host_n.shape, dtype=host_n.dtype, device=dev)
        envelope = None if n is not None else _envelope(self.window, host.shape[1],
                                                        model.stft_config.hop_len)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            x.copy_(host, non_blocking=True)
            if n is not None:
                n.copy_(host_n, non_blocking=True)
            first = _forward(model, x, n, self.window, envelope)
            self.replays[key] = _Replay(model, x, n, self.window, envelope, self.pool)
        cur.wait_stream(self.stream)
        first.record_stream(cur)  # read there: its memory waits for that
        return first, False


_GRAPHS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # model -> _Graphs


def _graphs_of(model: nn.Module, dev: torch.device) -> _Graphs:
    """The model's graphs; new ones where its tensors moved since the
    captures (their addresses are in the graphs)."""
    at = _weights_at(model)
    g = _GRAPHS.get(model)
    if g is None or g.weights != at:
        g = _GRAPHS[model] = _Graphs(at, _window_of(model, dev))
    return g


def _window_of(model, dev: torch.device) -> torch.Tensor:
    return window_of(model.window, model.stft_config.win_len, device=dev)


def _enhance(model, wav_paths: list[str], batch_size: int, dev: torch.device,
             progress: bool, graphs: _Graphs | None) -> dict[str, np.ndarray]:
    """:func:`enhance_wavs`, each batch through ``graphs`` (a card's) or, with
    None, through :func:`_forward` as it comes."""
    hop, half = model.stft_config.hop_len, model.stft_config.n_fft // 2
    with_n = not model.causal  # each row carries its own length
    if graphs is None:
        window = _window_of(model, dev)
        envelopes: dict = {}  # samples -> envelope
    # page-locked host buffers on a card: the copies to and from the device
    # then run at the link's rate, without CUDA's staging through its
    # own pinned buffer (for a 4,096-frame batch of 8, 33.6 MB each way)
    pin = dev.type == "cuda"

    # the lengths from the headers, so the wavs are read batch by batch: the
    # host reads and assembles a batch while the device runs the one before
    with span("infer.read"):
        infos = [wav_info(p) for p in wav_paths]
    lengths = [_length_16k(info.frames, info.fs) for info in infos]
    buckets: dict[int, list[int]] = {}
    for i, n in enumerate(lengths):
        buckets.setdefault(_bucket_frames(n // hop + 1), []).append(i)
    # a bucket holds wavs of (len // hop + 1) <= bucket frames, i.e.
    # len < bucket * hop samples: no tail is cut
    batches = [(bucket, idxs[j : j + batch_size]) for bucket, idxs in sorted(buckets.items())
               for j in range(0, len(idxs), batch_size)]

    out: dict[str, np.ndarray] = {}

    def finish(chunk, back, ready) -> None:
        """Wait for a batch's copy back, then trim its wavs into ``out``."""
        if ready is not None:
            ready.synchronize()
        got = back.numpy()
        with span("infer.batch"):
            for k, i in enumerate(chunk):
                out[wav_paths[i]] = got[k, : lengths[i]]
        if progress:
            print(f"\renhanced {len(out)}/{len(wav_paths)}", end="", flush=True)

    pending = None
    for bucket, chunk in batches:
        samples = bucket * hop
        # a batch of mono 16-bit wavs at 16 kHz goes to the device as its raw
        # samples, read straight into the batch, and is scaled there (x /
        # 32768 is exact: read_wav's float samples); any other as float32
        raw = all(infos[i].pcm16 and infos[i].channels == 1 and infos[i].fs == FS
                  for i in chunk)
        with span("infer.read"):
            host = torch.empty((len(chunk), samples),
                               dtype=torch.int16 if raw else torch.float32, pin_memory=pin)
            batch = host.numpy()
            for k, i in enumerate(chunk):
                n = lengths[i]
                if raw:
                    read_pcm16_into(wav_paths[i], infos[i], batch[k, :n])
                else:
                    batch[k, :n] = _read_16k(wav_paths[i])
        with span("infer.batch"):
            for k, i in enumerate(chunk):
                n = lengths[i]
                # reflect-pad the true tail: x[n-2], x[n-3], ... (the JAX
                # package's slice x[n-2 : n-2-r : -1] is empty when r = n-1)
                r = max(min(half, samples - n, n - 1), 0)
                batch[k, n : n + r] = batch[k, n - 2 - np.arange(r)]
                batch[k, n + r :] = 0
            host_n = None
            if with_n:
                host_n = torch.tensor([lengths[i] for i in chunk], dtype=torch.int64)
                host_n = host_n.pin_memory() if pin else host_n
            if tracing():
                count("infer.frames", sum(lengths[i] // hop + 1 for i in chunk))
                count("infer.frames_computed", bucket * len(chunk))
                count("infer.frame_pairs", len(chunk) * bucket * bucket)
        with torch.no_grad(), exact_f32(), span("infer.forward"):
            if graphs is None:
                if not with_n and samples not in envelopes:
                    envelopes[samples] = _envelope(window, samples, hop)
                wavs = _forward(model, host.to(dev, non_blocking=pin),
                                None if host_n is None else host_n.to(dev, non_blocking=pin),
                                window, envelopes.get(samples))
            else:
                wavs, replayed = graphs.run(model, host, host_n)
                if tracing():
                    count("infer.frames_graphed", bucket * len(chunk) if replayed else 0)
            # the copy back is queued behind this batch and ahead of the next
            # (of any shape), which the device runs while the host reads
            back, ready = wavs, None
            if pin:
                back = torch.empty(wavs.shape, pin_memory=True).copy_(wavs, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
        if pending is not None:
            finish(*pending)
        pending = (chunk, back, ready)
    if pending is not None:
        finish(*pending)
    if progress:
        print()
    return out


def load_params(checkpoint: str, device=None) -> dict:
    """Params from ``checkpoint``: the reference's ``.tar``
    (``io/torch_ckpt.import_reference_checkpoint``), a flat ``.npz`` of
    ``/``-joined param paths (``io/params.load_params_npz``), or a directory
    of the trainer's ``utils/checkpoint.CheckpointManager``, whose latest
    step is read (as the JAX package reads an orbax directory)."""
    from gtcrn_micro_tpu_torch.io.params import load_params_npz, params_from_numpy
    from gtcrn_micro_tpu_torch.io.torch_ckpt import import_reference_checkpoint
    from gtcrn_micro_tpu_torch.utils.checkpoint import CheckpointManager

    if checkpoint.endswith(".tar"):
        return import_reference_checkpoint(checkpoint, device=device)
    if os.path.isdir(checkpoint):
        return params_from_numpy(CheckpointManager(checkpoint).restore()["params"], device)
    if not checkpoint.endswith(".npz"):
        raise ValueError(f"checkpoint {checkpoint!r}: expected the reference .tar, a .npz of "
                         f"params or a checkpoint directory")
    return load_params_npz(checkpoint, device=device)


def write_enhanced(model, noisy_dir: str, clean_dir: str | None, enh_dir: str,
                   batch_size: int = 8, device=None) -> None:
    """Enhance every wav of ``noisy_dir`` into ``enh_dir/<uid>_enh.wav``,
    length-matched to its clean wav in ``clean_dir`` when one is given, and
    write the ``inf.scp`` (and ``ref.scp``) manifests."""
    os.makedirs(enh_dir, exist_ok=True)
    wavs = sorted(os.path.join(noisy_dir, f) for f in os.listdir(noisy_dir)
                  if f.endswith(".wav"))
    enhanced = enhance_wavs(model, wavs, batch_size=batch_size, device=device)

    inf_scp, ref_scp = [], []
    for noisy_path in wavs:
        uid = os.path.basename(noisy_path).split(".wav")[0]
        enh = enhanced[noisy_path]

        if clean_dir is not None:
            fileid = extract_fileid(noisy_path)
            if fileid is None:
                raise RuntimeError(f"Unable to extract fileid: {noisy_path}")
            ref_path = os.path.join(clean_dir, f"clean_fileid_{fileid}.wav")
            if not os.path.exists(ref_path):
                raise FileNotFoundError(ref_path)
            clean, fs_c = read_wav(ref_path)
            if fs_c != FS:
                clean = resample(clean, fs_c, FS)
            # length-match to clean (reference infer.py:98-102)
            if len(enh) < len(clean):
                enh = np.pad(enh, (0, len(clean) - len(enh)))
            else:
                enh = enh[: len(clean)]
            ref_scp.append((uid, ref_path))

        enh_path = os.path.join(enh_dir, uid + "_enh.wav")
        write_wav(enh_path, enh, FS)
        inf_scp.append((uid, enh_path))

    with open(os.path.join(enh_dir, "inf.scp"), "w") as f:
        f.writelines(f"{uid} {p}\n" for uid, p in inf_scp)
    if ref_scp:
        with open(os.path.join(enh_dir, "ref.scp"), "w") as f:
            f.writelines(f"{uid} {p}\n" for uid, p in ref_scp)
    print(f"wrote {len(inf_scp)} enhanced wavs + scp manifests to {enh_dir}")


def main(args=None) -> None:
    """Enhance every wav of the config's ``test_dataset.noisy_dir`` into
    ``network.enh_folder`` with the params of ``network.checkpoint``
    (:func:`load_params`) in the model that ``--model`` names (a registry
    name; the config's ``network_name`` by default, else ``gtcrn_micro``).
    ``--quant``: int8 simulated inference (the reference's tflite_infer.py):
    calibrate the activation ranges on 32 wavs of ``--calib_dir`` (the noisy
    dir by default), then enhance with the fake-quant model."""
    from gtcrn_micro_tpu_torch.models.registry import get_model
    from gtcrn_micro_tpu_torch.utils.config import load_config

    parser = argparse.ArgumentParser()
    parser.add_argument("-C", "--config", default="configs/cfg_infer.yaml")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--device", default=None)
    parser.add_argument("--model", default=None,
                        help="the model's registry name (models/registry.py); default: the "
                             "config's network_name, else gtcrn_micro")
    parser.add_argument("--quant", action="store_true")
    parser.add_argument("--calib_dir", default=None)
    parser.add_argument("--act_bits", type=int, default=8, choices=(8, 16))
    parser.add_argument("--per_channel_acts", action="store_true",
                        help="per-lane activation scales")
    parser.add_argument("--integer_pc", action="store_true",
                        help="with --per_channel_acts: simulate the full-integer per-channel "
                             "deployment (weight rounding on act-scale-folded tensors)")
    ns = parser.parse_args(args)
    if ns.integer_pc and not ns.per_channel_acts:
        parser.error("--integer_pc requires --per_channel_acts")
    dev = resolve_device(ns.device)
    cfg = load_config(ns.config)

    model = get_model(ns.model or cfg.get("network_name", "gtcrn_micro"), device=dev,
                      **cfg.get("network_config", {}))
    model.load_params(load_params(cfg["network"]["checkpoint"], device=dev))
    if ns.quant:
        from gtcrn_micro_tpu_torch.quant.calibration import calibration_specs
        from gtcrn_micro_tpu_torch.quant.ptq import make_quantized_model

        calib_dir = ns.calib_dir or cfg["test_dataset"]["noisy_dir"]
        model = make_quantized_model(model, calibration_specs(calib_dir, n_wavs=32),
                                     act_bits=ns.act_bits, per_channel_acts=ns.per_channel_acts,
                                     v4=ns.integer_pc)
        tag = (" per-channel v4" if ns.integer_pc
               else " per-channel" if ns.per_channel_acts else "")
        print(f"int{ns.act_bits}{tag} PTQ model calibrated on {calib_dir}")
    write_enhanced(model, cfg["test_dataset"]["noisy_dir"], cfg["test_dataset"].get("clean_dir"),
                   cfg["network"]["enh_folder"], batch_size=ns.batch_size, device=dev)


if __name__ == "__main__":
    main()
