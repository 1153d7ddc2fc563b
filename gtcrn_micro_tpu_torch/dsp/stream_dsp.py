"""Online (chunked) STFT / iSTFT state for audio-in -> audio-out serving.

Per-chunk analysis and synthesis with O(1) carried state, matching the
offline ``dsp.stft`` / ``dsp.istft`` in the interior.  The online contract
(the JAX package's ``dsp/stream_dsp.py`` holds the same one):

- analysis: offline frame ``t`` covers ``x[256(t-1) : 256(t+1)]``, so one
  carried hop (``in_buf``) suffices.  The left context starts at zeros: only
  frame 0 differs from the offline reflect pad (a stream whose first 257
  samples are silence matches it exactly).
- synthesis: output chunk ``j`` is ``tail(frame j) + head(frame j+1)`` over
  the squared-window envelope, so the output runs ONE hop behind the input,
  and the first emitted hop of a fresh stream is the offline center-trim
  region, which callers drop.

Unlike the JAX package, the chunk functions update the :class:`DspState`
buffers in place (no second copy of the state per step) and return the same
state object.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from gtcrn_micro_tpu_torch import resolve_device
from gtcrn_micro_tpu_torch.utils.profiling import span

_NFFT = 512
_HOP = 256


@dataclasses.dataclass
class DspState:
    """Carried DSP state for one batch of streams.

    in_buf:  (B, 256)  previous input hop (analysis left context)
    ola_buf: (B, 256)  synthesis tail of the last inverse frame
    """

    in_buf: torch.Tensor
    ola_buf: torch.Tensor


def init_dsp_state(batch: int, dtype=torch.float32, device=None) -> DspState:
    dev = resolve_device(device)
    return DspState(
        in_buf=torch.zeros((batch, _HOP), dtype=dtype, device=dev),
        ola_buf=torch.zeros((batch, _HOP), dtype=dtype, device=dev),
    )


def _envelope(window: torch.Tensor) -> torch.Tensor:
    """The offline istft envelope at emitted samples: ``win^2[i] +
    win^2[i+256]``, the same two-term float32 sum as the offline OLA."""
    w2 = (window * window).float()
    return w2[:_HOP] + w2[_HOP:]


def _frames(state: DspState, chunk: torch.Tensor):
    """(B, 256*T) chunk -> (B, T, 512) analysis frames and the new left hop."""
    B, n = chunk.shape
    T = n // _HOP
    if n != T * _HOP:
        raise ValueError(f"chunk length {n} not a multiple of {_HOP}")
    sig = torch.cat([state.in_buf, chunk], dim=-1)
    segs = sig.reshape(B, T + 1, _HOP)
    frames = torch.cat([segs[:, :-1], segs[:, 1:]], dim=-1)
    return frames, segs[:, T]


def stft_chunk(state: DspState, chunk: torch.Tensor, window: torch.Tensor):
    """Analyse ``chunk`` (B, 256*T) -> spec frames (B, F, T, 2); ``state``
    advances in place."""
    frames, last = _frames(state, chunk)
    spec = torch.fft.rfft((frames * window).float(), n=_NFFT, dim=-1)
    spec = spec.movedim(-1, -2)  # (B, F, T)
    out = torch.stack([spec.real, spec.imag], dim=-1).to(chunk.dtype)
    state.in_buf.copy_(last)
    return out, state


def _overlap_add(state: DspState, frames: torch.Tensor, dtype,
                 env: torch.Tensor | None = None) -> torch.Tensor:
    """(B, T, 512) f32 synthesis frames -> (B, 256*T) emitted samples, divided
    by ``env`` when given; the last tail is carried in ``state.ola_buf``."""
    B, T = frames.shape[0], frames.shape[1]
    heads, tails = frames[..., :_HOP], frames[..., _HOP:]
    prev = torch.cat([state.ola_buf[:, None].float(), tails[:, :-1]], dim=1)
    out = heads + prev
    if env is not None:
        out = out / env
    out = out.reshape(B, T * _HOP).to(dtype)
    state.ola_buf.copy_(tails[:, T - 1])
    return out


def istft_chunk(state: DspState, spec: torch.Tensor, window: torch.Tensor):
    """Synthesise spec frames (B, F, T, 2) -> audio chunk (B, 256*T), one hop
    behind the input (see the module docstring)."""
    c = torch.complex(spec[..., 0].float(), spec[..., 1].float())
    c = c.movedim(-2, -1)  # (B, T, F)
    frames = torch.fft.irfft(c, n=_NFFT, dim=-1) * window
    return _overlap_add(state, frames, spec.dtype, _envelope(window)), state


def _dft_mats(window) -> tuple:
    """Windowed DFT / inverse DFT as dense matrices (float64 numpy, returned
    as float32 numpy).

    fwd: (n_fft, 2F) -- frames @ fwd = [Re | Im] of the windowed rfft
    inv: (2F, n_fft) -- [Re | Im] @ inv = windowed, envelope-normalised
         irfft frame ready for overlap-add
    """
    w_t = torch.as_tensor(window).detach().cpu()
    w = w_t.numpy().astype(np.float64)
    n = w.shape[0]
    F = n // 2 + 1
    i = np.arange(n)[:, None]
    k = np.arange(F)[None, :]
    ang = 2.0 * np.pi * i * k / n
    fwd = np.concatenate(
        [w[:, None] * np.cos(ang), w[:, None] * -np.sin(ang)], axis=1
    )
    # irfft: x_i = (1/n) sum_k c_k (Re_k cos - Im_k sin), c_k = 2 except
    # the DC and Nyquist bins
    c = np.full((1, F), 2.0)
    c[0, 0] = c[0, -1] = 1.0
    env = _envelope(w_t).numpy().astype(np.float64)  # length n//2
    wn = w / np.concatenate([env, env])  # synthesis win / OLA envelope
    inv = np.concatenate(
        [(c * np.cos(ang)).T, (c * -np.sin(ang)).T], axis=0
    ) * (wn[None, :] / n)
    return fwd.astype(np.float32), inv.astype(np.float32)


def _stft_chunk_mxu(state: DspState, chunk: torch.Tensor, fwd: torch.Tensor):
    """Windowed analysis as one GEMM: frames @ (win * DFT) in the chunk's
    dtype (f32 accumulation)."""
    frames, last = _frames(state, chunk)
    ri = torch.matmul(frames, fwd.to(chunk.dtype))  # (B, T, 2F)
    F = fwd.shape[1] // 2
    spec = torch.stack([ri[..., :F], ri[..., F:]], dim=-1)  # (B, T, F, 2)
    state.in_buf.copy_(last)
    return spec.movedim(1, 2), state


def _istft_chunk_mxu(state: DspState, spec: torch.Tensor, inv: torch.Tensor):
    """Synthesis as one GEMM with window and OLA envelope folded into
    ``inv``, a float32 tensor holding values already rounded to the spec's
    dtype (``make_audio_step`` caches it so).  As in the JAX package, the
    operands are values of the spec's dtype and the frames stay float32 up
    to the overlap-add, so the output is rounded to the spec's dtype once.
    The GEMM runs in float32: products of bf16 values are exact in float32
    (and in TF32)."""
    ri = torch.cat([spec[..., 0].movedim(2, 1), spec[..., 1].movedim(2, 1)],
                   dim=-1)  # (B, T, 2F)
    frames = torch.matmul(ri.float(), inv)
    return _overlap_add(state, frames, spec.dtype), state


def make_audio_step(model, window: torch.Tensor, dft: str = "fft"):
    """Audio-in -> audio-out serving step over ``model``.

    Returns ``step(dsp_state, model_state, chunk) -> (out_chunk, dsp_state,
    model_state)``, where ``chunk`` is (B, 256*T) samples and
    ``out_chunk`` the enhanced samples one hop behind.  ``dft="fft"`` uses the
    float32 FFT; ``"mxu"`` computes the windowed DFT pair as two GEMMs in the
    serving dtype (the name is the JAX package's).  Under ``torch.profiler``
    the three phases are the spans ``serve.stft``, ``serve.model`` and
    ``serve.istft`` (``utils/profiling.span``).
    """
    if dft not in ("fft", "mxu"):
        raise ValueError(f"dft must be 'fft' or 'mxu', got {dft!r}")
    if dft == "mxu":
        mats32 = [torch.from_numpy(m).to(window.device) for m in _dft_mats(window)]

        @functools.cache
        def mats(dtype):  # fwd in the serving dtype; inv rounded to it, kept f32
            return [mats32[0].to(dtype), mats32[1].to(dtype).float()]

    def step(dsp_state: DspState, model_state, chunk: torch.Tensor):
        with span("serve.stft"):
            if dft == "fft":
                spec, dsp_state = stft_chunk(dsp_state, chunk, window)
            else:
                spec, dsp_state = _stft_chunk_mxu(dsp_state, chunk, mats(chunk.dtype)[0])
        with span("serve.model"):
            out_spec, model_state = model.step(model_state, spec)
        with span("serve.istft"):
            if dft == "fft":
                out, dsp_state = istft_chunk(dsp_state, out_spec, window)
            else:
                out, dsp_state = _istft_chunk_mxu(dsp_state, out_spec,
                                                  mats(out_spec.dtype)[1])
        return out, dsp_state, model_state

    return step


def make_audio_scan(model, window: torch.Tensor, dft: str = "fft"):
    """Long-form audio streaming: a loop of :func:`make_audio_step` over hop
    chunks.  ``scan(dsp_state, model_state, audio) -> (out, dsp,
    model_state)`` with ``audio`` (B, n_hops*256); ``out`` carries the
    one-hop delay (slice ``out[:, 256:]`` against ``audio[:, :-256]``)."""
    step = make_audio_step(model, window, dft=dft)

    def scan(dsp_state: DspState, model_state, audio: torch.Tensor):
        B, n = audio.shape
        outs = []
        for h in range(n // _HOP):
            out, dsp_state, model_state = step(
                dsp_state, model_state, audio[:, _HOP * h : _HOP * (h + 1)]
            )
            outs.append(out)
        return torch.cat(outs, dim=-1), dsp_state, model_state

    return scan
