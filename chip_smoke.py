#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``gtcrn_micro_tpu_torch/csrc`` and drives the
served path -- audio in, online STFT as a GEMM, the fused GTCRN-Micro
kernel, online iSTFT as a GEMM, audio out -- through
``gtcrn_micro_tpu_torch.serve.CohortServer`` at the full model width with
seeded random weights.  Phases (one line each; any failed check exits 1):

1. device  -- a CUDA card is required; prints its name and power limit.
2. build   -- compiles every kernel (one nvcc per source, in parallel).
3. kernels -- what each compiled kernel uses (registers, local and shared
              bytes, CTAs per SM, per storage dtype; any local memory, i.e.
              a spill or a stack frame, fails), then each kernel against its
              plain PyTorch version on the card:
              f32 at B=256 over 24 frames (max-abs <= 1e-4, SNR >= 80 dB:
              another summation order across ~40 layers and a 24-step
              recurrence), bf16 storage against the f32 plain version
              (reported; SNR >= 30 dB as a sanity bound), and one step at
              the served shape (B=8192, bf16) from the same state (every
              value within one bf16 rounding step, 2^-7 of the largest
              magnitude).  With ``--parity`` the run stops here.  Then
              times each kernel at the served shape and at one full wave
              (SMs x CTAs per SM x TILE streams), its plain version, and
              its bound at both.
4. serve   -- CohortServer(mode="audio", dft="mxu", bf16), batch 8192 x 2
              cohorts, 64 round-robin intervals of seeded audio on kernel
              B2 (the default backend), then 8 on kernel B1: finite output,
              a silent slot gives exactly 0, launch counts equal the steps
              (and B2's staged launches, bf16 at B % 8 == 0, all of them),
              admit/release/reset zeroes one slot's column; the served step
              timed with CUDA events, and its device time split into the
              kernel, the two GEMMs and the rest by torch.profiler, with the
              device's idle share.
5. slice parity -- the same server in f32 at batch 64 for 24 hops on the
              kernel backends and on the plain backend: SNR >= 80 dB.
6. layered -- the layered model (``models.gtcrn_micro.GTCRNMicro``: cuDNN
              convolutions and cuBLAS products, no kernel of this repo):
              f32 at B=256 over 24 frames, its T=1 ring step against kernel
              B2 and its offline ``apply`` against that step (max-abs <=
              1e-4, SNR >= 80 dB); over 32 frames, ring chunks of T=4 and
              T=16 and the l2_psum state against ``apply`` (SNR >= 80 dB);
              ``apply`` bit-identical with the global TF32 flags on; the
              layered bf16 audio server at 8,192 x 2 cohorts with
              chunk_hops 1 and 4 (finite, a silent slot exactly 0, reset on
              axis 0), its step timed (ms per step and per hop) and its
              device idle share; ``eval.infer.enhance_wavs`` on 32 seeded
              wavs of 3-10 s (wall time, real-time factor, silence exactly
              0, one wav >= 60 dB against the f32 layered server outside
              its first 96 and last 2 hops).
7. train   -- the training path (``train.trainer``, ``train.train``; no
              kernel of this repo): one f32 step at B=4 x 1 s of white noise
              (the JAX trainer tests' batch) on the card and on the CPU port
              from the same params (loss rel <= 1e-5; every gradient within
              1e-4 of the largest gradient of the CPU float64 step, float32
              itself being good to ~1e-5 of it; BatchNorm running statistics
              <= 1e-5; the ERB filters and, under the lr-0 first update,
              every other leaf bit-identical; the loss gap on tone-only
              targets reported), the same step bit-identical with the
              global TF32 flags on; f32 and bf16 steps at the training shape 8 x
              10 s (configs/cfg_train_dns3.yaml): ms per step, audio seconds
              per second, peak memory, host syncs, idle share and top device
              operations, the loss falling over 30 steps, bf16 step 1 within
              5 % of f32; ``train.run`` for 2 epochs and resumed to 3 on
              smoke data, then ``eval.infer`` on its checkpoint and
              ``eval.intrusive`` (finite SDR, SI-SNR, STOI).
8. quant   -- quantization (``quant/``, ``ops/int8_step.py``; no kernel of
              this repo, the int8 products are ``torch._int_mm``):
              ``observe_ranges`` on 16 seeded specs of 973 frames (59
              paths), the card's ranges against the CPU port's on 2 x 64
              frames (1e-5 of each path's bound); the int8 fake-quant
              ``apply`` on the card against the CPU and its T=1 ring step
              against ``apply``, and ``Int8Serving`` against the card's
              fake-quant step over 20 frames at B=256, each at the JAX int8
              test's bounds (median frame < 1e-6, worst < 5e-3 max|y|, SNR
              > 50 dB: a value on a rounding tie may flip by one quantum);
              en1's ``_int_mm`` accumulators against the CPU int32 product
              bit for bit, and ``_int_mm``'s layout rules; the int8 step at
              8,192 and 32,768 streams (CUDA events, device operations,
              idle share, top operations, state bytes) and en1's ``_int_mm``
              time against its bound; 20 QAT steps at 8 x 4 s (the loss
              falls, the running statistics stay).
9. dist    -- data parallelism and the deployment export (``parallel/``,
              ``io/export_native.py``, ``runtime/native.py``; the sharded
              server runs kernel B2): two f32 training steps at B=4 x 1 s
              with a one-rank NCCL group against no group (loss, gradients,
              params and running statistics bit-identical), and both steps
              timed at 8 x 10 s with their device operations and idle
              share; where two cards are present, 2 NCCL ranks against one
              process (``parallel/multiproc.py``: rtol 1e-5, atol 2e-5), the
              B2 server over ``make_mesh(2)`` against the unsharded one
              (within 2^-7) and ``serve --devices 2`` (``--multi-card`` runs
              only these, after the build, on a machine with two cards);
              ``CohortServer`` B2 bf16 8,192 x 2 cohorts, 8 intervals, on a
              one-device mesh (bit-identical to unsharded) and two shards
              of 4,096 on this card (within 2^-7 of the largest magnitude),
              launches counted, the served step timed for all three; GTM1
              from the card's params and GTM8 int8 from phase 8's ranges
              byte-identical to the CPU port's files, then ``NativeEngine``
              (built by g++, on the host CPU) on them against B2 f32 on
              the card (< 1e-5) and the card's int8 fake-quant ring step
              (< 5e-4 max(max|y|, 1)) over 20 frames.

10. rounding -- the rest of quantization (``quant/adaround.py``, ``gptq.py``,
              ``mixed.py``; no kernel of this repo; deterministic cuDNN, so
              that every run makes the same artifacts) on phase 8's BN-folded
              full-width params and int8 ranges: an augmented corpus of 64 +
              8 clips of 4 s from five seeded 10 s wavs; one AdaRound step
              card vs CPU port (loss, MSE, regulariser rel <= 1e-5; each
              group's gradients within 1e-4 of its largest CPU float32
              gradient, the float64 step's distance reported; bit-identical
              with the TF32 flags on); the step at
              8 x 4 s timed (CUDA events, ``utils.profiling``), profiled,
              host syncs and peak memory; the card's bake against the CPU
              port's bake of the same variables (equal but at float32
              sigmoid ties, scales within 2 ulps); ``adaround_optimize`` 40 steps
              (val every 20) + 20 ``bias_refine`` steps (int8 MSE after < 1.05
              before, every scale re-observed bit-identical, on-grid to
              1e-6); its GTM8 through ``NativeEngine(quant="int8")`` against
              the card's fake-quant ring step (< 5e-4 max(max|y|, 1)); GPTQ
              on 16 Hessian clips at a16 per-lane (59 patch checks, scales
              bit-identical, local error below nearest's) and card vs CPU
              codes on 2 x 257 x 33 (at most one quantum apart); the greedy
              16/8 lift (max 2) on two 4 s wavs, its GTM8 v2 byte-identical
              card vs CPU and through ``NativeEngine(quant="mixed")`` (<
              5e-4 max(max|y|, 1)); ``model_complexity`` card = CPU.
11. export -- DNSMOS and the portable exports (``eval/dnsmos.py`` over the
              ONNX executor ``io/onnx.py``, ``io/onnx_export.py``,
              ``io/export_program.py``; no kernel of this repo but B2 as the
              reference server): both DNSMOS models on the card against the
              CPU executor (rtol 1e-4, atol 1e-5, TF32 off); ``DnsmosScorer``
              on 8 seeded 12 s clips, card vs CPU (every MOS within 1e-4),
              clips per second, ms per 9.01 s segment per model (CUDA
              events), its idle share and top device operations; ``evaluate
              -C <a cfg_infer-style YAML written here> --metric dnsmos`` on
              phase 7's enhanced wavs with PyYAML blocked (the port's reader);
              ``export_program.main --format all`` on the card (seven files)
              and ``--format native-int8 --calib_dir`` on the card and on the
              CPU port (weights bytes and zero points equal, activation scales
              within 1e-6); the CLI's three ONNX files on the card's executor
              against the layered model (max-abs <= 1e-5, SNR >= 80 dB); the
              exported audio program at T=1 and T=4, B=64, 40 hops (past the
              ring wrap) against ``CohortServer`` on kernel B2 in f32 and the
              layered server (SNR >= 80 dB), its ms per step against the
              layered server's, and its idle share.
12. bench  -- the measuring entry points (``gtcrn_micro_tpu_torch/bench.py``,
              ``scripts/``; kernel B2, and B1 through the roofline):
              ``python -m gtcrn_micro_tpu_torch.bench --budget 45`` in its
              own process (one JSON line with concurrent_realtime_streams >
              0, its verified (B, K) meeting K * step <= 16 ms and step +
              16/K <= 10 ms with the round-robin step it printed, B2
              launched); ``serve_soak`` at that plan, 5 s paced after 2 s of
              warm-up with admissions every 0.5 s (every output finite, each
              released slot dirty and each readmitted slot zero, one B2
              launch per step; p50/p99 latency and overruns reported, not
              enforced); ``bench_int8`` at 4,096 and 32,768 streams, chain
              20; ``train_speed`` at 8 x 10 s, f32 and bf16, chain 4;
              ``roofline`` at 8,192 on B2 (bandwidth measured) and B1.  The
              kernels JSON line gives each kernel's launches in phase 12
              (``bench_launches``, which must not be 0).
13. rest   -- the rest of the entry points (``scripts/smoke_all.py``,
              ``ref_scale_run.py``, ``ref_scale_snapshot.py``,
              ``sweep_chunk.py``, ``int8_microbench.py``, ``ab_psum.py``,
              ``ring_bank_microbench.py``, ``ablate_shuffle.py``,
              ``leak_probe.py``, the model demo, the complexity CLI and
              ``serve --checkpoint``; kernel B2 in the serving demo):
              ``smoke_all`` in its own process, every CLI end to end on
              smoke data (exit 0 and its last line); beside it the
              reference-scale driver at a small horizon, 128 clips of 10 s,
              batch 8, 64 steps, warmup 40, SIGKILL at step 20, ``log_every``
              4 (one seam, the lr peak at step 40 after a strictly rising
              ramp, checkpoints 16/32/48/64 and the best), its snapshot; the
              model demo (prefix difference exactly 0, streaming within
              1e-4 of offline), the complexity CLI (19,014 and 41,929,335),
              ``serve --checkpoint`` on phase 7's trainer directory
              bit-identical to ``--params`` of the same weights on B2; then,
              the card to themselves, ``sweep_chunk`` at 8,192,
              ``int8_microbench`` at its defaults, ``ab_psum``,
              ``ring_bank_microbench`` and ``ablate_shuffle`` at 8,192 (the
              seam restored after), and ``leak_probe`` for 100 steps in each
              mode, cut to fit the run (a ``[rest]`` line lists the cuts).

14. gtcrn  -- GTCRN on the layered path (``models/gtcrn.py``: cuDNN GRUs and
              convolutions, no kernel of this repo) against its plain
              reference (``benchmark/reference/gtcrn_dpgrnn.py``, every GRU
              a loop of its cell), float32 with TF32 off, seeded weights:
              ``apply`` at B = 8 over 512 frames (relative error <= 1e-4),
              bit-identical with the global TF32 flags on, its time; the
              layered audio server ``CohortServer(mode="audio")``, 1 cohort
              x 1,024 streams x 64 steps from zero state, against the
              reference's forward over the same audio (relative error <=
              1e-4; a silent slot exactly 0), its step timed on the host
              clock (steps 16-63) and by CUDA events.

Prints the kernels JSON line, the card line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def snr_db(ref, x) -> float:
    ref, x = ref.double(), x.double()
    err = float(((x - ref) ** 2).sum())
    return 10 * math.log10(max(float((ref ** 2).sum()), 1e-30) / max(err, 1e-30))


def cuda_ms(torch, fn, n=20, warm=3, reps=1) -> float:
    """Median over ``n`` samples of the device time of one call of ``fn``, by
    CUDA events around ``reps`` back-to-back calls (reps > 1 hides the host's
    time to issue a call behind the device's work on the one before)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def layered_phase(torch, dev, params, spec, card) -> dict:
    """Phase 6: the layered model against kernel B2 and against itself, its
    bf16 cohort server, and the offline enhancement entry point.  Returns
    the numbers it measured."""
    import tempfile

    import numpy as np

    from gtcrn_micro_tpu_torch.eval.infer import enhance_wavs
    from gtcrn_micro_tpu_torch.io.wav import read_wav, write_wav
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro
    from gtcrn_micro_tpu_torch.ops.fused_grid import GridFusedGTCRNMicro
    from gtcrn_micro_tpu_torch.serve import CohortServer
    from gtcrn_micro_tpu_torch.utils.profiling import idle_share

    f32, bf16 = torch.float32, torch.bfloat16
    model = GTCRNMicro.from_params(params, dtype=f32, device=dev)
    res = {}

    def stream(m, x, T=1, **opts):
        st = m.init_state(x.shape[0], **opts)
        outs = [m.step(st, x[:, :, t : t + T])[0] for t in range(0, x.shape[2], T)]
        return torch.cat(outs, dim=2)

    def check(label, ref, got, max_abs=True):
        err, snr = float((got - ref).abs().max()), snr_db(ref, got)
        ok = snr >= 80 and (err <= 1e-4 or not max_abs)
        bound = "1e-4, 80 dB" if max_abs else "80 dB"
        say("layered", f"{label}: max-abs {err:.3g}, SNR {snr:.1f} dB (bound {bound}) "
                       f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"layered: {label}")
        res[label] = {"max_abs": err, "snr_db": snr}

    # f32 parity: B2, the ring step, apply
    B, T = spec.shape[0], spec.shape[2]
    with torch.no_grad():
        b2 = stream(GridFusedGTCRNMicro(params, dtype=f32, device=dev), spec)
        ring = stream(model, spec)
        off = model.apply(spec)
    torch.cuda.synchronize()
    check(f"f32 B={B} {T} frames, ring step T=1 vs kernel B2", b2, ring)
    check(f"f32 B={B} {T} frames, apply vs ring step T=1", ring, off)
    g = torch.Generator().manual_seed(3)
    spec32 = (torch.randn((B, 257, 32, 2), generator=g) * 0.2).to(dev)
    with torch.no_grad():
        off32 = model.apply(spec32)
        for label, Tc, opts in (("ring T=4", 4, {}), ("ring T=16", 16, {}),
                                ("l2_psum T=1", 1, {"l2_psum": True})):
            check(f"f32 B={B} 32 frames, {label} vs apply", off32,
                  stream(model, spec32, Tc, **opts), max_abs=False)

    # the forward turns TF32 off whatever the caller's flags are
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    mm.allow_tf32 = cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            off_tf32 = model.apply(spec)
        torch.cuda.synchronize()
        kept = mm.allow_tf32 and cudnn.allow_tf32
    finally:
        mm.allow_tf32 = cudnn.allow_tf32 = False
    same = torch.equal(off_tf32, off)
    say("layered", f"f32 apply with the global TF32 flags on: bit-identical {same}, flags "
                   f"restored {kept} {'ok' if same and kept else 'FAILED'}")
    if not (same and kept):
        fail("layered: the f32 forward depends on the global TF32 flags")
    del b2, ring, off, off32, off_tf32

    # the layered bf16 audio server
    BS, K, n_int = 8192, 2, 8
    ga = torch.Generator(device=dev).manual_seed(4)
    mb = GTCRNMicro.from_params(params, dtype=bf16, device=dev)
    for Tc in (1, 4):
        srv = CohortServer(mb, None, batch=BS, n_cohorts=K, dtype=bf16, mode="audio",
                           dft="mxu", device=dev, chunk_hops=Tc)
        finite, silent_max = True, 0.0
        for _ in range(n_int):
            for c in range(K):
                chunk = torch.randn((BS, 256 * Tc), generator=ga, device=dev).mul_(0.3).to(bf16)
                if c == 0:
                    chunk[5] = 0
                out = srv.step(c, chunk)
                finite = finite and bool(torch.isfinite(out).all())
                if c == 0:
                    silent_max = max(silent_max, float(out[5].abs().max()))
        slot, st, (dsp,) = 7, srv._states[1][0], srv._dsp[1][0]  # cohort 1, its only shard
        rows = [v for k, v in st.items() if k != "step"] + [dsp.in_buf, dsp.ola_buf]
        busy = all(float(v[slot].abs().max()) > 0 for v in rows)
        srv.reset_slot(1, slot)
        zeroed = all(float(v[slot].abs().max()) == 0 for v in rows)
        kept = all(float(v[slot - 1].abs().max()) > 0 for v in rows)
        ok = finite and silent_max == 0.0 and busy and zeroed and kept
        say("layered", f"server bf16 chunk_hops={Tc}: {n_int} intervals x {K} cohorts x {BS} "
                       f"streams: finite {finite}, silent slot max {silent_max}, reset of slot "
                       f"{slot} on axis 0 of {len(rows)} state and DSP tensors: zeroed {zeroed}, "
                       f"neighbour kept {kept} {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"layered server at chunk_hops={Tc} failed its checks")
        chunk = torch.randn((BS, 256 * Tc), generator=ga, device=dev).mul_(0.3).to(bf16)
        step_ms = cuda_ms(torch, lambda: srv.step(0, chunk), n=20, warm=3)
        res[f"served_step_ms_T{Tc}"] = step_ms
        say("layered", f"served step B={BS} bf16 chunk_hops={Tc} (CUDA events, median of 20): "
                       f"{step_ms:.3f} ms per step, {step_ms / Tc:.3f} ms per hop; card {card}")
        say("layered", f"chunk_hops={Tc}: " + idle_share(lambda i: srv.step(i % K, chunk)))
        del srv
    del mb

    # offline enhancement of seeded wavs, and one of them against the server
    rng = np.random.default_rng(6)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        paths, n_samples = [], 0
        for i in range(32):
            n = int(rng.uniform(3, 10) * 16000)
            tt = np.arange(n) / 16000
            x = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * tt)
                 * (1 + np.sin(2 * np.pi * rng.uniform(1, 5) * tt))
                 + 0.05 * rng.standard_normal(n))
            paths.append(f"{d}/w{i:02d}.wav")
            write_wav(paths[-1], np.zeros(n) if i == 0 else x, 16000)
            n_samples += n
        secs = []
        for _ in range(2):  # the first call meets every bucket shape first
            t0 = time.perf_counter()
            enh = enhance_wavs(model, paths, batch_size=8, device=dev, progress=False)
            secs.append(time.perf_counter() - t0)
        audio_s = n_samples / 16000
        res.update(enhance_wall_s=secs, enhance_audio_s=audio_s)
        say("layered", f"enhance_wavs f32: 32 wavs, {audio_s:.1f} s of audio, batch 8: wall "
                       f"{secs[0]:.2f} s first call, {secs[1]:.2f} s second: real-time factor "
                       f"{secs[0] / audio_s:.4f} / {secs[1] / audio_s:.4f} "
                       f"({audio_s / secs[1]:.0f}x real time); card {card}")
        silent = float(np.abs(enh[paths[0]]).max())
        x, _ = read_wav(paths[1])
    n, Tc = len(x), 4
    step = 256 * Tc
    xs = torch.zeros(((n + 256) // step + 1) * step, device=dev)
    xs[:n] = torch.from_numpy(x).to(dev)
    srv = CohortServer(model, None, batch=1, n_cohorts=1, dtype=f32, mode="audio", dft="mxu",
                       device=dev, chunk_hops=Tc)
    served = torch.cat([srv.step(0, xs[None, i : i + step])[0] for i in range(0, len(xs), step)])
    served = served[256 : 256 + n]  # one hop behind; the first hop is the center trim
    lo, hi = 96 * 256, n - 2 * 256
    snr = snr_db(torch.from_numpy(enh[paths[1]][lo:hi]).double(), served[lo:hi].cpu())
    res.update(enhance_silent_max=silent, enhance_vs_server_snr_db=snr)
    ok = silent == 0.0 and snr >= 60
    say("layered", f"enhance_wavs: silent wav max {silent}; wav 1 ({n} samples) vs the f32 "
                   f"layered server (chunk_hops {Tc}) outside its first 96 and last 2 hops: SNR "
                   f"{snr:.1f} dB (bound 60 dB) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("layered: enhance_wavs")
    return res


def train_phase(torch, dev, params, card) -> str:
    """Phase 7: the training step on the card against the CPU port and
    against itself with the TF32 flags on, its time, memory and idle share
    at the full training shape in f32 and bf16, and train -> resume ->
    enhance -> score end to end.  Returns a directory under ``build/`` that
    holds a copy of the enhanced wavs and their ``inf.scp`` (phase 11 scores
    them with DNSMOS and removes it)."""
    import shutil
    import tempfile
    import warnings

    import numpy as np

    from gtcrn_micro_tpu_torch.dsp.stft import hann_window, stft
    from gtcrn_micro_tpu_torch.eval import infer, intrusive
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro
    from gtcrn_micro_tpu_torch.nn.core import Ctx
    from gtcrn_micro_tpu_torch.train import train as train_mod
    from gtcrn_micro_tpu_torch.train.loss import hybrid_loss
    from gtcrn_micro_tpu_torch.train.scheduler import WarmupCosineConfig
    from gtcrn_micro_tpu_torch.train.trainer import make_optimizer, make_train_step
    from gtcrn_micro_tpu_torch.utils.checkpoint import CheckpointManager
    from gtcrn_micro_tpu_torch.utils.make_smoke_data import make_smoke_data, smoke_pair
    from gtcrn_micro_tpu_torch.utils.profiling import idle_share

    t_phase = time.perf_counter()
    sched = WarmupCosineConfig(warmup_steps=5, decay_until_step=100, max_lr=1e-3)
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn

    def batch(n, seconds, seed):
        rng = np.random.default_rng(seed)
        pairs = [smoke_pair(rng, int(seconds * 16000)) for _ in range(n)]
        return np.stack([p[1] for p in pairs]), np.stack([p[0] for p in pairs])

    def trainer(device, dtype=None):
        model = GTCRNMicro.from_params(params, device=device)
        opt = make_optimizer(model, sched, device=device)
        return model, make_train_step(model, opt, compute_dtype=dtype, device=device)

    # -- parity: one f32 step at 4 x 1 s on the card, on the CPU port, and on
    # the card with the global TF32 flags on (cuDNN deterministic for both
    # card runs, so that only the flags differ).  The batch is the JAX
    # trainer tests' white noise (tests/train/test_trainer.py): on targets
    # with near-zero bins, such as make_smoke_data's pure tones, the loss's
    # |X|^0.3 compression magnifies the FFTs' float32 rounding there, so that
    # comparison is reported, not bounded
    rng = np.random.default_rng(7)
    clean = (rng.standard_normal((4, 16000)) * 0.05).astype(np.float32)
    noisy = clean + (rng.standard_normal((4, 16000)) * 0.02).astype(np.float32)

    def one_step(device, tf32=False, data=(noisy, clean)):
        model, step = trainer(device)
        saved = mm.allow_tf32, cudnn.allow_tf32, cudnn.deterministic
        mm.allow_tf32 = cudnn.allow_tf32 = tf32
        cudnn.deterministic = True
        try:
            loss = float(step(*data))
            kept = mm.allow_tf32 == cudnn.allow_tf32 == tf32
        finally:
            mm.allow_tf32, cudnn.allow_tf32, cudnn.deterministic = saved
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        return loss, grads, {k: v.cpu() for k, v in model.state_dict().items()}, kept

    card_loss, card_g, card_st, _ = one_step(dev)
    cpu_loss, cpu_g, cpu_st, _ = one_step("cpu")
    tf_loss, tf_g, tf_st, tf_kept = one_step(dev, tf32=True)
    tones = batch(4, 1.0, 7)
    tones_rel = abs(one_step(dev, data=tones)[0] / one_step("cpu", data=tones)[0] - 1)

    # the float64 gradient of the same loss on the CPU: a float32 gradient
    # is good to ~1e-5 of the largest gradient here, but leaves with small
    # gradients (gammas, PReLU slopes; the conv biases ahead of a BatchNorm,
    # whose true gradient is 0) carry errors of 1e-2 to 1 of their own size
    # even between two CPU thread counts, so each float32 gradient is held
    # against the float64 one at the scale of the largest gradient
    m64 = GTCRNMicro.from_params(params, dtype=torch.float64, device="cpu")
    w64 = hann_window(512, dtype=torch.float64, device="cpu")
    spec64 = [stft(torch.from_numpy(x).double(), w64) for x in (noisy, clean)]
    hybrid_loss(m64(spec64[0], Ctx(training=True)), spec64[1]).backward()
    ref_g = {n: p.grad for n, p in m64.named_parameters()}
    g_max = max(float(g.abs().max()) for g in ref_g.values())

    def grad_err(gs):  # worst leaf error over the largest float64 gradient
        return max(float((gs[n].double() - ref_g[n]).abs().max()) for n in ref_g) / g_max

    leaf_rel = max((float((card_g[n] - cpu_g[n]).abs().max() / cpu_g[n].abs().max()), n)
                   for n in cpu_g)
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    bn_err = max(float((card_st[k] - cpu_st[k]).abs().max()) for k in cpu_st if "running" in k)
    start = GTCRNMicro.from_params(params, device="cpu").state_dict()
    unmoved = all(torch.equal(card_st[k], start[k]) for k in start if "running" not in k)
    card_err, cpu_err = grad_err(card_g), grad_err(cpu_g)
    ok = loss_rel <= 1e-5 and card_err <= 1e-4 and bn_err <= 1e-5 and unmoved
    say("train", f"f32 step B=4 x 1 s of white noise, card vs CPU port: loss {card_loss:.6f} vs {cpu_loss:.6f} "
                 f"(rel {loss_rel:.2g}, bound 1e-5); gradients against the CPU float64 "
                 f"gradient, worst leaf error over the largest gradient: card {card_err:.2g}, "
                 f"CPU float32 {cpu_err:.2g} (bound 1e-4); card vs CPU relative to each "
                 f"leaf's own largest magnitude: {leaf_rel[0]:.2g} ({leaf_rel[1]}; reported); "
                 f"BN running statistics max-abs {bn_err:.2g} (bound 1e-5); ERB filters and "
                 f"the lr-0 update leave every other leaf bit-identical {unmoved} "
                 f"{'ok' if ok else 'FAILED'}; on make_smoke_data's tones the losses differ "
                 f"by {tones_rel:.2g} (reported)")
    if not ok:
        fail("train: the card's step disagrees with the CPU port")
    same = (tf_loss == card_loss and all(torch.equal(tf_g[n], card_g[n]) for n in card_g)
            and all(torch.equal(tf_st[k], card_st[k]) for k in card_st))
    say("train", f"f32 step with the global TF32 flags on: loss, gradients and state "
                 f"bit-identical {same}, the caller's flags kept {tf_kept} "
                 f"{'ok' if same and tf_kept else 'FAILED'}")
    if not (same and tf_kept):
        fail("train: the f32 step depends on the global TF32 flags")
    del m64, ref_g

    # -- the full training shape: 8 x 10 s (configs/cfg_train_dns3.yaml)
    B, secs = 8, 10.0
    noisy, clean = (torch.from_numpy(x).to(dev) for x in batch(B, secs, 8))
    first = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()  # the batch and what earlier phases hold
        torch.cuda.reset_peak_memory_stats()
        model, step = trainer(dev, dtype)
        losses = []

        def run_step():
            losses.append(step(noisy, clean))

        run_step()  # the first step also makes the loss's window on the card
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        ms = cuda_ms(torch, run_step, n=20, warm=1)
        prof = idle_share(lambda i: run_step(), n=5)
        while len(losses) < 30:
            run_step()
        peak = torch.cuda.max_memory_allocated() - base
        ls = [float(x) for x in losses]
        masters = all(t.dtype == torch.float32 for t in model.state_dict().values())
        first[name] = ls[0]
        ok = all(map(math.isfinite, ls)) and ls[-1] < ls[0] and masters
        say("train", f"{name} step B={B} x {secs:.0f} s ({B * int(secs * 16000)} samples): "
                     f"{ms:.2f} ms per step (CUDA events, median of 20), "
                     f"{B * secs / (ms / 1e3):.0f} s of audio per s, peak memory "
                     f"{peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held before "
                     f"(model, optimizer, step), {syncs} host syncs per step; loss over 30 steps "
                     f"{ls[0]:.3f} -> {ls[-1]:.3f}, masters float32 {masters} "
                     f"{'ok' if ok else 'FAILED'}; card {card}")
        say("train", f"{name}: " + prof)
        if not ok:
            fail(f"train: the {name} steps did not train")
        del model, step, losses
    rel = abs(first["bf16"] - first["f32"]) / first["f32"]
    say("train", f"bf16 step-1 loss {first['bf16']:.4f} vs f32 {first['f32']:.4f}: rel {rel:.2g} "
                 f"(bound 0.05) {'ok' if rel <= 0.05 else 'FAILED'}")
    if rel > 0.05:
        fail("train: the bf16 loss is not the f32 loss")
    del noisy, clean

    # -- end to end: train, resume, enhance, score
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        make_smoke_data(f"{d}/data", n_train=8, n_val=2, seconds=1.0)
        cfg = {"network": "gtcrn_micro", "seed": 43,
               "scheduler": {"kwargs": {"warmup_steps": 4, "decay_until_step": 40}},
               "train_dataset": {"noisy_root": f"{d}/data/train/noisy", "length_seconds": 1.0,
                                 "num_data_per_epoch": 8},
               "train_dataloader": {"batch_size": 8, "num_workers": 2},
               "valid_dataset": {"noisy_root": f"{d}/data/val/noisy", "length_seconds": 1.0,
                                 "train": False},
               "valid_dataloader": {"batch_size": 2, "num_workers": 2},
               "trainer": {"epochs": 2, "exp_path": f"{d}/exp", "log_every": 1}}
        t0 = time.perf_counter()
        exp = train_mod.run(cfg, device=dev)
        cfg["trainer"].update(epochs=3, resume=True, exp_path=exp)
        resumed = train_mod.run(cfg, device=dev)
        with open(f"{exp}/logs/metrics.jsonl") as f:
            val = [m for m in map(json.loads, f) if "val_loss" in m]
        steps = CheckpointManager(f"{exp}/checkpoints").steps()
        model = GTCRNMicro.from_params(infer.load_params(f"{exp}/checkpoints", device=dev),
                                       device=dev)
        infer.write_enhanced(model, f"{d}/data/val/noisy", f"{d}/data/val/clean", f"{d}/enh",
                             device=dev)
        intrusive.main(["--ref_scp", f"{d}/enh/ref.scp", "--inf_scp", f"{d}/enh/inf.scp",
                        "--output_dir", f"{d}/res", "--nj", "2"])
        with open(f"{d}/res/RESULTS.txt") as f:
            scores = dict(ln.split(": ") for ln in f if not ln.startswith("#"))
        scores = {k: float(v) for k, v in scores.items()}
        best = Path(f"{exp}/checkpoints/best_score.json").exists()
        wall = time.perf_counter() - t0
        kept = tempfile.mkdtemp(dir=build)
        shutil.copytree(f"{d}/enh", f"{kept}/enh")
        trained = tempfile.mkdtemp(dir=build)  # phase 13 serves it (phase 11 removes ``kept``)
        shutil.copytree(f"{exp}/checkpoints", f"{trained}/checkpoints")
        scp = Path(f"{kept}/enh/inf.scp")
        scp.write_text(scp.read_text().replace(f"{d}/enh", f"{kept}/enh"))
    ok = (resumed == exp and [(m["epoch"], m["step"]) for m in val] == [(1, 1), (2, 2), (3, 3)]
          and all(math.isfinite(m["val_loss"]) for m in val) and steps == [1, 2, 3] and best
          and all(math.isfinite(scores[k]) for k in ("SDR", "SISNR", "STOI")))
    say("train", f"train.run 2 epochs, resume to 3 (epoch, step) {[(m['epoch'], m['step']) for m in val]}, "
                 f"val_loss {[round(m['val_loss'], 3) for m in val]}, checkpoints {steps}, "
                 f"best_score.json {best}; enhance_wavs + eval.intrusive on the val wavs: "
                 + ", ".join(f"{k} {v:.4f}" for k, v in scores.items())
                 + f" ({wall:.1f} s) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("train: train -> resume -> enhance -> score")
    say("train", f"phase 7 took {time.perf_counter() - t_phase:.1f} s")
    return f"{kept}/enh", f"{trained}/checkpoints"


def tie_bounds(ref, got) -> tuple[bool, str]:
    """The bounds of the JAX package's int8 step test for two quantized
    paths, where a value on a rounding tie may flip by one quantum: median
    of the per-frame max-abs errors < 1e-6, worst < 5e-3 max|y|, every
    frame's SNR > 50 dB.  ``ref``, ``got``: (B, F, T, 2), frames on axis 2."""
    errs = [float((got[:, :, t] - ref[:, :, t]).abs().max()) for t in range(ref.shape[2])]
    snrs = [snr_db(ref[:, :, t], got[:, :, t]) for t in range(ref.shape[2])]
    mag = float(ref.abs().max())
    ok = (statistics.median(errs) < 1e-6 and max(errs) < 5e-3 * max(mag, 1.0)
          and min(snrs) > 50)
    return ok, (f"median frame max-abs {statistics.median(errs):.3g}, worst {max(errs):.3g} "
                f"(max|y| {mag:.3g}), min frame SNR {min(snrs):.1f} dB")


def quant_phase(torch, dev, params, card) -> dict:
    """Phase 8: PTQ calibration, the int8 fake-quant model, the full-integer
    int8 serving step and QAT on the card (``quant/``, ``ops/int8_step.py``;
    no kernel of this repo: the int8 products are ``torch._int_mm``)."""
    import numpy as np

    from gtcrn_micro_tpu_torch.dsp.stft import sqrt_hann_window, stft
    from gtcrn_micro_tpu_torch.models.folding import fold_bn_params
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, scan_stepper
    from gtcrn_micro_tpu_torch.ops.int8_step import Int8Serving
    from gtcrn_micro_tpu_torch.quant import qat
    from gtcrn_micro_tpu_torch.quant.ptq import QuantizedModel, observe_ranges, qparams_from_ranges
    from gtcrn_micro_tpu_torch.utils.make_smoke_data import smoke_pair
    from gtcrn_micro_tpu_torch.utils.profiling import idle_share
    from gtcrn_micro_tpu_torch.utils.roofline import H100_INT8_OPS, bound_ms

    t_phase = time.perf_counter()
    res = {}
    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}

    cpu = to_cpu(params)
    folded = fold_bn_params(cpu)  # the int8 step's numbers: BatchNorm folded on the host
    fmodel = GTCRNMicro.from_params(folded, device=dev)
    fmodel_cpu = GTCRNMicro.from_params(folded, device="cpu")

    # -- calibration: 16 seeded noisy wavs of 973 frames (15.6 s) each
    rng = np.random.default_rng(9)
    audio = np.stack([smoke_pair(rng, 972 * 256)[1] for _ in range(16)])
    window = sqrt_hann_window(512, device=dev)
    with torch.no_grad():
        specs = stft(torch.from_numpy(audio).to(dev), window)  # (16, 257, 973, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranges = observe_ranges(fmodel, specs, batch_size=8)
    calib_s = time.perf_counter() - t0
    finite = all(math.isfinite(lo) and math.isfinite(hi) for lo, hi in ranges.values())
    ok = len(ranges) == 59 and finite
    say("quant", f"observe_ranges on 16 specs x 973 frames, batch 8 (largest hook input "
                 f"{8 * 973 * 65 * 16:,} values): {len(ranges)} paths, finite {finite}, "
                 f"{calib_s:.2f} s {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("quant: observe_ranges")
    small = specs[:2, :, :64].contiguous()
    card_r = observe_ranges(fmodel, small, batch_size=2)
    cpu_r = observe_ranges(fmodel_cpu, small.cpu(), batch_size=2)
    rel = max(max(abs(a - b) for a, b in zip(card_r[p], cpu_r[p])) / max(map(abs, cpu_r[p]))
              for p in cpu_r)
    ok = set(card_r) == set(cpu_r) and rel <= 1e-5
    say("quant", f"ranges on 2 x 64 frames, card vs CPU port: worst gap {rel:.3g} of the path's "
                 f"largest bound (bound 1e-5) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("quant: the card's ranges disagree with the CPU port's")
    res["ranges_rel_gap"] = rel

    # -- the int8 fake-quant model: the card against the CPU, its ring step
    act_qp = qparams_from_ranges(ranges, 8)
    qm = QuantizedModel(fmodel, act_qp)
    qm_cpu = QuantizedModel(fmodel_cpu, act_qp)
    g = torch.Generator().manual_seed(10)
    spec = torch.randn((4, 257, 32, 2), generator=g) * 0.3
    off = qm.apply(spec.to(dev))
    ok1, msg1 = tie_bounds(qm_cpu.apply(spec), off.cpu())
    ring, _ = scan_stepper(qm.step, qm.init_state(4), spec.to(dev))
    ok2, msg2 = tie_bounds(off, ring)
    say("quant", f"int8 QuantizedModel.apply B=4 x 32 frames, card vs CPU: {msg1} "
                 f"{'ok' if ok1 else 'FAILED'}; ring step T=1 vs apply on the card: {msg2} "
                 f"{'ok' if ok2 else 'FAILED'}")
    if not (ok1 and ok2):
        fail("quant: the fake-quant model")

    serving = Int8Serving(cpu, act_qp, carry_dtype=torch.float32, device=dev)
    # -- torch._int_mm: its layout rules, then one layer's product vs the CPU
    rules = []
    a = torch.randint(-128, 128, (64, 32), generator=g, dtype=torch.int8).to(dev)
    w = torch.randint(-128, 128, (32, 16), generator=g, dtype=torch.int8).to(dev)
    for label, fn in (("A row-major, B row-major", lambda: torch._int_mm(a, w)),
                      ("B column-major", lambda: torch._int_mm(a, w.t().contiguous().t())),
                      ("A column-major", lambda: torch._int_mm(a.t().contiguous().t(), w)),
                      ("M=16", lambda: torch._int_mm(a[:16], w)),
                      ("M=17", lambda: torch._int_mm(a[:17], w)),
                      ("K=15", lambda: torch._int_mm(a[:, :15].contiguous(), w[:15])),
                      ("K=8", lambda: torch._int_mm(a[:, :8].contiguous(), w[:8])),
                      ("N=2", lambda: torch._int_mm(a, w[:, :2].contiguous()))):
        try:
            r = fn()
            torch.cuda.synchronize()
            exact = torch.equal(r.cpu(), a.cpu().int() @ w.cpu().int()) if label.startswith(
                ("A", "B")) else True
            rules.append(f"{label}: accepted{'' if exact else ' (WRONG)'}")
        except RuntimeError as e:
            rules.append(f"{label}: refused ({str(e).splitlines()[0][:70]})")
    say("quant", "torch._int_mm layout rules: " + "; ".join(rules))
    res["int_mm_rules"] = rules
    BS = 8192
    q = torch.randint(-128, 128, (BS, 33, 80), generator=g, dtype=torch.int8)
    m = serving.W["en1"]  # the weights only: no product has run yet
    acc = Int8Serving._mm(q.to(dev), m).cpu()
    want = Int8Serving._mm(q, {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in m.items()})
    ok = torch.equal(acc, want)
    say("quant", f"en1 product (M={BS * 33}, K=80, N=16) by torch._int_mm vs the CPU int32 "
                 f"product: bit-identical {ok} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("quant: torch._int_mm accumulators")

    # -- the int8 serving step against the card's fake-quant step: at the
    # JAX test's B=2, bounded; at B=256 reported (more values, so more ties
    # on which one quantum flips)
    for B8 in (2, 256):
        spec = (torch.randn((B8, 257, 20, 2), generator=g) * 0.3).to(dev)
        st8, st_sim = serving.init_state(B8), qm.init_state(B8)
        y8, ys = [], []
        for t in range(20):
            y8.append(serving.step(st8, spec[:, :, t : t + 1])[0])
            ys.append(qm.step(st_sim, spec[:, :, t : t + 1])[0])
        ok, msg = tie_bounds(torch.cat(ys, 2), torch.cat(y8, 2))
        verdict = ("ok" if ok else "FAILED") if B8 == 2 else "(reported)"
        say("quant", f"Int8Serving B={B8} x 20 frames (f32 carry) vs the fake-quant step on the "
                     f"card: {msg} {verdict}")
        if B8 == 2 and not ok:
            fail("quant: the int8 step disagrees with the fake-quant step")

    # -- the int8 step timed at 8,192 and 32,768 streams (bf16 skips)
    layered_bytes = sum(v.numel() * v.element_size() for k, v in
                        GTCRNMicro(device=dev).init_state(1, dtype=torch.bfloat16).items()
                        if k != "step")
    serving = Int8Serving(cpu, act_qp, device=dev)
    for B in (8192, 32768):
        st = serving.init_state(B)
        spec = (torch.randn((B, 257, 1, 2), generator=g) * 0.3).to(dev)
        ms = cuda_ms(torch, lambda: serving.step(st, spec), n=10, warm=3)
        nbytes = sum(v.numel() for k, v in st.items() if k != "step")
        res[f"int8_step_ms_B{B}"] = ms
        say("quant", f"Int8Serving step B={B} (bf16 skips): {ms:.3f} ms per step (CUDA events, "
                     f"median of 10), {B / (ms / 16):.0f} stream-hops per 16 ms; int8 state "
                     f"{nbytes / 2**20:.1f} MiB = {nbytes / B:.0f} B per stream, the layered bf16 "
                     f"state {layered_bytes * B / 2**20:.1f} MiB ({layered_bytes} B per stream); "
                     f"card {card}")
        say("quant", f"B={B}: " + idle_share(lambda i: serving.step(st, spec), n=5))
        qa = torch.randint(-128, 128, (B * 33, 80), dtype=torch.int8, device=dev)
        mm_ms = cuda_ms(torch, lambda: torch._int_mm(qa, m["w"]), n=10, reps=10)
        mm_bytes = qa.numel() + m["w"].numel() + 4 * B * 33 * 16
        mm_ops = 2 * B * 33 * 80 * 16
        mm_bound, by = bound_ms(mm_bytes, mm_ops, H100_INT8_OPS)
        res[f"int_mm_en1_ms_B{B}"] = mm_ms
        say("quant", f"B={B}: torch._int_mm of en1 (the step's largest contraction, M={B * 33}, "
                     f"K=80, N=16): {mm_ms:.4f} ms, bound {mm_bound:.4f} ms by {by} "
                     f"({mm_bound / mm_ms:.1%} of it)")
        del st, spec, qa

    # -- QAT: 20 steps at 8 x 4 s through the int8 fake-quant graph
    model = GTCRNMicro.from_params(params, device=dev)
    noisy = np.stack([smoke_pair(rng, 4 * 16000)[1] for _ in range(8)]).astype(np.float32)
    target = qat.enhance_fp32_batch(model, noisy)
    qat_qp = qat.calibrate_act_qparams(model, noisy)
    running = model.encoder.en0.bn.running_mean.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = qat.qat_finetune(model, noisy, target, qat_qp, steps=20, batch_size=8, max_lr=1e-3,
                              log_every=0)
    step_ms = (time.perf_counter() - t0) / 20 * 1e3
    ok = (all(map(math.isfinite, losses)) and statistics.mean(losses[-5:])
          < statistics.mean(losses[:5]) and torch.equal(model.encoder.en0.bn.running_mean, running))
    res.update(qat_step_ms=step_ms, qat_losses=losses)
    say("quant", f"QAT 20 steps B=8 x 4 s (int8 fake-quant, freeze_bn): {step_ms:.1f} ms per step "
                 f"(host clock, a loss read per step); loss {losses[0]:.4f} -> {losses[-1]:.4f} "
                 f"(mean of the first 5 {statistics.mean(losses[:5]):.4f}, last 5 "
                 f"{statistics.mean(losses[-5:]):.4f}), running statistics kept "
                 f"{'ok' if ok else 'FAILED'}; card {card}")
    if not ok:
        fail("quant: QAT did not train")
    say("quant", f"phase 8 took {time.perf_counter() - t_phase:.1f} s")
    res.update(act_qp=act_qp, folded=folded, ranges=ranges)
    return res


def multi_card_checks(torch, dev, params, card) -> dict:
    """What needs two cards: 2 NCCL ranks (one per card) against one
    process; the B2 bf16 audio server split over ``make_mesh(2)`` against the
    unsharded server (within 2^-7 of the largest magnitude) and against two
    shards on one card (reported), each card's backend launching its own
    kernel, the served step timed; then ``serve --devices 2``."""
    import contextlib
    import io
    import re

    from gtcrn_micro_tpu_torch import serve
    from gtcrn_micro_tpu_torch.parallel import multiproc
    from gtcrn_micro_tpu_torch.parallel.mesh import canonical, make_mesh

    res = {}
    errs = multiproc.compare(multiproc.run_ranks(2, "cuda"), multiproc.train_step(dev))
    ok = all(errs[k] <= 1 for k in ("loss", "params", "grads")) and errs["ranks"] == 0
    say("dist", f"2 NCCL ranks vs one process (4 x 4,096 samples, seed 7): worst over "
                f"bound loss {errs['loss']:.3g} (rtol 1e-5), params {errs['params']:.3g} "
                f"(atol 2e-5), gradients {errs['grads']:.3g} (1e-4 of the largest); ranks "
                f"agree {errs['ranks'] == 0} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("dist: two ranks disagree with one process")
    res["nccl_2_ranks_over_bound"] = errs

    BS, K, n_int, bf16 = 8192, 2, 8, torch.bfloat16
    meshes = {"unsharded": None, "two shards on cuda:0": [dev, dev], "make_mesh(2)": make_mesh(2)}
    srvs = {name: serve.CohortServer(None, params, batch=BS, n_cohorts=K, dtype=bf16,
                                     mode="audio", dft="mxu", device=None if m else dev, mesh=m)
            for name, m in meshes.items()}
    two = srvs["make_mesh(2)"]
    for s in srvs.values():
        for b in s.backends:
            b.launches = 0
    ga = torch.Generator(device=dev).manual_seed(14)
    worst = {"vs unsharded": 0.0, "vs two shards on cuda:0": 0.0}
    for _ in range(n_int):
        for c in range(K):
            chunk = torch.randn((BS, 256), generator=ga, device=dev).mul_(0.3).to(bf16)
            outs = {name: s.step(c, chunk).float() for name, s in srvs.items()}
            for key, ref in (("vs unsharded", outs["unsharded"]),
                             ("vs two shards on cuda:0", outs["two shards on cuda:0"])):
                worst[key] = max(worst[key], float((outs["make_mesh(2)"] - ref).abs().max())
                                 / float(ref.abs().max()))
    torch.cuda.synchronize()
    cards = [str(canonical(b.device)) for b in two.backends]
    launches = [b.launches for b in two.backends]
    ok = (worst["vs unsharded"] <= 2 ** -7 and cards == ["cuda:0", "cuda:1"]
          and launches == [n_int * K] * 2)
    res["two_card_worst_rel"] = worst
    say("dist", f"audio server B2 bf16 {n_int} intervals x {K} cohorts x {BS} streams over "
                f"make_mesh(2): worst {worst['vs unsharded']:.3g} of the largest magnitude vs "
                f"unsharded (bound 2^-7), {worst['vs two shards on cuda:0']:.3g} vs two shards on "
                f"one card (reported); backends on {cards}, B2 launches {launches} "
                f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("dist: serving over two cards disagrees with the unsharded server")
    chunk = torch.randn((BS, 256), generator=ga, device=dev).mul_(0.3).to(bf16)
    served = {name: [] for name in srvs}
    for name in list(srvs) + list(reversed(srvs)):
        served[name].append(cuda_ms(torch, lambda: srvs[name].step(0, chunk), n=30, warm=4))
    res["two_card_served_step_ms"] = served
    say("dist", "served step B=8192 bf16 (CUDA events on cuda:0, median of 30, in the order "
                "unsharded, two shards on one card, make_mesh(2), then reversed): " + "; ".join(
                    f"{name} {v[0]:.3f} / {v[1]:.3f} ms" for name, v in served.items())
        + f"; card {card}")
    del srvs, two

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--devices", "2", "--seconds", "1"])
    snr = re.search(r"SNR: (\S+) dB", buf.getvalue())
    ok = snr is not None and math.isfinite(float(snr.group(1)))
    say("dist", f"serve --devices 2 --seconds 1: {buf.getvalue().strip().splitlines()[-1]} "
                f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("dist: serve --devices 2 did not finish")
    return res


def dist_phase(torch, dev, params, card, act_qp, folded, native_build) -> dict:
    """Phase 9: data parallelism (a one-rank NCCL group's training step
    against no group, two ranks where two cards are present, sharded
    serving) and the deployment export (GTM1 and GTM8 written from the card
    against the CPU port's files, the native engine built by g++ on the host
    against B2 and the int8 fake-quant step on the card).  ``native_build``
    is the future of the engine's build, started with the kernels' build."""
    import os
    import tempfile
    import warnings

    import numpy as np
    import torch.distributed as dist

    from gtcrn_micro_tpu_torch.io.export_native import (
        export_native_weights,
        export_native_weights_int8,
    )
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro
    from gtcrn_micro_tpu_torch.ops.fused_grid import GridFusedGTCRNMicro
    from gtcrn_micro_tpu_torch.parallel import multiproc
    from gtcrn_micro_tpu_torch.quant.ptq import QuantizedModel
    from gtcrn_micro_tpu_torch.runtime.native import NativeEngine
    from gtcrn_micro_tpu_torch.serve import CohortServer
    from gtcrn_micro_tpu_torch.train.scheduler import WarmupCosineConfig
    from gtcrn_micro_tpu_torch.train.trainer import make_optimizer, make_train_step
    from gtcrn_micro_tpu_torch.utils.make_smoke_data import smoke_pair
    from gtcrn_micro_tpu_torch.utils.profiling import idle_share

    t_phase = time.perf_counter()
    res = {}
    sched = WarmupCosineConfig(warmup_steps=5, decay_until_step=100, max_lr=1e-3)
    cudnn = torch.backends.cudnn

    def trainer(group):
        model = GTCRNMicro.from_params(params, device=dev)
        opt = make_optimizer(model, sched, device=dev)
        return model, make_train_step(model, opt, device=dev, group=group)

    # -- a one-rank NCCL group: the identity, bit for bit (2 steps: the
    # second update has lr > 0), then its cost at the training shape
    rng = np.random.default_rng(7)  # phase 7's white noise
    clean = (rng.standard_normal((4, 16000)) * 0.05).astype(np.float32)
    noisy = clean + (rng.standard_normal((4, 16000)) * 0.02).astype(np.float32)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{multiproc.free_port()}",
                            rank=0, world_size=1)
    try:
        runs = []
        saved = cudnn.deterministic
        cudnn.deterministic = True  # only the group may differ between the two runs
        try:
            for group in (None, dist.group.WORLD):
                model, step = trainer(group)
                losses = [step(noisy, clean) for _ in range(2)]
                runs.append((torch.stack(losses).cpu(),
                             {k: v.cpu() for k, v in model.state_dict().items()},
                             {n: p.grad.cpu() for n, p in model.named_parameters()}))
        finally:
            cudnn.deterministic = saved
        (l0, s0, g0), (l1, s1, g1) = runs
        same = (torch.equal(l0, l1) and all(torch.equal(s0[k], s1[k]) for k in s0)
                and all(torch.equal(g0[k], g1[k]) for k in g0))
        say("dist", f"f32 step B=4 x 1 s, one-rank NCCL group vs no group, 2 steps: losses "
                    f"{l1.tolist()}, loss, gradients, params and running statistics "
                    f"bit-identical {same} {'ok' if same else 'FAILED'}")
        if not same:
            fail("dist: a one-rank group changed the training step")
        B, secs = 8, 10.0
        pairs = [smoke_pair(np.random.default_rng(8), int(secs * 16000)) for _ in range(B)]
        big = [torch.from_numpy(np.stack([p[i] for p in pairs])).to(dev) for i in (1, 0)]
        steps = {name: trainer(g)[1] for name, g in (("plain", None), ("group", dist.group.WORLD))}
        times = {name: [] for name in steps}
        for name in ("plain", "group", "group", "plain"):
            times[name].append(cuda_ms(torch, lambda: steps[name](*big), n=5, warm=1))
        res["train_step_ms"] = times
        syncs = {}
        for name, step in steps.items():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    step(*big)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs[name] = sum("synchroniz" in str(w.message) for w in caught)
        say("dist", f"f32 step B={B} x {secs:.0f} s (CUDA events, median of 5, in the order "
                    f"plain, group, group, plain): no group {times['plain'][0]:.2f} / "
                    f"{times['plain'][1]:.2f} ms, one-rank NCCL group {times['group'][0]:.2f} / "
                    f"{times['group'][1]:.2f} ms; host syncs per step {syncs}; card {card}")
        for name in ("plain", "group"):
            say("dist", f"{name}: " + idle_share(lambda i: steps[name](*big), n=5))
        # one bare all-reduce of a BatchNorm's 16 statistics, as the step issues it
        x = torch.zeros(16, device=dev)
        host_us = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                dist.all_reduce(x)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host_us.append((t1 - t0) / 100 * 1e6)
        dev_us = cuda_ms(torch, lambda: dist.all_reduce(x), n=10, reps=100) * 1e3
        res["all_reduce_host_us"], res["all_reduce_device_us"] = host_us, dev_us
        say("dist", f"dist.all_reduce of 16 floats on the one-rank NCCL group: host "
                    f"{', '.join(f'{u:.1f}' for u in host_us)} us per call to return (3 runs of "
                    f"100, host clock), {dev_us:.1f} us per call back to back (CUDA events)")
        del steps, big
    finally:
        dist.destroy_process_group()

    # -- two NCCL ranks and serving over two cards, where two cards are present
    if torch.cuda.device_count() >= 2:
        res.update(multi_card_checks(torch, dev, params, card))
    else:
        say("dist", f"{torch.cuda.device_count()} card present: the 2-rank NCCL check and serving "
                    f"over two cards need two (the first runs on gloo in "
                    f"tests/test_torch_parallel.py; `chip_smoke.py --multi-card` on two cards)")

    # -- sharded serving: B2 bf16, 8,192 x 2 cohorts, on no mesh, a one-device
    # mesh and two shards of 4,096 on this card
    BS, K, n_int, bf16 = 8192, 2, 8, torch.bfloat16
    meshes = {"unsharded": None, "mesh [cuda:0]": [dev], "mesh [cuda:0, cuda:0]": [dev, dev]}
    srvs = {name: CohortServer(None, params, batch=BS, n_cohorts=K, dtype=bf16, mode="audio",
                               dft="mxu", device=None if m else dev, mesh=m)
            for name, m in meshes.items()}
    for s in srvs.values():
        s.backends[0].launches = 0
    ga = torch.Generator(device=dev).manual_seed(12)
    worst = {name: 0.0 for name in srvs}
    for _ in range(n_int):
        for c in range(K):
            chunk = torch.randn((BS, 256), generator=ga, device=dev).mul_(0.3).to(bf16)
            outs = {name: s.step(c, chunk).float() for name, s in srvs.items()}
            ref = outs["unsharded"]
            for name, out in outs.items():
                worst[name] = max(worst[name], float((out - ref).abs().max())
                                  / float(ref.abs().max()))
    torch.cuda.synchronize()
    launches = {name: sum(b.launches for b in {id(b): b for b in s.backends}.values())
                for name, s in srvs.items()}
    ok = (worst["mesh [cuda:0]"] == 0.0 and worst["mesh [cuda:0, cuda:0]"] <= 2 ** -7
          and launches["unsharded"] == launches["mesh [cuda:0]"] == n_int * K
          and launches["mesh [cuda:0, cuda:0]"] == 2 * n_int * K)
    res["sharded_worst_rel"] = worst
    say("dist", f"audio server B2 bf16 {n_int} intervals x {K} cohorts x {BS} streams: one-device "
                f"mesh vs unsharded worst {worst['mesh [cuda:0]']:.3g} of the largest magnitude "
                f"(bound 0: bit-identical), two shards {worst['mesh [cuda:0, cuda:0]']:.3g} (bound "
                f"2^-7); B2 launches {launches} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("dist: sharded serving disagrees with the unsharded server")
    chunk = torch.randn((BS, 256), generator=ga, device=dev).mul_(0.3).to(bf16)
    served = {name: [] for name in srvs}
    for name in list(srvs) + list(reversed(srvs)):
        served[name].append(cuda_ms(torch, lambda: srvs[name].step(0, chunk), n=30, warm=4))
    res["served_step_ms"] = served
    say("dist", "served step B=8192 bf16 (CUDA events, median of 30, in the order unsharded, "
                "one-device mesh, two shards, then reversed): " + "; ".join(
                    f"{name} {v[0]:.3f} / {v[1]:.3f} ms" for name, v in served.items())
        + f"; card {card}")
    del srvs

    # -- export from the card, and the native engine on the host CPU
    def cpu(tree):
        return {k: cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}

    def to_dev(tree):
        return {k: to_dev(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    lib, build_s = native_build.result()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        paths = {k: os.path.join(d, k) for k in ("gtm1_card", "gtm1_cpu", "gtm8_card", "gtm8_cpu")}
        export_native_weights(params, paths["gtm1_card"])
        export_native_weights(cpu(params), paths["gtm1_cpu"])
        export_native_weights_int8(to_dev(folded), {p: q.to(dev) for p, q in act_qp.items()},
                                   paths["gtm8_card"])
        export_native_weights_int8(folded, {p: q.to("cpu") for p, q in act_qp.items()},
                                   paths["gtm8_cpu"])
        blobs = {k: open(p, "rb").read() for k, p in paths.items()}
        same1 = blobs["gtm1_card"] == blobs["gtm1_cpu"]
        same8 = blobs["gtm8_card"] == blobs["gtm8_cpu"]
        say("dist", f"GTM1 from the card's params ({len(blobs['gtm1_card'])} bytes) and GTM8 int8 "
                    f"from phase 8's ranges ({len(blobs['gtm8_card'])} bytes) vs the CPU port's "
                    f"export: byte-identical {same1} / {same8} {'ok' if same1 and same8 else 'FAILED'}")
        if not (same1 and same8):
            fail("dist: the export from the card differs from the CPU's")

        g = torch.Generator().manual_seed(13)
        spec = torch.randn((1, 257, 20, 2), generator=g) * 0.3
        eng = NativeEngine(paths["gtm1_card"], lib_path=lib)
        b2 = GridFusedGTCRNMicro(params, dtype=torch.float32, device=dev)
        st = b2.init_state(1)
        eng8 = NativeEngine(paths["gtm8_card"], lib_path=lib, quant="int8")
        qm = QuantizedModel(GTCRNMicro.from_params(to_dev(folded), device=dev), act_qp)
        st8 = qm.init_state(1)
        err, err8, mag8, host_s = 0.0, 0.0, 0.0, 0.0
        for t in range(20):
            frame = spec[:, :, t : t + 1]
            y = b2.step(st, frame.to(dev))[0].cpu().numpy()[0, :, 0]
            y8 = qm.step(st8, frame.to(dev))[0].cpu().numpy()[0, :, 0]
            t1 = time.perf_counter()
            yn, yn8 = eng.step(frame[0, :, 0].numpy()), eng8.step(frame[0, :, 0].numpy())
            host_s += time.perf_counter() - t1
            err, err8 = max(err, float(np.abs(yn - y).max())), max(err8, float(np.abs(yn8 - y8).max()))
            mag8 = max(mag8, float(np.abs(y8).max()))
        ok = err < 1e-5 and err8 < 5e-4 * max(mag8, 1.0)
        res.update(native_fp32_max_abs=err, native_int8_max_abs=err8, native_build_s=build_s)
        say("dist", f"NativeEngine (g++ build {build_s:.1f} s beside nvcc in phase 2, runs on the "
                    f"host CPU) on GTM1 vs "
                    f"kernel B2 f32 on the card, 20 frames x 1 stream: max-abs {err:.3g} (bound "
                    f"1e-5); on GTM8 vs the card's int8 fake-quant ring step: max-abs {err8:.3g} "
                    f"(bound 5e-4 x max(max|y| = {mag8:.3g}, 1)) {'ok' if ok else 'FAILED'}; host "
                    f"CPU time of one fp32 + one int8 engine step {host_s / 20 * 1e3:.3f} ms "
                    f"(host clock, not the card's)")
        if not ok:
            fail("dist: the native engine disagrees with the card")
    say("dist", f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return res


def rounding_phase(torch, dev, card, quant, native_build) -> dict:
    """Phase 10: AdaRound+LSQ, GPTQ and mixed 16/8 precision on the card
    (``quant/adaround.py``, ``gptq.py``, ``mixed.py``; no kernel of this
    repo) down to GTM8 artifacts that the native engine runs, and the
    complexity counter.  ``quant`` is phase 8's result (BN-folded params on
    the host, int8 activation params and their ranges)."""
    import tempfile
    import warnings

    import numpy as np

    from gtcrn_micro_tpu_torch.dsp.stft import istft, sqrt_hann_window, stft
    from gtcrn_micro_tpu_torch.io.export_native import export_native_weights_int8
    from gtcrn_micro_tpu_torch.io.wav import read_wav, write_wav
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, flatten
    from gtcrn_micro_tpu_torch.quant import adaround, gptq, mixed, qat
    from gtcrn_micro_tpu_torch.quant.fake_quant import fake_quant, weight_qparams
    from gtcrn_micro_tpu_torch.quant.ptq import QuantizedModel, observe_ranges, qparams_from_ranges
    from gtcrn_micro_tpu_torch.runtime.native import NativeEngine
    from gtcrn_micro_tpu_torch.utils import profiling
    from gtcrn_micro_tpu_torch.utils.complexity import model_complexity
    from gtcrn_micro_tpu_torch.utils.profiling import idle_share
    from gtcrn_micro_tpu_torch.utils.make_smoke_data import smoke_pair

    t_phase = time.perf_counter()
    res = {}
    folded, act_qp, ranges = quant["folded"], quant["act_qp"], quant["ranges"]
    fmodel = GTCRNMicro.from_params(folded, device=dev)
    fmodel_cpu = GTCRNMicro.from_params(folded, device="cpu")
    lib, _ = native_build.result()
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn

    def cpu(tree):
        return {k: cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}

    def tree_flat(tree):
        return {k.replace(".", "/"): v for k, v in flatten(tree).items()}

    # -- the corpus: five seeded 10 s wavs, 64 train + 8 val clips of 4 s
    # (the CLI's 384 + 48), a Hessian corpus of 16 clips (GPTQ's 96)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        rng = np.random.default_rng(15)
        for i in range(1, 6):
            clean, noisy_i = smoke_pair(rng, 10 * 16000)
            write_wav(f"{d}/noisy{i}.wav", noisy_i, 16000)
            write_wav(f"{d}/enh{i}.wav", clean, 16000)
        t0 = time.perf_counter()
        noisy, target, val_noisy, val_target = qat.build_augmented_corpus(
            fmodel, d, train_ids=(1, 2, 3), val_ids=(4,), n_train=64, n_val=8)
        hess = gptq.augmented_hessian_specs(fmodel, d, n_clips=16)
        corpus_s = time.perf_counter() - t0
        score_wavs = [read_wav(f"{d}/noisy{i}.wav")[0][: 4 * 16000] for i in (1, 2)]
    say("rounding", f"corpus from 5 seeded 10 s wavs: {noisy.shape[0]} train + {val_noisy.shape[0]} "
                    f"val clips of 4 s, Hessian specs {tuple(hess.shape)} ({corpus_s:.1f} s)")

    # -- AdaRound parity: one step from the same variables and batch, card vs
    # the CPU port (float32) and the CPU float64 step.  The variables are
    # moved off the zero-error init, where each pinned weight's h(V) sits on
    # the clip's bound and its (regulariser-only) gradient hangs on a tie
    nb, tb = noisy[:2, : 2 * 16000], target[:2, : 2 * 16000]
    run = adaround.AdaRound(fmodel, act_qp, reg_weight=2e-3)
    prng = np.random.default_rng(16)
    state = run.snapshot()
    state["v"] = {k: v + torch.from_numpy(prng.standard_normal(v.shape).astype(np.float32)).to(dev)
                  for k, v in state["v"].items()}
    state["a"] = {k: torch.from_numpy(np.asarray(prng.standard_normal(v.shape) * 0.05, np.float32))
                  for k, v in state["a"].items()}

    def one_step(model, tf32=False):
        r = adaround.AdaRound(model, act_qp, reg_weight=2e-3)
        r.load(state)
        saved = mm.allow_tf32, cudnn.allow_tf32, cudnn.deterministic
        mm.allow_tf32 = cudnn.allow_tf32 = tf32
        cudnn.deterministic = True
        try:
            loss, mse, reg, grads = r.gradients(nb, tb, 20.0)
        finally:
            mm.allow_tf32, cudnn.allow_tf32, cudnn.deterministic = saved
        return [float(loss), float(mse), float(reg)], {
            g: {k: t.detach().double().cpu() for k, t in gs.items()} for g, gs in grads.items()}

    card_l, card_g = one_step(fmodel)
    tf_l, tf_g = one_step(fmodel, tf32=True)
    cpu_l, cpu_g = one_step(fmodel_cpu)
    _, ref_g = one_step(GTCRNMicro.from_params(folded, dtype=torch.float64, device="cpu"))
    rel = max(abs(a / b - 1) for a, b in zip(card_l, cpu_l))

    def grad_err(gs, ref, g):  # worst leaf error over the group's largest reference gradient
        top = max(float(t.abs().max()) for t in ref[g].values())
        return max(float((gs[g][k] - t).abs().max()) for k, t in ref[g].items()) / top

    # the bound holds the card to the CPU port's float32 step: against the
    # float64 step both float32 steps carry the same tie flips of the
    # quantized forward (a value within an ulp of a rounding tie rounds the
    # other way in float64), reported
    errs = {g: (grad_err(card_g, cpu_g, g), grad_err(card_g, ref_g, g), grad_err(cpu_g, ref_g, g))
            for g in ("v", "a", "f")}
    ok = rel <= 1e-5 and all(e[0] <= 1e-4 for e in errs.values())
    same = tf_l == card_l and all(torch.equal(tf_g[g][k], card_g[g][k]) for g in card_g
                                  for k in card_g[g])
    res.update(adaround_step_rel=rel, adaround_grad_err=errs)
    say("rounding", f"AdaRound step 2 x 2 s, card vs CPU port: loss, MSE, regulariser "
                    f"{card_l[0]:.6g}, {card_l[1]:.6g}, {card_l[2]:.6g} (worst rel {rel:.2g}, bound "
                    f"1e-5); gradients, worst leaf error over each group's largest CPU float32 "
                    f"gradient: " + ", ".join(f"{g} {e[0]:.2g}" for g, e in errs.items())
                    + " (bound 1e-4); against the CPU float64 step, card / CPU float32 (reported): "
                    + ", ".join(f"{g} {e[1]:.2g} / {e[2]:.2g}" for g, e in errs.items())
                    + f" {'ok' if ok else 'FAILED'}; with the global TF32 flags on "
                    f"bit-identical {same} {'ok' if same else 'FAILED'}")
    if not (ok and same):
        fail("rounding: the AdaRound step on the card disagrees with the CPU port")

    # -- AdaRound at the CLI's shape, batch 8 x 4 s: one step timed, profiled
    timed = adaround.AdaRound(fmodel, act_qp, reg_weight=2e-3)
    b8, t8 = noisy[:8], target[:8]
    step_ms = profiling.time_fn(timed.step, b8, t8, 20.0, iters=10) * 1e3
    prof = idle_share(lambda i: timed.step(b8, t8, 20.0), n=5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            timed.step(b8, t8, 20.0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    res.update(adaround_step_ms=step_ms, adaround_syncs=syncs, adaround_peak_bytes=peak)
    say("rounding", f"AdaRound step B=8 x 4 s: {step_ms:.2f} ms per step (CUDA events through "
                    f"utils.profiling.time_fn, 10 steps), {syncs} host syncs per step, peak memory "
                    f"{peak / 2**20:.0f} MiB above the {base / 2**30:.2f} GiB held; card {card}")
    say("rounding", "AdaRound step: " + prof)

    # the bake on the card against the CPU port's bake of the same variables:
    # equal but where CUDA's and the CPU's float32 sigmoid put h(V) on the
    # two sides of 0.5 (a tie), the learned scales within 2 ulps (exp)
    cpu_run = adaround.AdaRound(fmodel_cpu, act_qp, reg_weight=2e-3)
    cpu_run.load(timed.snapshot())
    (b_card, q_card), (b_cpu, q_cpu) = timed.bake(), cpu_run.bake()
    b_card, b_cpu = tree_flat(cpu(b_card)), tree_flat(b_cpu)
    tmap = adaround.quantized_weight_tree_paths(fmodel_cpu, cpu_run.vars["v"])
    n_diff, n_tie, n_off = 0, 0, 0
    for spath, tpath in tmap.items():
        diff = b_card[tpath] != b_cpu[tpath]
        tie = ((adaround._h(timed.vars["v"][spath].detach()).cpu() >= 0.5)
               != (adaround._h(cpu_run.vars["v"][spath].detach()) >= 0.5))
        n_diff, n_tie = n_diff + int(diff.sum()), n_tie + int(tie.sum())
        n_off += int((diff & ~tie).sum())
    unpinned = sum(int((b_card[t] != b_cpu[t]).sum()) for t in b_card if t not in tmap.values())
    s_rel = max(float(((q_card[p].scale.cpu() - q_cpu[p].scale).abs() / q_cpu[p].scale).max())
                for p in q_cpu)
    ok = n_off == 0 and unpinned == 0 and s_rel <= 2.4e-7
    res.update(bake_codes_differ=n_diff, bake_ties=n_tie, bake_scale_rel=s_rel)
    say("rounding", f"bake after {timed.count['v']} steps, card vs the CPU port's bake of the same "
                    f"variables: {n_diff} of {sum(b.numel() for b in b_cpu.values())} values differ, "
                    f"all where the two float32 sigmoids put h(V) on either side of 0.5 ({n_tie} "
                    f"such; bound: no other), the float leaves equal {unpinned == 0}, learned scales "
                    f"within {s_rel:.2g} relative (bound 2.4e-7: exp) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("rounding: the card's bake differs from the CPU port's beyond the float32 ties")
    del timed, cpu_run, run

    # the CLI's loop: 40 steps, hard-rounded val SNR every 20, 20 bias-refine steps
    window = sqrt_hann_window(512, device=dev)

    def int8_mse(params, qp):
        """The int8 fake-quant model's audio MSE on the train clips."""
        qm = QuantizedModel(GTCRNMicro.from_params(params, device=dev), qp)
        err = 0.0
        for i in range(0, len(noisy), 16):
            with torch.no_grad():
                y = istft(qm.apply(stft(torch.from_numpy(noisy[i : i + 16]).to(dev), window)),
                          window, length=noisy.shape[1])
            err += float((y.cpu() - torch.from_numpy(target[i : i + 16])).square().sum())
        return err / target.size

    before = int8_mse(folded, act_qp)
    hist = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    baked, baked_qp = adaround.adaround_optimize(
        fmodel, noisy, target, act_qp, steps=40, batch_size=8, reg_weight=2e-3, log_every=0,
        val_noisy=val_noisy, val_target=val_target, eval_every=20, history=hist)
    art = adaround.bias_refine(GTCRNMicro.from_params(baked, device=dev), noisy, target,
                               baked_qp, steps=20, log_every=0)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    after = int8_mse(art, baked_qp)
    rvars, _, axes = adaround.init_rvars(fmodel, {p: q.to(dev) for p, q in act_qp.items()})
    mapping = adaround.quantized_weight_tree_paths(fmodel, rvars)
    old, new = tree_flat(folded), tree_flat(art)
    scale_ok, worst_off, moved = True, 0.0, 0
    for spath, tpath in mapping.items():
        w = new[tpath]
        qp_w = weight_qparams(w, axes[spath])
        scale_ok = scale_ok and torch.equal(qp_w.scale.cpu(), weight_qparams(old[tpath], axes[spath]).scale)
        worst_off = max(worst_off, float((fake_quant(w, qp_w) - w).abs().max() / w.abs().max()))
        moved += int(not torch.equal(w.cpu(), old[tpath]))
    zeros = all(torch.equal(baked_qp[p].zero.cpu(), q.zero) for p, q in act_qp.items())
    ok = (after < before * 1.05 and scale_ok and worst_off <= 1e-6 and zeros
          and all(math.isfinite(s) for _, s in hist))
    res.update(adaround_loop_s=loop_s, adaround_mse=(before, after), adaround_val=hist)
    say("rounding", f"adaround_optimize 40 steps B=8 x 4 s + bias_refine 20 steps: {loop_s:.1f} s; "
                    f"val SNR (hard) {', '.join(f'{s:.2f} dB at {i}' for i, s in hist)}; int8 "
                    f"fake-quant MSE on the 64 train clips {before:.4g} -> {after:.4g} (bound after "
                    f"< 1.05 before); {moved} of {len(mapping)} weights moved, each weight's scale "
                    f"re-observed bit-identical {scale_ok}, worst off-grid {worst_off:.2g} of max|w| "
                    f"(bound 1e-6), zero points kept {zeros} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("rounding: the AdaRound artifact")

    def native_check(path, quant_mode, params, qp):
        eng = NativeEngine(path, lib_path=lib, quant=quant_mode)
        qm = QuantizedModel(GTCRNMicro.from_params(params, device=dev), qp)
        st = qm.init_state(1)
        spec = torch.randn((1, 257, 20, 2), generator=torch.Generator().manual_seed(17)) * 0.3
        err, mag = 0.0, 0.0
        for t in range(20):
            frame = spec[:, :, t : t + 1]
            y = qm.step(st, frame.to(dev))[0].cpu().numpy()[0, :, 0]
            err = max(err, float(np.abs(eng.step(frame[0, :, 0].numpy()) - y).max()))
            mag = max(mag, float(np.abs(y).max()))
        eng.close()
        return err, mag

    with tempfile.TemporaryDirectory(dir=build) as d:
        export_native_weights_int8(art, baked_qp, f"{d}/ada_card.gtm8")
        export_native_weights_int8(cpu(art), {p: q.to("cpu") for p, q in baked_qp.items()},
                                   f"{d}/ada_cpu.gtm8")
        same = open(f"{d}/ada_card.gtm8", "rb").read() == open(f"{d}/ada_cpu.gtm8", "rb").read()
        err, mag = native_check(f"{d}/ada_card.gtm8", "int8", art, baked_qp)
    ok = same and err < 5e-4 * max(mag, 1.0)
    res["native_adaround_max_abs"] = err
    say("rounding", f"GTM8 of the AdaRound artifact from the card vs from its CPU copy: "
                    f"byte-identical {same}; NativeEngine(quant='int8') on it vs the card's int8 "
                    f"fake-quant ring step, 20 frames: max-abs {err:.3g} (bound 5e-4 x max(max|y| = "
                    f"{mag:.3g}, 1)) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("rounding: the AdaRound GTM8 artifact")

    # -- GPTQ on the card: a16 per-lane activations (tests/quant/test_gptq.py's grid)
    qp16 = qparams_from_ranges(observe_ranges(fmodel, hess, batch_size=8, per_channel=True), 16,
                               device=dev)
    report = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_baked = gptq.gptq_params(fmodel, qp16, hess, report=report)
    gptq_s = time.perf_counter() - t0
    new = tree_flat(g_baked)
    scale_ok, worst_off = True, 0.0
    for spath, tpath in mapping.items():
        w = new[tpath]
        qp_w = weight_qparams(w, axes[spath])
        scale_ok = scale_ok and torch.equal(qp_w.scale.cpu(), weight_qparams(old[tpath], axes[spath]).scale)
        worst_off = max(worst_off, float((fake_quant(w, qp_w) - w).abs().max() / w.abs().max()))
    err_g = sum(r["local_err"] for r in report)
    err_n = sum(r["nearest_err"] for r in report)
    flips = sum(r["flips"] for r in report)
    secs = sorted(r["seconds"] for r in report)
    ok = len(report) == 59 and scale_ok and worst_off <= 1e-6 and err_g < err_n
    res.update(gptq_s=gptq_s, gptq_boundary_s=secs, gptq_local_err=(err_g, err_n), gptq_flips=flips)
    say("rounding", f"gptq_params on the card, 16 Hessian clips x 4 s, a16 per-lane: {gptq_s:.1f} s, "
                    f"per boundary median {statistics.median(secs):.3f} s, max {secs[-1]:.3f} s "
                    f"({max(report, key=lambda r: r['seconds'])['path']}); 59 patch checks passed "
                    f"{len(report) == 59}; {flips} of {sum(r['size'] for r in report)} codes flipped "
                    f"against nearest; scales bit-identical {scale_ok}, worst off-grid "
                    f"{worst_off:.2g} of max|w| (bound 1e-6); summed local error {err_g:.4g} vs "
                    f"nearest {err_n:.4g} {'ok' if ok else 'FAILED'}; card {card}")
    if not ok:
        fail("rounding: GPTQ on the card")
    # the JAX test's small spec: the card's bake against the CPU port's
    small = np.asarray(np.random.default_rng(0).normal(size=(2, 257, 33, 2)) * 0.1, np.float32)
    qp_small = qparams_from_ranges(observe_ranges(fmodel_cpu, small, batch_size=2, per_channel=True),
                                   16)
    bakes = [tree_flat(cpu(gptq.gptq_params(m, qp_small, small))) for m in (fmodel, fmodel_cpu)]
    equal = total = far = 0
    for spath, tpath in mapping.items():
        scale = weight_qparams(old[tpath], axes[spath]).scale
        c_card, c_cpu = (torch.round(b[tpath] / scale) for b in bakes)
        equal += int((c_card == c_cpu).sum())
        total += c_card.numel()
        far += int(((c_card - c_cpu).abs() > 1).sum())
    ok = far == 0
    res["gptq_small_equal_share"] = equal / total
    say("rounding", f"gptq_params on 2 x 257 x 33 specs, card vs CPU port: {equal} of {total} codes "
                    f"equal ({equal / total:.2%}), {total - equal - far} one quantum apart, {far} "
                    f"further {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("rounding: GPTQ on the card disagrees with the CPU port by more than a quantum")

    # -- mixed precision: greedy lift on the AdaRound artifact, two 4 s wavs
    score = mixed.make_wav_scorer(GTCRNMicro.from_params(art, device=dev), score_wavs, ranges,
                                  baked_qp)
    n_scores, t0 = [0], time.perf_counter()

    def counted(lifted):
        n_scores[0] += 1
        return score(lifted)

    lifted, _, trail = mixed.greedy_lift(counted, list(ranges), float("inf"), 2,
                                             log=lambda s: None)
    greedy_s = time.perf_counter() - t0
    qp_mixed = mixed.compose_act_qp(ranges, lifted, baked_qp)
    with tempfile.TemporaryDirectory(dir=build) as d:
        export_native_weights_int8(art, qp_mixed, f"{d}/mixed_card.gtm8")
        export_native_weights_int8(cpu(art), {p: q.to("cpu") for p, q in qp_mixed.items()},
                                   f"{d}/mixed_cpu.gtm8")
        same = open(f"{d}/mixed_card.gtm8", "rb").read() == open(f"{d}/mixed_cpu.gtm8", "rb").read()
        err, mag = native_check(f"{d}/mixed_card.gtm8", "mixed", art, qp_mixed)
    ok = len(trail) == 2 and same and err < 5e-4 * max(mag, 1.0)
    res.update(greedy_s=greedy_s, greedy_scores=n_scores[0], greedy_trail=trail,
               native_mixed_max_abs=err)
    say("rounding", f"greedy_lift (max_lift 2) with make_wav_scorer on 2 wavs of 4 s: {n_scores[0]} "
                    f"scores in {greedy_s:.1f} s ({greedy_s / n_scores[0] * 1e3:.1f} ms per score); "
                    f"trail {', '.join(f'{p} {s:.2f} dB' for p, s in trail)}; GTM8 v2 card vs CPU "
                    f"byte-identical {same}; NativeEngine(quant='mixed') vs the card's mixed "
                    f"fake-quant ring step, 20 frames: max-abs {err:.3g} (bound 5e-4 x max(max|y| = "
                    f"{mag:.3g}, 1)) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("rounding: the mixed GTM8 artifact")

    # -- complexity on the card
    n_params, n_macs = model_complexity(fmodel)
    ok = (n_params, n_macs) == model_complexity(fmodel_cpu) and n_params == 19014
    say("rounding", f"model_complexity on the card: {n_params} parameters, {n_macs} MACs per second "
                    f"of audio, equal to the CPU port's {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("rounding: model_complexity")
    say("rounding", f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return res


def export_phase(torch, dev, params, card, enhanced: str) -> None:
    """Phase 11: DNSMOS and the portable exports on the card (``eval/dnsmos.py``
    over ``io/onnx.py``, ``io/onnx_export.py``, ``io/export_program.py``; no
    kernel of this repo runs but B2 as the reference server).  ``enhanced``
    is phase 7's copy of its enhanced wavs, removed at the end."""
    import importlib.util
    import shutil
    import tempfile

    import numpy as np

    from gtcrn_micro_tpu_torch.dsp import stream_dsp
    from gtcrn_micro_tpu_torch.dsp.stft import sqrt_hann_window
    from gtcrn_micro_tpu_torch.eval import dnsmos, evaluate
    from gtcrn_micro_tpu_torch.io import export_program as xp
    from gtcrn_micro_tpu_torch.io.onnx import OnnxModel
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, flatten
    from gtcrn_micro_tpu_torch.serve import CohortServer
    from gtcrn_micro_tpu_torch.utils.profiling import idle_share
    from gtcrn_micro_tpu_torch.utils.roofline import H100_F32_FLOPS

    t_phase = time.perf_counter()
    f32 = torch.float32
    work = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    rng = np.random.default_rng(11)

    # -- the DNSMOS models on the card against the CPU executor (TF32 off)
    inputs = {"sig_bak_ovr": (rng.standard_normal((3, 144160)) * 0.1).astype(np.float32),
              "model_v8": rng.uniform(-1, 1, (3, 900, 120)).astype(np.float32)}
    for name, x in inputs.items():
        path = str(Path(dnsmos.DEFAULT_MODEL_DIR) / f"{name}.onnx")
        got, want = OnnxModel(path, device=dev)(x)[0], OnnxModel(path, device="cpu")(x)[0]
        ok = bool(np.allclose(got, want, rtol=1e-4, atol=1e-5))
        say("export", f"DNSMOS {name} {x.shape}: card vs CPU executor max-abs "
                      f"{float(np.abs(got - want).max()):.3g} on outputs up to "
                      f"{float(np.abs(want).max()):.3g} (bound rtol 1e-4, atol 1e-5) "
                      f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"export: DNSMOS {name} on the card")

    # -- DnsmosScorer: 8 seeded 12 s clips (3 segments each), card vs CPU
    def clip(i):
        r = np.random.default_rng(100 + i)
        t = np.arange(12 * 16000) / 16000
        tone = 0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t) * (1 + np.sin(2 * np.pi * 3 * t)) / 2
        return (tone + 0.05 * r.standard_normal(t.shape)).astype(np.float32)

    clips = [clip(i) for i in range(8)]
    scorer, cpu_scorer = dnsmos.DnsmosScorer(device=dev), dnsmos.DnsmosScorer(device="cpu")
    scorer(clips[0])  # warm up cuDNN's plans
    t0 = time.perf_counter()
    got = [scorer(c) for c in clips]  # each returns host floats: the wall clock is the card's
    wall = time.perf_counter() - t0
    want = [cpu_scorer(c) for c in clips]
    gap = max(abs(g[k] - w[k]) for g, w in zip(got, want) for k in dnsmos.METRICS)
    means = {k: statistics.fmean(g[k] for g in got) for k in dnsmos.METRICS}
    say("export", f"DnsmosScorer 8 clips x 12 s: card vs CPU max |MOS gap| {gap:.3g} (bound 1e-4) "
                  f"{'ok' if gap < 1e-4 else 'FAILED'}; mean " + ", ".join(
                      f"{k} {v:.4f}" for k, v in means.items())
                  + f"; {len(clips) / wall:.2f} clips per second ({wall * 1e3 / len(clips):.2f} "
                    f"ms per clip, host clock, mel on the host)")
    if gap >= 1e-4:
        fail("export: DnsmosScorer on the card")
    segs = dnsmos.segments(clips[0])
    t0 = time.perf_counter()
    mel = np.stack([dnsmos.audio_melspec(s[:-160]) for s in segs])
    mel_ms = (time.perf_counter() - t0) * 1e3 / len(segs)
    segs_d, mel_d = torch.from_numpy(segs).to(dev), torch.from_numpy(mel).to(dev)
    n = len(segs)
    from torch.utils.flop_counter import FlopCounterMode

    flops = {}
    for name, model_, arg in (("p835", scorer.primary, segs_d[:1]), ("p808", scorer.p808, mel_d[:1])):
        with FlopCounterMode(display=False) as fc:
            model_.run(arg)
        flops[name] = fc.get_total_flops()
    p835 = cuda_ms(torch, lambda: scorer.primary.run(segs_d), n=10)
    p835_1 = cuda_ms(torch, lambda: scorer.primary.run(segs_d[:1]), n=10)
    p808 = cuda_ms(torch, lambda: scorer.p808.run(mel_d), n=10)
    p808_1 = cuda_ms(torch, lambda: scorer.p808.run(mel_d[:1]), n=10)
    say("export", f"DNSMOS ms per 9.01 s segment (CUDA events, {n} segments per call / 1): "
                  f"P.835 sig_bak_ovr {p835 / n:.3f} / {p835_1:.3f}, P.808 model_v8 "
                  f"{p808 / n:.3f} / {p808_1:.3f}; bound by operations "
                  f"{flops['p835'] / H100_F32_FLOPS * 1e3:.3f} / {flops['p808'] / H100_F32_FLOPS * 1e3:.4f} "
                  f"ms ({flops['p835'] / 1e9:.2f} / {flops['p808'] / 1e9:.3f} GFLOP per segment at "
                  f"67 TFLOP/s f32, no TF32); the log-mel on the host {mel_ms:.2f} ms per segment "
                  f"(host clock)")
    say("export", "DnsmosScorer per 12 s clip: "
                  + idle_share(lambda i: scorer(clips[i % len(clips)]), n=8))

    # -- evaluate -C <YAML written here> --metric dnsmos on phase 7's enhanced wavs
    cfg = work / "cfg_infer.yaml"
    cfg.write_text("# cfg_infer-style config (configs/cfg_infer.yaml) written by phase 11\n"
                   f"network:\n  exp_path: {Path(enhanced).parent}\n"
                   "  enh_folder: ${network.exp_path}/enh  # interpolated\n")
    t0 = time.perf_counter()
    had_yaml = importlib.util.find_spec("yaml") is not None
    saved = sys.modules.get("yaml")
    sys.modules["yaml"] = None  # any import of PyYAML now raises: the port's reader alone
    try:
        evaluate.main(["-C", str(cfg), "--metric", "dnsmos", "--device", str(dev)])
    finally:
        if saved is None:
            del sys.modules["yaml"]
        else:
            sys.modules["yaml"] = saved
    lines = (Path(enhanced) / "RESULTS_dnsmos" / "RESULTS.txt").read_text().splitlines()
    scores = {ln.split(": ")[0]: float(ln.split(": ")[1]) for ln in lines}
    ok = list(scores) == list(dnsmos.METRICS) and all(1 <= v <= 5 for v in scores.values())
    say("export", f"evaluate -C {cfg.name} --metric dnsmos on phase 7's "
                  f"{len((Path(enhanced) / 'inf.scp').read_text().splitlines())} enhanced wavs "
                  f"(PyYAML installed here: {had_yaml}; blocked for the call): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in scores.items())
                  + f" ({time.perf_counter() - t0:.1f} s) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("export: evaluate --metric dnsmos")

    # -- the export CLI on the card: every format, then GTM8 against the CPU port's
    ckpt = work / "params.npz"
    np.savez(ckpt, **{k.replace(".", "/"): v.cpu().numpy() for k, v in flatten(params).items()})
    t0 = time.perf_counter()
    xp.main(["--checkpoint", str(ckpt), "--out_dir", str(work / "card"), "--device", str(dev)])
    cli_s = time.perf_counter() - t0
    files = sorted(p.name for p in (work / "card").iterdir())
    t0 = time.perf_counter()
    xp.main(["--checkpoint", str(ckpt), "--out_dir", str(work / "card"), "--format", "native-int8",
             "--calib_dir", enhanced, "--device", str(dev)])
    xp.main(["--checkpoint", str(ckpt), "--out_dir", str(work / "cpu"), "--format", "native-int8",
             "--calib_dir", enhanced, "--device", "cpu"])
    int8_s = time.perf_counter() - t0
    gtm8 = [(work / d / "gtcrn_micro_w8a16.bin").read_bytes() for d in ("card", "cpu")]
    head = len(gtm8[1]) - 8 * 59  # GTM8 v1: weights, then (scale f32, zero i32) per path
    pair = np.dtype([("scale", "<f4"), ("zero", "<i4")])
    qp = [np.frombuffer(b[head:], pair) for b in gtm8]
    scale_gap = float(np.max(np.abs(qp[0]["scale"] - qp[1]["scale"]) / qp[1]["scale"]))
    ok = (len(files) == 7 and len(gtm8[0]) == len(gtm8[1]) and gtm8[0][:head] == gtm8[1][:head]
          and (qp[0]["zero"] == qp[1]["zero"]).all() and scale_gap <= 1e-6)
    say("export", f"export_program.main --format all on the card: {', '.join(files)} in "
                  f"{cli_s:.1f} s; --format native-int8 --calib_dir (phase 7's wavs), card and CPU "
                  f"port, in {int8_s:.1f} s: GTM8 {len(gtm8[0])} bytes, weights "
                  f"{'byte-identical' if gtm8[0][:head] == gtm8[1][:head] else 'DIFFER'}, zero points "
                  f"{'equal' if (qp[0]['zero'] == qp[1]['zero']).all() else 'DIFFER'}, activation "
                  f"scales within {scale_gap:.3g} (bound 1e-6), whole file "
                  f"{'byte-identical' if gtm8[0] == gtm8[1] else 'not byte-identical'} "
                  f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("export: the export CLI on the card")

    # -- the CLI's ONNX files on the card's executor against the layered model
    model = GTCRNMicro.from_params(params, device=dev)
    window = sqrt_hann_window(512, device=dev)
    spec = torch.from_numpy(rng.standard_normal((1, 257, 63, 2)).astype(np.float32)).to(dev)
    onnx = {p: OnnxModel(str(work / "card" / p), device=dev)
            for p in ("gtcrn_micro.onnx", "gtcrn_micro_stream.onnx", "gtcrn_micro_audio.onnx")}
    results = {"offline": (torch.from_numpy(onnx["gtcrn_micro.onnx"](spec.cpu().numpy())[0]),
                           model.apply(spec).detach().cpu())}
    state = model.init_state(1, ring=False)
    keys = sorted(state)
    caches = [state[k].cpu().numpy() for k in keys]
    got, want = [], []
    for t in range(20):
        frame = torch.from_numpy(rng.standard_normal((1, 257, 1, 2)).astype(np.float32)).to(dev)
        res = onnx["gtcrn_micro_stream.onnx"](*caches, frame.cpu().numpy())
        caches = res[1:]
        got.append(torch.from_numpy(res[0]))
        want.append(model.step(state, frame)[0].cpu())
    results["stream"] = (torch.cat(got, 2), torch.cat(want, 2))
    step = stream_dsp.make_audio_step(model, window, dft="mxu")
    dsp, state = stream_dsp.init_dsp_state(1, device=dev), model.init_state(1, ring=False)
    flat = [np.zeros((1, 256), np.float32)] * 2 + [state[k].cpu().numpy() for k in keys]
    got, want = [], []
    for t in range(20):
        c = (rng.standard_normal((1, 256)) * 0.3).astype(np.float32)
        res = onnx["gtcrn_micro_audio.onnx"](*flat, c)
        flat = res[1:]
        got.append(torch.from_numpy(res[0]))
        want.append(step(dsp, state, torch.from_numpy(c).to(dev))[0].cpu())
    results["audio"] = (torch.cat(got, -1), torch.cat(want, -1))
    for name, (g, w) in results.items():
        err, snr = float((g - w).abs().max()), snr_db(w, g)
        ok = err <= 1e-5 and snr >= 80
        say("export", f"ONNX {name} (port-emitted, on the card's executor) vs the layered model: "
                      f"max-abs {err:.3g} (bound 1e-5), SNR {snr:.1f} dB (bound 80 dB) "
                      f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"export: ONNX {name} on the card")

    # -- the exported audio program, T = 1 and 4, 40 hops at B = 64, against
    #    CohortServer on kernel B2 (f32) and the layered server
    B, hops = 64, 40
    x = torch.from_numpy((rng.standard_normal((B, 256 * hops)) * 0.3).astype(np.float32)).to(dev)
    b2 = CohortServer(None, params, batch=B, n_cohorts=1, dtype=f32, mode="audio", dft="mxu",
                      device=dev)
    ref_b2 = torch.cat([b2.step(0, x[:, 256 * t: 256 * (t + 1)]) for t in range(hops)], -1)
    for T in (1, 4):
        t0 = time.perf_counter()
        path = work / f"audio_T{T}.pt2"
        path.write_bytes(xp.export_audio(model, B, T))
        prog = xp.load_exported(str(path))
        export_s = time.perf_counter() - t0
        layered = CohortServer(model, None, batch=B, n_cohorts=1, dtype=f32, mode="audio",
                               dft="mxu", device=dev, chunk_hops=T)
        ref_l = torch.cat([layered.step(0, x[:, 256 * T * t: 256 * T * (t + 1)])
                           for t in range(hops // T)], -1)
        carry = [torch.zeros(B, 256, device=dev), torch.zeros(B, 256, device=dev),
                 model.init_state(B)]
        outs = []
        for t in range(hops // T):
            out, *carry = prog(*carry, x[:, 256 * T * t: 256 * T * (t + 1)])
            outs.append(out)
        got = torch.cat(outs, -1)
        snr_b2, snr_l = snr_db(ref_b2, got), snr_db(ref_l, got)
        err_l = float((got - ref_l).abs().max())
        ok = snr_b2 >= 80 and snr_l >= 80 and int(carry[2]["step"]) == hops % 16
        chunk = x[:, : 256 * T]
        ms = cuda_ms(torch, lambda: prog(*carry, chunk), n=20)
        layered_ms = cuda_ms(torch, lambda: layered.step(0, chunk), n=20)
        say("export", f"exported audio program T={T} (export + save + load {export_s:.1f} s), "
                      f"{hops} hops at B={B} f32: SNR {snr_b2:.1f} dB vs CohortServer on B2, "
                      f"{snr_l:.1f} dB (max-abs {err_l:.3g}) vs the layered server (bound 80 dB), "
                      f"counter {int(carry[2]['step'])} {'ok' if ok else 'FAILED'}; "
                      f"{ms:.3f} ms per step ({ms / T:.3f} per hop) against the layered "
                      f"server's {layered_ms:.3f} ms (CUDA events)")
        if not ok:
            fail(f"export: the exported audio program T={T}")
        if T == 1:
            say("export", "exported audio program T=1, B=64: "
                          + idle_share(lambda i: prog(*carry, chunk), n=10))
    del b2
    shutil.rmtree(work)
    shutil.rmtree(Path(enhanced).parent)
    say("export", f"phase 11 took {time.perf_counter() - t_phase:.1f} s")


def run_main(phase: str, label: str, main, argv, echo=True, **kwargs):
    """``main(argv, **kwargs)`` with its standard output captured and, with
    ``echo``, printed under ``[phase]``; returns (its result, seconds)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = main(argv, **kwargs)
    if echo:
        for ln in buf.getvalue().splitlines():
            if ln.strip():
                print(f"[{phase}]   {label}: {ln}", flush=True)
    return res, time.perf_counter() - t0


def bench_phase(card) -> dict:
    """Phase 12: the port's measuring entry points on the card
    (``gtcrn_micro_tpu_torch/bench.py``, ``scripts/``), each cut to fit the
    run.  Returns the launches of each kernel they counted."""
    from gtcrn_micro_tpu_torch.scripts import bench_int8, roofline, serve_soak, train_speed

    t_phase = time.perf_counter()
    launches = {"fused_grid_b2": 0, "fused_step_b1": 0}
    say("bench", "cuts against the JAX defaults: bench --budget 45 (420); soak 5 s after 2 s of "
                 "warm-up (30 after 20), admissions every 0.5 s (2); bench_int8 at 4,096 and "
                 "32,768 with a chain of 20 (4 batches, 200); train_speed 8 x 10 s with a chain "
                 "of 4 (16 and 64 x 8 s, 12); roofline at 8,192 as in JAX, then B1 with the "
                 "bandwidth reused")

    def run(label, main, argv, echo=True):
        return run_main("bench", label, main, argv, echo)

    # -- the headline bench, as its users run it, in a process of its own
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gtcrn_micro_tpu_torch.bench", "--budget", "45"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    bench_s = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for ln in lines:
        print(f"[bench]   bench: {ln}", flush=True)
    if proc.returncode:
        fail(f"bench exited {proc.returncode}: {proc.stderr[-2000:]}")
    payloads = [ln for ln in lines if ln.startswith("{")]
    verified = [json.loads(ln[len("# verified: "):]) for ln in lines if ln.startswith("# verified: ")]
    if len(payloads) != 1 or len(verified) != 1:
        fail(f"bench printed {len(payloads)} JSON lines and {len(verified)} verified lines")
    head, v = json.loads(payloads[0]), verified[0]
    plan = v["plan"] or {}
    b, k, step = plan.get("batch", 0), plan.get("cohorts", 0), plan.get("step_s") or 0.0
    ok = (head["metric"] == "concurrent_realtime_streams" and head["value"] > 0
          and head["value"] == b * k and k * step <= 0.016 and step + 0.016 / k <= 0.010
          and v["backend"] == "grid" and v["launches"] > 0)
    launches["fused_grid_b2"] += v["launches"] or 0
    dev_s = (f"{plan['event_s'] * 1e3:.3f} ms/step by CUDA events, device busy "
             f"{plan['busy_s'] * 1e3:.3f} ms/step, idle share {plan['idle']:.1%} (torch.profiler)"
             if "busy_s" in plan else "CUDA events and idle share not measured")
    say("bench", f"bench --budget 45 ({bench_s:.1f} s): {head['value']} streams "
                 f"(vs_baseline {head['vs_baseline']:.2f}) = K={k} x {b} on B2 bf16, "
                 f"{step * 1e3:.3f} ms/step round-robin (host clock), {dev_s}, keep-up "
                 f"{k * step * 1e3:.2f}/16 ms, latency {(step + 0.016 / max(k, 1)) * 1e3:.2f}/10 "
                 f"ms, {v['launches']} B2 launches {'ok' if ok else 'FAILED'}; card {card}")
    if not ok:
        fail("bench: no verified real-time plan on B2")

    # -- the paced soak at the verified plan
    rep, soak_s = run("serve_soak", serve_soak.main,
                      ["--batch", str(b), "--cohorts", str(k), "--seconds", "5",
                       "--warm-seconds", "2", "--admit-every", "0.5"], echo=False)
    ok = (bool(rep) and rep["nonfinite_steps"] == 0 and rep["launches"] == rep["steps_fired"]
          and rep["releases"] >= 1 and rep["released_dirty"] == rep["releases"]
          and rep["readmits_checked"] >= 1 and rep["readmits_nonzero"] == 0)
    launches["fused_grid_b2"] += rep.get("launches", 0)
    if rep:
        lat = rep["latency_ms"]
        say("bench", f"serve_soak K={k} x {b} B2 bf16 ({soak_s:.1f} s): {rep['intervals']} paced "
                     f"intervals, {rep['probes']} probes, latency p50 {lat['p50']:.3f} / p90 "
                     f"{lat['p90']:.3f} / p99 {lat['p99']:.3f} / max {lat['max']:.3f} ms, p99 + "
                     f"phase {rep['p99_plus_phase_ms']:.3f}/10 ms, enqueue overruns "
                     f"{rep['enqueue_overruns']}, probe-artifact overruns "
                     f"{rep['probe_artifact_overruns']}, budget misses {rep['budget_misses']}, "
                     f"pass {rep['pass']} (reported, not enforced); warm step "
                     f"{rep['warm_ms_per_step']:.3f} ms; {rep['admits']} admits, "
                     f"{rep['releases']} releases of dirty slots ({rep['released_dirty']}), "
                     f"{rep['readmits_checked']} readmitted slots zero "
                     f"({rep['readmits_nonzero']} not), non-finite steps {rep['nonfinite_steps']}, "
                     f"{rep['launches']} B2 launches for {rep['steps_fired']} steps "
                     f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"serve_soak failed its checks: {rep}")

    # -- the int8 step, the training rate, the roofline
    res8, s8 = run("bench_int8", bench_int8.main, ["4096", "32768", "--chain", "20"])
    ok = set(res8) == {4096, 32768} and all(math.isfinite(x) and x > 0 for x in res8.values())
    say("bench", "bench_int8 (%.1f s): %s %s" % (s8, ", ".join(
        f"{bb}: {t * 1e3:.3f} ms/frame, {t / bb * 1e9:.1f} ns/stream "
        f"[{bench_int8.rt_verdict(t)}]" for bb, t in res8.items()), "ok" if ok else "FAILED"))
    if not ok:
        fail("bench_int8 failed")
    rest, st = run("train_speed", train_speed.main,
                   ["--crop_s", "10", "--batches", "8", "--chain", "4"])
    ok = len(rest) == 2 and all(math.isfinite(r["step_s"]) and r["peak_bytes"] > 0
                                for r in rest.values())
    say("bench", "train_speed 8 x 10 s (%.1f s): %s %s" % (st, "; ".join(
        f"{lab}: {r['step_s'] * 1e3:.1f} ms/step (host), {r['event_s'] * 1e3:.1f} (CUDA events), "
        f"{r['audio_x']:.0f}x real-time, peak {r['peak_bytes'] / 2**30:.2f} GiB"
        for (_b, lab), r in rest.items()), "ok" if ok else "FAILED"))
    if not ok:
        fail("train_speed failed")
    roof, sr = run("roofline", roofline.main, ["--batch", "8192"])
    roof1, _ = run("roofline B1", roofline.main,
                   ["--batch", "8192", "--backend", "step", "--bw_gb", str(roof["bw_gb"])])
    launches["fused_grid_b2"] += roof["launches"]
    launches["fused_step_b1"] += roof1["launches"]
    ok = roof["bw_gb"] > 0 and roof["launches"] > 0 and roof1["launches"] > 0
    say("bench", f"roofline 8,192 ({sr:.1f} s): bandwidth {roof['bw_gb']:.0f} GB/s, served step "
                 f"B2 {roof['step_s'] * 1e3:.3f} ms / B1 {roof1['step_s'] * 1e3:.3f} ms, fused "
                 f"forward bound {roof['op_bound_ms']:.4f} ms by {roof['bound_by']} "
                 f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("roofline failed")
    if not all(launches.values()):
        fail(f"phase 12 launched a kernel of its path no time: {launches}")
    say("bench", f"kernel launches in phase 12: {launches}; phase 12 took "
                 f"{time.perf_counter() - t_phase:.1f} s")
    return launches


@contextlib.contextmanager
def cut(module, **values):
    """Set ``module``'s loop-count constants to ``values`` for the block."""
    saved = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def rest_phase(torch, dev, card, trained: str) -> dict:
    """Phase 13: the rest of the entry points on the card -- the model demo,
    the complexity CLI, ``serve --checkpoint``, ``scripts/smoke_all`` in its
    own process, the reference-scale traversal at a small horizon and its
    snapshot, and the layered model's probes.  ``trained`` is phase 7's
    checkpoint directory (removed at the end).  Returns the launches of each
    kernel it counted."""
    import shutil
    import tempfile

    import numpy as np

    from gtcrn_micro_tpu_torch import serve
    from gtcrn_micro_tpu_torch.eval.infer import load_params
    from gtcrn_micro_tpu_torch.models import gtcrn_micro
    from gtcrn_micro_tpu_torch.nn import blocks
    from gtcrn_micro_tpu_torch.scripts import (
        ab_psum,
        ablate_shuffle,
        int8_microbench,
        leak_probe,
        ref_scale_run,
        ref_scale_snapshot,
        ring_bank_microbench,
        sweep_chunk,
    )
    from gtcrn_micro_tpu_torch.utils import complexity
    from gtcrn_micro_tpu_torch.utils.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    launches = {"fused_grid_b2": 0, "fused_step_b1": 0}
    say("rest", "cuts against the JAX defaults: ref_scale_run 128 clips (10,000), 4 epochs x 16 "
                "steps (22 x 1,250), warmup 40 (25,000), SIGKILL at step 20 (13,000), log every "
                "4 (50), poll 0.25 s (20), batch 8 x 10 s kept; sweep_chunk at 8,192 only (six "
                "batches) with 48 frames a chain and 6 steps at least (192, 24); ab_psum 8192 "
                "with chains of 16 (96) and 2 repeats (5); ablate_shuffle chains of 32 (160); "
                "leak_probe 100 steps a mode (600), logged every 25 (50); smoke_all, "
                "int8_microbench and ring_bank_microbench uncut")
    work = tempfile.mkdtemp(dir=ROOT / "build")
    smoke_log = open(f"{work}/smoke_all.log", "w")
    t_smoke = time.perf_counter()
    # every CLI end to end in a process of its own, the traversal's driver beside it
    smoke = subprocess.Popen([sys.executable, "-m", "gtcrn_micro_tpu_torch.scripts.smoke_all",
                              "--root", f"{work}/smoke"], cwd=ROOT, stdout=smoke_log,
                             stderr=subprocess.STDOUT)
    try:
        # -- the reference-scale traversal at a small horizon, and its snapshot
        horizon = dict(clips=128, seconds=10.0, warmup=40, epochs=4, steps_per_epoch=16,
                       log_every=4, poll_s=0.25)
        rc, secs = run_main("rest", "ref_scale_run", ref_scale_run.main,
                            ["--root", f"{work}/ref", "--kill-at-step", "20"], echo=False,
                            **horizon)
        with open(f"{work}/ref/summary.json") as f:
            summ = json.load(f)
        recs = ref_scale_run.read_metrics(summ["exp_dir"])
        lr = [(r["step"], r["lr"]) for r in recs if "lr" in r]
        rising = [v for s_, v in sorted(dict(lr).items()) if s_ <= 40]
        seams = summ["seam_continuity"]
        best_dir = CheckpointManager(f"{summ['exp_dir']}/checkpoints/best").steps()
        ok = (rc == 0 and summ["lr_peak_step"] == 40
              and all(a < b for a, b in zip(rising, rising[1:]))
              and summ["lr_at_36"] < summ["lr_at_40"] and len(seams) == 1
              and summ["restarts"] == 1 and len(summ["driver_seams"]) == 1
              and summ["driver_seams"][0]["resumed_from_ckpt_step"] < seams[0]["resumed_at_step"]
              and summ["final_step"] == 64 and summ["checkpoint_steps_on_disk"] == [16, 32, 48, 64]
              and summ["best"] is not None and best_dir == [summ["best"]["best_step"]])
        say("rest", f"ref_scale_run 128 x 10 s, batch 8, 64 steps, warmup 40 ({secs:.1f} s): "
                    f"SIGKILL at logged step {summ['killed_at_logged_step']}, resumed from "
                    f"checkpoint {summ['driver_seams'][0]['resumed_from_ckpt_step'] if summ['driver_seams'] else None}; "
                    f"seams {seams}; lr peak at step {summ['lr_peak_step']} (lr_at_36 "
                    f"{summ['lr_at_36']:.6g}, lr_at_40 {summ['lr_at_40']:.6g}, lr_at_64 "
                    f"{summ['lr_at_64']:.6g}); checkpoints {summ['checkpoint_steps_on_disk']} + "
                    f"best {summ['best']}; {summ['restarts']} restart {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"ref_scale_run: {summ}")
        rc, _ = run_main("rest", "ref_scale_snapshot", ref_scale_snapshot.main,
                         ["--root", f"{work}/ref", "--driver-log", f"{work}/none.log",
                          "--out", f"{work}/evidence"], echo=False)
        with open(f"{work}/evidence/summary.json") as f:
            snap = json.load(f)
        ok = (rc == 0 and snap["final_logged_step"] == 64 and snap["warmup_knee_crossed"]
              and snap["lr_peak"][0] == 40 and len(snap["seam_continuity"]) == 1
              and Path(f"{work}/evidence/metrics.jsonl").exists())
        say("rest", f"ref_scale_snapshot: final_logged_step {snap['final_logged_step']}, "
                    f"{snap['n_metric_records']} records, lr_peak {snap['lr_peak']}, knee crossed "
                    f"{snap['warmup_knee_crossed']} {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"ref_scale_snapshot: {snap}")

        # -- the model demo and the complexity CLI
        demo, _ = run_main("rest", "models.gtcrn_micro", gtcrn_micro.main, [])
        ok = (demo["params"] == 19014 and demo["macs"] == 41929335 and demo["prefix_diff"] == 0
              and demo["suffix_diff"] > 0 and demo["stream_diff"] <= 1e-4)
        say("rest", f"models.gtcrn_micro demo: prefix diff {demo['prefix_diff']} (== 0), suffix "
                    f"{demo['suffix_diff']:.3f} (> 0), streaming vs offline "
                    f"{demo['stream_diff']:.3g} (<= 1e-4) {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"models.gtcrn_micro demo: {demo}")
        cplx, _ = run_main("rest", "utils.complexity", complexity.main, [])
        if cplx != (19014, 41929335):
            fail(f"utils.complexity: {cplx}")

        # -- serve --checkpoint against --params of the same weights, on B2
        flat = gtcrn_micro.flatten(load_params(trained, device="cpu"))
        np.savez(f"{work}/trained.npz", **{k.replace(".", "/"): v.numpy() for k, v in flat.items()})
        made = []
        make_backend = serve.make_backend
        serve.make_backend = lambda *a, **k: made.append(make_backend(*a, **k)) or made[-1]
        try:
            args = ["--seconds", "1", "--batch", "8", "--cohorts", "2"]
            by_ckpt, _ = run_main("rest", "serve --checkpoint", serve.main,
                                  args + ["--checkpoint", trained])
            by_params, _ = run_main("rest", "serve --params", serve.main,
                                    args + ["--params", f"{work}/trained.npz"])
        finally:
            serve.make_backend = make_backend
        n_b2 = [m.launches for m in made]
        launches["fused_grid_b2"] += sum(n_b2)
        same = torch.equal(by_ckpt["grid"], by_params["grid"])
        ok = same and len(n_b2) == 2 and min(n_b2) > 0
        say("rest", f"serve --checkpoint (phase 7's trainer directory) vs "
                    f"--params of the same weights, B2 bf16 1 s: bit-identical {same}, B2 "
                    f"launches {n_b2} {'ok' if ok else 'FAILED'}")
        if not ok:
            fail("serve --checkpoint is not serve --params of the same weights")

        rc = smoke.wait(timeout=900)
        smoke_s = time.perf_counter() - t_smoke
    finally:
        if smoke.poll() is None:
            smoke.kill()
            smoke.wait()
        smoke_log.close()
    lines = Path(f"{work}/smoke_all.log").read_text().splitlines()
    steps, label = [], ""
    for ln in lines:  # "$ <command>", its output, then "  (<seconds> s)"
        if ln.startswith("$ "):
            words = ln[2:].split()
            label = (words[2].removeprefix("gtcrn_micro_tpu_torch.") if words[1] == "-m"
                     else words[words.index("import") + 1].rstrip(";") if words[1] == "-c"
                     else " ".join(w for w in [Path(words[0]).name, words[1]]
                                   if not w.startswith("/")))
        elif ln.startswith("  (") and label:
            steps.append(f"{label} {ln.strip()}")
            label = ""
    ok = rc == 0 and lines and lines[-1].startswith("ALL SMOKE SURFACES OK")
    say("rest", f"smoke_all on the card ({smoke_s:.1f} s, beside the steps above): "
                f"{len(steps)} steps: {'; '.join(steps)}; {lines[-1] if lines else ''} "
                f"{'ok' if ok else 'FAILED'}")
    if not ok:
        for ln in lines[-60:]:
            print(f"[rest]   smoke_all: {ln}", flush=True)
        fail(f"smoke_all exited {rc}")

    # -- the layered model's probes, the card to themselves
    with cut(sweep_chunk, BATCHES=(8192,), CHAIN_FRAMES=48, MIN_STEPS=6):
        cells, s1 = run_main("rest", "sweep_chunk", sweep_chunk.main, [])
    ok = all(c is not None and all(math.isfinite(x) and x > 0 for x in c) for c in cells.values())
    say("rest", f"sweep_chunk 8,192 ({s1:.1f} s): ms per frame at T=1/2/4/8 "
                + " / ".join(f"{cells[(8192, t)][0] * 1e3:.3f}" for t in sweep_chunk.CHUNKS)
                + f" {'ok' if ok else 'FAILED'}; card {card}")
    if not ok:
        fail(f"sweep_chunk: {cells}")
    chains, s2 = run_main("rest", "int8_microbench", int8_microbench.main, [])
    ok = set(chains) == {"bf16", "int8", "int8-noreq"} and all(
        v is not None and math.isfinite(v) and v > 0 for v in chains.values())
    say("rest", f"int8_microbench 16,384 x 40 layers ({s2:.1f} s): "
                + ", ".join(f"{k} {v * 1e3:.3f} ms/chain" for k, v in chains.items())
                + f" {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"int8_microbench: {chains}")
    with cut(ab_psum, CHAIN=16, REPEATS=2):
        ab, s3 = run_main("rest", "ab_psum", ab_psum.main, ["8192"])
    ratios = ab[8192]["ratios"]
    ok = len(ratios) == 3 and all(math.isfinite(r) and r > 0 for r in ratios.values())
    say("rest", f"ab_psum 8192 ({s3:.1f} s): ring {ab[8192]['best_s']['ring'] * 1e3:.3f} ms/step; "
                + ", ".join(f"{k}/ring {r:.3f}x" for k, r in ratios.items())
                + f" {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"ab_psum: {ab}")
    rb, s4 = run_main("rest", "ring_bank_microbench", ring_bank_microbench.main, ["8192"])
    ok = all(math.isfinite(r["median_s"]) and r["median_s"] > 0 for r in rb.values())
    say("rest", f"ring_bank_microbench 8192 ({s4:.1f} s): " + ", ".join(
        f"{k} {r['median_s'] * 1e3:.3f} ms/step, {r['copy_ops']} aten::copy_, "
        f"{r['device_copies']} device copies" for k, r in rb.items()) + f" {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"ring_bank_microbench: {rb}")
    shipped = blocks.GTConvBlock.shuffle
    with cut(ablate_shuffle, CHAIN=32):
        ab2, s5 = run_main("rest", "ablate_shuffle", ablate_shuffle.main, ["8192"])
    ok = (blocks.GTConvBlock.shuffle is shipped and set(ab2) == {"copy", "one-hot", "concat"}
          and all(math.isfinite(v[0]) and v[0] > 0 for v in ab2.values()))
    say("rest", f"ablate_shuffle 8192 ({s5:.1f} s): " + ", ".join(
        f"{k} {v[0] * 1e3:.3f} ms/step" for k, v in ab2.items())
        + f"; seam restored {blocks.GTConvBlock.shuffle is shipped} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"ablate_shuffle: {ab2}")
    slopes, s6 = run_main("rest", "leak_probe", leak_probe.main,
                          ["--mode", "all", "--steps", "100", "--log-every", "25"])
    ok = set(slopes) == {"putonly", "compute", "full"} and all(map(math.isfinite, slopes.values()))
    say("rest", f"leak_probe 8 x 160,000 samples, 100 steps a mode ({s6:.1f} s): "
                + ", ".join(f"{k} {v:+.3f} MB/step" for k, v in slopes.items())
                + f" against a 10.2 MB batch pair {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"leak_probe: {slopes}")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(Path(trained).parent)
    say("rest", f"kernel launches in phase 13: {launches}; phase 13 took "
                f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def gtcrn_phase(torch, dev, card) -> None:
    """Phase 14 (the module docstring): GTCRN offline and served against its
    plain reference."""
    from benchmark import inputs
    from benchmark.reference import gtcrn_dpgrnn as ref
    from gtcrn_micro_tpu_torch.serve import CohortServer, make_backend

    t0 = time.perf_counter()
    P = ref.init_params(2_024_001, dev)
    model = make_backend("layered", ref.nest(P), torch.float32, dev, model="gtcrn")
    gen = torch.Generator(device=dev).manual_seed(11)
    spec = ref.dsp.stft(inputs.speech_like(8, 511 * 256, gen, dev), ref.dsp.sqrt_hann(dev))
    with torch.no_grad(), ref.no_tf32():
        want = ref.forward(P, spec)
        got = model.apply(spec)
    rel = float((got - want).norm() / want.norm())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            same = torch.equal(model.apply(spec), got)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        apply_ms = cuda_ms(torch, lambda: model.apply(spec), n=5, warm=1)
    say("gtcrn", f"apply B=8 x {spec.shape[2]} frames: rel {rel:.3e} against the reference, "
                 f"{apply_ms:.2f} ms (CUDA events); bit-identical with TF32 flags on: {same}")
    if not rel <= 1e-4 or not same:
        fail(f"gtcrn apply: rel {rel:.3e}, TF32-flag identical {same}")

    B, hops = 1024, 64
    audio = inputs.speech_like(B, hops * 256, gen, dev)
    audio[B // 2] = 0.0
    srv = CohortServer(model, None, batch=B, n_cohorts=1, dtype=torch.float32, mode="audio",
                       device=dev)
    outs, times = [], []
    with ref.no_tf32():
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for n in range(hops):
            if n == 16:
                e0.record()
            t = time.perf_counter()
            outs.append(srv.step(0, audio[:, 256 * n:256 * (n + 1)]))
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t)
        e1.record()
        e1.synchronize()
        served = torch.cat(outs, dim=1)
        want = ref.stream_enhance(P, audio)
    rel_s = float((served - want).norm() / want.norm())
    silent = float(served[B // 2].abs().max())
    step_ms = statistics.median(times[16:]) * 1e3
    event_ms = e0.elapsed_time(e1) / (hops - 16)
    say("gtcrn", f"served f32 1 x {B} streams x {hops} steps: rel {rel_s:.3e} against the "
                 f"reference's forward over the same audio, silent slot max {silent}; step "
                 f"{step_ms:.3f} ms median host clock (steps 16-63, synchronized), "
                 f"{event_ms:.3f} ms by CUDA events; {card}; "
                 f"{time.perf_counter() - t0:.1f} s")
    if not rel_s <= 1e-4 or silent != 0.0:
        fail(f"gtcrn served: rel {rel_s:.3e}, silent slot {silent}")


def main() -> None:
    t_start = time.perf_counter()
    if not (ROOT / "gtcrn_micro_tpu_torch").is_dir():
        fail(f"the port package gtcrn_micro_tpu_torch is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    # -- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    card = card.splitlines()[0]
    dev = torch.device("cuda", 0)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    say("device", f"{kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}; "
                  f"card {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params
    from gtcrn_micro_tpu_torch.ops import _build
    from gtcrn_micro_tpu_torch.ops.fused_grid import GridFusedGTCRNMicro
    from gtcrn_micro_tpu_torch.ops.fused_step import (
        RING_DEFS,
        FusedGTCRNMicro,
        LayoutGTCRNMicro,
        _slots,
        unpack,
    )
    from gtcrn_micro_tpu_torch.serve import CohortServer, plan_cohorts
    from gtcrn_micro_tpu_torch.utils.roofline import fused_step_bound, work_per_stream

    # -- 2. build --------------------------------------------------------
    native_build = None
    multi_card = "--multi-card" in sys.argv[1:]
    if "--parity" not in sys.argv[1:] and not multi_card:  # phase 9's host engine beside nvcc
        from concurrent.futures import ThreadPoolExecutor

        from gtcrn_micro_tpu_torch.runtime.native import build_native

        def timed_build():
            t0 = time.perf_counter()
            return build_native(), time.perf_counter() - t0

        with ThreadPoolExecutor(1) as pool:
            native_build = pool.submit(timed_build)
            secs = _build.build()
    else:
        secs = _build.build()
    say("build", f"built {', '.join(_build.SOURCES)} in {secs:.1f} s "
                 f"({' '.join(_build.NVCC_FLAGS)})")

    params = init_params(torch.Generator().manual_seed(0), device=dev)
    if multi_card:
        if count < 2:
            fail(f"--multi-card needs two cards, {count} present")
        multi_card_checks(torch, dev, params, card)
        say("done", f"multi-card checks ok in {time.perf_counter() - t_start:.1f} s "
                    f"(--multi-card: no other phase)")
        sys.exit(0)
    kernels = {
        "fused_step_b1": dict(cls=FusedGTCRNMicro, lib="fused_step", source="gtcrn_micro_tpu_torch/csrc/fused_step.cu",
                              replaces="gtcrn_micro_tpu/ops/fused_step.py:402"),
        "fused_grid_b2": dict(cls=GridFusedGTCRNMicro, lib="fused_grid", source="gtcrn_micro_tpu_torch/csrc/fused_grid.cu",
                              replaces="gtcrn_micro_tpu/ops/fused_grid.py:167"),
    }

    # -- 3. kernels ------------------------------------------------------
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name, k in kernels.items():
        k["attrs"] = _build.kernel_attrs(k["lib"])
        for dtn, a in k["attrs"].items():
            say("kernels", f"{name} {dtn}: {a['regs']} registers, {a['local_bytes']} local bytes "
                           f"per thread, {a['smem_bytes']} shared bytes per CTA, "
                           f"{a['ctas_per_sm']} CTAs per SM ({n_sm} SMs)")
            if a["local_bytes"] > 0:
                fail(f"{name} {dtn} uses local memory (spills or a stack frame)")

    B, T = 256, 24
    g = torch.Generator().manual_seed(1)
    spec = (torch.randn((B, 257, T, 2), generator=g) * 0.2).to(dev)

    def stream(model, dtype):
        st = model.init_state(B)
        outs = []
        for t in range(T):
            y, st = model.step(st, spec[:, :, t : t + 1].to(dtype))
            outs.append(y.float())
        torch.cuda.synchronize()
        return torch.cat(outs, dim=2), st

    plain = LayoutGTCRNMicro(params, dtype=torch.float32, device=dev)
    ref, ref_st = stream(plain, torch.float32)
    for name, k in kernels.items():
        model = k["cls"](params, dtype=torch.float32, device=dev)
        out, st = stream(model, torch.float32)
        err = float((out - ref).abs().max())
        ring_err = max(float((st[n] - ref_st[n]).abs().max()) for n, *_ in RING_DEFS)
        snr = snr_db(ref, out)
        ok = (err <= 1e-4 and ring_err <= 1e-4 and snr >= 80 and st["step"] == ref_st["step"]
              and model.launches == T)
        say("kernels", f"{name} f32 B={B} {T} frames vs plain: max-abs {err:.3g}, "
                       f"rings max-abs {ring_err:.3g}, SNR {snr:.1f} dB "
                       f"(bound 1e-4, 80 dB), launches {model.launches} "
                       f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"{name} disagrees with its plain version")
        out16, _ = stream(k["cls"](params, dtype=torch.bfloat16, device=dev), torch.bfloat16)
        snr16 = snr_db(ref, out16)
        say("kernels", f"{name} bf16 storage vs f32 plain: SNR {snr16:.1f} dB (sanity bound 30 dB)")
        if not (torch.isfinite(out16).all() and snr16 >= 30):
            fail(f"{name} bf16 output is not sane")
        k.update(f32_max_abs_err=err, f32_snr_db=snr, bf16_snr_db=snr16)

    # the served shape: one step from the same state, kernel vs plain
    BS, dt = 8192, torch.bfloat16
    W32 = unpack(plain.weights)
    macs = work_per_stream(W32)[0]
    esz = torch.finfo(dt).bits // 8
    spec_s = (torch.randn((BS, 257, 1, 2), generator=g) * 0.2).to(dev, dt)
    plain16 = LayoutGTCRNMicro(params, dtype=dt, device=dev)
    st0 = plain16.init_state(BS)
    for n, *_ in RING_DEFS:
        st0[n].copy_(torch.rand(st0[n].shape, generator=g).mul_(0.6).sub_(0.3))
    st0["step"] = 5

    def clone(st, b=None):
        return {k: (v[..., :b].clone() if torch.is_tensor(v) else v) for k, v in st.items()}

    plain_st = clone(st0)
    yp, plain_st = plain16.step(plain_st, spec_s)
    models = {}
    for name, k in kernels.items():
        model = models[name] = k["cls"](params, dtype=dt, device=dev)
        st = clone(st0)
        yk, st = model.step(st, spec_s)
        torch.cuda.synchronize()
        err = float((yk.float() - yp.float()).abs().max())
        ok = err <= 2 ** -7 * float(yp.float().abs().max())
        for n, *_ in RING_DEFS:
            d = float((st[n].float() - plain_st[n].float()).abs().max())
            ok = ok and d <= 2 ** -7 * float(plain_st[n].float().abs().max())
        k["max_abs_err"] = err
        say("kernels", f"{name} B={BS} bf16 one step vs plain: max-abs {err:.3g} "
                       f"(bound one bf16 step, rings too) {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"{name} disagrees with its plain version at the served shape")
    if "--parity" in sys.argv[1:]:
        say("done", f"build and parity ok in {time.perf_counter() - t_start:.1f} s (--parity: "
                    f"no timing, no serving)")
        sys.exit(0)

    def bound(b):
        """(ms, by, FLOPs, bytes) the card needs at least for one step of b streams."""
        return fused_step_bound(W32, b, esz, kw_floats)

    kw_floats = models["fused_grid_b2"].kernel_weights.buf.numel()
    bound_ms, bound_by, flops, nbytes = bound(BS)
    say("kernels", f"served shape B={BS} bf16: {macs} MAC/stream/frame -> {flops / 1e9:.3f} GFLOP "
                   f"f32, {nbytes / 1e6:.1f} MB moved; bound {bound_ms:.4f} ms by {bound_by} "
                   f"(H100 SXM peaks: 67 TFLOP/s f32, 494.7 TFLOP/s TF32 taken three times "
                   f"for the tensor-core share, 3.35 TB/s)")
    timing_st = clone(st0)  # steps on it advance its counter; timing only
    plain_ms = cuda_ms(torch, lambda: plain16.step(timing_st, spec_s), n=10)

    def bare_launch(name, model, st, spec_b, out):
        """The kernel's launch alone, not through the counted wrapper."""
        t = st["step"]
        if name == "fused_step_b1":
            taps = []
            for n, L, d, _shape in RING_DEFS:
                s0, s1 = _slots(t, L, d)
                taps += [st[n][s0], st[n][s1]]
            return lambda: _build.launch_b1(model.kernel_weights, spec_b, out, taps, taps[0::2])
        rings = [st[n] for n, *_ in RING_DEFS]
        return lambda: _build.launch_b2(model.kernel_weights, spec_b, out, rings, t)

    for name, k in kernels.items():
        model = models[name]
        wave = n_sm * k["attrs"]["bfloat16"]["ctas_per_sm"] * _build.TILE
        st = clone(st0)
        ms = cuda_ms(torch, bare_launch(name, model, st, spec_s, torch.empty_like(spec_s)),
                     n=10, reps=10)
        st_w = clone(st0, wave)
        spec_w = spec_s[:wave].contiguous()
        wave_ms = cuda_ms(torch, bare_launch(name, model, st_w, spec_w, torch.empty_like(spec_w)),
                          n=10, reps=10)
        wave_bound_ms = bound(wave)[0]
        wrapper_ms = cuda_ms(torch, lambda: model.step(timing_st, spec_s), n=10)
        k.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 wrapper_ms=wrapper_ms, wave_batch=wave, wave_ms=wave_ms,
                 wave_bound_ms=wave_bound_ms)
        say("kernels", f"{name} B={BS} bf16: kernel {ms:.3f} ms, model step {wrapper_ms:.3f} ms, "
                       f"plain step {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                       f"({bound_ms / ms:.1%} of it); one wave B={wave}: kernel {wave_ms:.3f} ms, "
                       f"bound {wave_bound_ms:.4f} ms ({wave_bound_ms / wave_ms:.1%} of it)")
    del st0, plain_st, timing_st, yp, models

    # -- 4. serve --------------------------------------------------------
    K, intervals = 2, 64
    ga = torch.Generator(device=dev).manual_seed(2)
    silent = (0, 5)  # (cohort, slot) fed zeros throughout
    for name, n_int in (("fused_grid_b2", intervals), ("fused_step_b1", 8)):
        model = kernels[name]["cls"](params, dtype=dt, device=dev)
        srv = CohortServer(model, params, batch=BS, n_cohorts=K, dtype=dt, mode="audio",
                           dft="mxu", device=dev)
        model.launches = model.staged_launches = 0
        finite, silent_max, loud = True, 0.0, 0.0
        for _ in range(n_int):
            for c in range(K):
                chunk = torch.randn((BS, 256), generator=ga, device=dev).mul_(0.3).to(dt)
                if c == silent[0]:
                    chunk[silent[1]] = 0
                out = srv.step(c, chunk)
                finite = finite and bool(torch.isfinite(out).all())
                if c == silent[0]:
                    silent_max = max(silent_max, float(out[silent[1]].abs().max()))
                    loud = max(loud, float(out[silent[1] + 1].abs().max()))
        torch.cuda.synchronize()
        steps = n_int * K
        # B2 stages its taps by tensor copies at bf16 and B % 8 == 0: every step here
        staged = model.staged_launches if name == "fused_grid_b2" else 0
        ok = (finite and silent_max == 0.0 and loud > 0 and model.launches == steps
              and staged == (steps if name == "fused_grid_b2" else 0))
        say("serve", f"{name}: {n_int} intervals x {K} cohorts x {BS} streams bf16: finite "
                     f"{finite}, silent slot max {silent_max}, launches {model.launches} "
                     f"({staged} staged) for {steps} steps {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"serving through {name} failed its checks")
        kernels[name]["launches"] = model.launches
        kernels[name]["staged_launches"] = staged
        if name != "fused_grid_b2":
            continue
        # admit / release / reset: the slot's column of every ring is zeroed
        slot = srv.admit(1)
        rings = [v for k, v in srv._states[1][0].items() if k != "step"]  # the only shard
        busy = any(float(v[..., slot].abs().max()) > 0 for v in rings)
        srv.release(1, slot)
        srv.reset_slot(1, slot)
        zeroed = all(float(v[..., slot].abs().max()) == 0 for v in rings)
        kept = all(float(v[..., slot - 1].abs().max()) > 0 for v in rings)
        dsp_zero = float(srv._dsp[1][0][0].in_buf[slot].abs().max()) == 0
        if not (busy and zeroed and kept and dsp_zero):
            fail(f"reset_slot: busy {busy} zeroed {zeroed} neighbour kept {kept} dsp {dsp_zero}")
        say("serve", f"admit/release/reset of cohort 1 slot {slot}: its ring columns and DSP "
                     f"rows zeroed, its neighbour's kept: ok")
        # the served step by CUDA events
        chunk = torch.randn((BS, 256), generator=ga, device=dev).mul_(0.3).to(dt)
        step_ms = cuda_ms(torch, lambda: srv.step(0, chunk), n=30, warm=4)
        plan = plan_cohorts(step_ms / 1e3, BS)
        say("serve", f"served step B={BS} bf16 (CUDA events, median of 30): {step_ms:.3f} ms; "
                     f"card {card}")
        say("serve", f"plan_cohorts({step_ms / 1e3:.6f} s, {BS}): K={plan.n_cohorts} cohorts, "
                     f"{plan.streams} streams, worst latency {plan.worst_latency_s * 1e3:.2f} ms")
        del srv, model
        # smaller cohorts: the served step and the plan each batch allows
        for b in (1024, 2048, 4096):
            srv = CohortServer(None, params, batch=b, n_cohorts=1, dtype=dt, mode="audio",
                               dft="mxu", device=dev)
            chunk = torch.randn((b, 256), generator=ga, device=dev).mul_(0.3).to(dt)
            ms_b = cuda_ms(torch, lambda: srv.step(0, chunk), n=20, warm=4)
            plan = plan_cohorts(ms_b / 1e3, b)
            say("serve", f"served step B={b} bf16: {ms_b:.3f} ms; plan_cohorts: K={plan.n_cohorts}, "
                         f"{plan.streams} streams, worst latency {plan.worst_latency_s * 1e3:.2f} ms")
            del srv

    # -- 5. slice parity -------------------------------------------------
    Bp, hops = 64, 24
    x = torch.randn((Bp, 256 * hops), generator=ga, device=dev).mul_(0.3)

    def serve_audio(model):
        srv = CohortServer(model, params, batch=Bp, n_cohorts=1, dtype=torch.float32,
                           mode="audio", dft="mxu", device=dev)
        return torch.cat([srv.step(0, x[:, 256 * t : 256 * (t + 1)]) for t in range(hops)], -1)

    ref = serve_audio(LayoutGTCRNMicro(params, dtype=torch.float32, device=dev))
    for name, k in kernels.items():
        got = serve_audio(k["cls"](params, dtype=torch.float32, device=dev))
        snr = snr_db(ref, got)
        say("slice", f"audio server f32 B={Bp} {hops} hops, {name} vs plain backend: SNR "
                     f"{snr:.1f} dB (bound 80 dB) {'ok' if snr >= 80 else 'FAILED'}")
        if snr < 80:
            fail(f"slice parity through {name}")

    # -- 6. layered -------------------------------------------------------
    layered_phase(torch, dev, params, spec, card)

    # -- 7. train ---------------------------------------------------------
    enhanced, trained = train_phase(torch, dev, params, card)

    # -- 8. quant ---------------------------------------------------------
    quant = quant_phase(torch, dev, params, card)

    # -- 9. dist + export ---------------------------------------------------
    dist_phase(torch, dev, params, card, quant["act_qp"], quant["folded"], native_build)

    # -- 10. rounding: AdaRound, GPTQ, mixed precision -------------------------
    # cuDNN's default algorithms are not deterministic, so the 40-step AdaRound
    # loop would give another artifact on every run, and a value on a rounding
    # tie could flip between the native engine and the card's fake-quant step
    # in some runs; deterministic algorithms make the phase's artifacts, and so
    # its checks, the same on every run.
    torch.backends.cudnn.deterministic = True
    try:
        rounding_phase(torch, dev, card, quant, native_build)
    finally:
        torch.backends.cudnn.deterministic = False

    # -- 11. export: DNSMOS, ONNX, exported programs, the export CLI -----------
    export_phase(torch, dev, params, card, enhanced)

    # -- 12. bench: the measuring entry points -------------------------------
    bench_launches = bench_phase(card)

    # -- 13. rest: the CLIs, smoke_all, the reference-scale traversal, probes --
    rest_launches = rest_phase(torch, dev, card, trained)

    # -- 14. gtcrn: GTCRN offline and served against its plain reference ------
    gtcrn_phase(torch, dev, card)

    rows = [{"name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
             "launches": k["launches"], "staged_launches": k["staged_launches"],
             "bench_launches": bench_launches[name],
             "rest_launches": rest_launches[name],
             "max_abs_err": k["max_abs_err"], "ms": k["ms"],
             "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
             "library_ms": None, "f32_max_abs_err": k["f32_max_abs_err"],
             "f32_snr_db": k["f32_snr_db"], "bf16_snr_db": k["bf16_snr_db"],
             "wrapper_ms": k["wrapper_ms"], "wave_batch": k["wave_batch"],
             "wave_ms": k["wave_ms"], "wave_bound_ms": k["wave_bound_ms"],
             **{key: {dtn: a[key] for dtn, a in k["attrs"].items()}
                for key in ("regs", "local_bytes", "smem_bytes", "ctas_per_sm")}}
            for name, k in kernels.items()]
    say("done", f"all phases ok in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
