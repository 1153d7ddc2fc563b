"""Bulk offline enhancement of long recordings with TF-Locoformer:
``enhance_wavs(model, paths, batch_size)`` over a fixed seeded clip set of
20-60 s written as wavs, call after call, the model built by its registry
name (the configuration's ``registry_name``) at the configuration's widths.
The same recordings as ``traffic/offline_tfgridnet.py``'s, measured the
same way:

``offline_audio_x`` = seconds of input audio enhanced / seconds of the
window, counting the whole calls finished in it (the window closes at the
end of the call in which ``--seconds`` ran out).  The outputs of two calls
drawn from the seed are held, clip by clip, to the plain reference
(``benchmark/reference/tflocoformer.py``, each clip alone at its own
length), computed once per run after the window.  The traced window records
each clip's own frames at the configuration's hop (``clip_frames``), which
the ``tflocoformer.mfu_pct`` reader counts the work of.
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.harness import Check, Outcome, memory_peak
from benchmark.reference import tflocoformer as ref
from benchmark.trace import Trace, traced
from benchmark.traffic.offline import clip_errors

KEPT_CALLS = 2


def run(ctx) -> Outcome:
    from gtcrn_micro_tpu_torch.eval.infer import enhance_wavs
    from gtcrn_micro_tpu_torch.models.registry import get_model

    cell, dev = ctx.cell, ctx.device
    widths = ref.config_of(ctx.config)
    # first, so that a program without the model fails before any input is made
    model = get_model(ctx.config["registry_name"], device=dev, **dataclasses.asdict(widths))
    paths, pcms = inputs.clip_set(cell["short_clips"], tuple(cell["short_s"]), cell["long_clips"],
                                  cell["long_s"], ctx.seed, dev)
    try:
        P = ref.init_params(inputs.seed_of(ctx.seed, "weights"), dev, widths)
        model.load_params(P)
        span = [contextlib.nullcontext]

        def call() -> dict:
            with span[0]("enhance_wavs"):
                return enhance_wavs(model, paths, batch_size=cell["batch_size"], device=dev,
                                    progress=False)

        call()  # every bucket's shapes, off the clock
        setup_s = ctx.setup_s()

        rng = np.random.default_rng(inputs.seed_of(ctx.seed, "kept"))
        kept: list = []
        calls, t0 = 0, time.perf_counter()
        while True:
            out = call()
            calls += 1
            if len(kept) < KEPT_CALLS:
                kept.append(out)
            elif (j := int(rng.integers(calls))) < KEPT_CALLS:
                kept[j] = out
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
        audio_s = sum(len(p) for p in pcms) / inputs.FS
        ctx.log(f"{calls} calls of {len(paths)} clips ({audio_s:.3f} s of audio) in "
                f"{window_s:.4f} s")
        trace = None
        if ctx.trace:
            from torch.profiler import record_function

            trace = Trace(ctx.config, cell)
            span[0] = record_function
            with traced(trace, ("enhance_wavs",)):
                n, t1 = 0, time.perf_counter()
                while n == 0 or time.perf_counter() - t1 < cell["trace_seconds"]:
                    call()
                    n += 1
            frames = [len(p) // widths.hop_len + 1 for p in pcms]
            trace.counters.update(calls=n, frames_per_call=sum(frames))
            trace.values["clip_frames"] = frames
        peak = memory_peak(dev)
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        checks, failed, readings = compare(ctx, P, widths, paths, pcms, kept)
    finally:
        shutil.rmtree(paths[0].rsplit("/", 1)[0], ignore_errors=True)
    return Outcome({"offline_audio_x": calls * audio_s / window_s}, setup_s, calls * len(paths),
                   failed, checks, peak, trace, {"readings": readings})


def compare(ctx, P, widths, paths, pcms, kept) -> tuple[list, int, dict]:
    """The check, the failed clips and the readings (with ``ctx.control``
    also the TF32 control's: the reference under TF32 in the program's
    place)."""
    clips = [p.astype(np.float32) / 32768 for p in pcms]
    with ref.no_tf32():
        want = ref.offline_enhance(P, clips, ctx.device, widths)
    errs, failed = [], 0
    for out in kept:
        e = clip_errors([out.get(p, np.zeros(0)) for p in paths], want)
        failed += sum(not np.isfinite(x) for x in e)
        errs += e
    worst = max(errs)
    ctx.log(f"offline check: {len(errs)} clips of {len(kept)} calls, worst relative error "
            f"{worst!r}")
    readings = {"rel_err_max": worst}
    if ctx.control:
        with ref.tf32():
            low = ref.offline_enhance(P, clips, ctx.device, widths)
        readings["control_rel_err_max"] = max(clip_errors(low, want))
    return [Check("rel_err_max", worst, ctx.cell["limits"]["rel_err_max"])], failed, readings
