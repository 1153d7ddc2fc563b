"""The served cells' common part: a ``CohortServer`` over the configuration's
default model backend, its seeded audio pool, the record of a seeded sample
of streams' outputs, and the comparison of that record with the plain
reference.

Stream ``s`` of cohort ``c`` is fed ``pool[n % hops, c * B + s]`` at its
``n``-th step, counted from the server's creation (warm-up included).  The
sample is ``sample_streams`` slots of each cohort, one drawn from each of as
many equal blocks of the batch, so it spans the whole batch.  Every step
outside the traced sub-window copies the sample's outputs into a buffer on
the device (one gather); after the window the reference enhances the
sample's whole input from zero state (``reference.dsp.stream_enhance``) and
each stream's recorded output is held to it by its relative error.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.harness import Check
from benchmark.reference import dsp, gtcrn

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
CHUNK = 1024  # recorded steps per buffer


class Served:
    def __init__(self, ctx):
        from gtcrn_micro_tpu_torch.serve import CohortServer

        cell, cfg, dev = ctx.cell, ctx.config, ctx.device
        self.ctx = ctx
        self.B, self.K = cell["batch"], cell["cohorts"]
        self.hops = cell["pool_hops"]
        self.dtype = DTYPES[cfg["precision"]]
        self.P = gtcrn.init_params(inputs.seed_of(ctx.seed, "weights"), dev)
        self.srv = CohortServer(None, gtcrn.nest(self.P), batch=self.B, n_cohorts=self.K,
                                dtype=self.dtype, mode="audio", dft=cfg["dft"], device=dev)
        self.backend = type(self.srv.model).__name__
        self.pool = inputs.audio_pool(self.K * self.B, self.hops, ctx.seed, dev, self.dtype)
        rng = np.random.default_rng(inputs.seed_of(ctx.seed, "sample"))
        edges = np.linspace(0, self.B, cell["sample_streams"] + 1).astype(int)
        self.slots = [[int(rng.integers(edges[i], edges[i + 1])) for i in range(len(edges) - 1)]
                      for _ in range(self.K)]
        self.idx = [torch.tensor(s, device=dev) for s in self.slots]
        self.steps = [0] * self.K
        self.rec_steps: list = [[] for _ in range(self.K)]
        self.rec_bufs: list = [[] for _ in range(self.K)]
        self.recording = True
        self.span = contextlib.nullcontext
        self.host_s: list = []  # host seconds of each CohortServer.step call

    def step(self, c: int) -> torch.Tensor:
        """One step of cohort ``c`` through ``CohortServer.step``."""
        n = self.steps[c]
        frame = self.pool[n % self.hops, c * self.B:(c + 1) * self.B]
        t0 = time.perf_counter()
        with self.span("serve.step"):
            out = self.srv.step(c, frame)
        self.host_s.append(time.perf_counter() - t0)
        self.steps[c] = n + 1
        if self.recording:
            j = len(self.rec_steps[c])
            if j // CHUNK == len(self.rec_bufs[c]):
                self.rec_bufs[c].append(torch.empty((CHUNK, len(self.slots[c]), 256),
                                                    dtype=out.dtype, device=out.device))
            torch.index_select(out, 0, self.idx[c], out=self.rec_bufs[c][j // CHUNK][j % CHUNK])
            self.rec_steps[c].append(n)
        return out

    def warm(self, rounds: int) -> None:
        """Step every cohort ``rounds`` times, recording as the window does,
        so that every kernel the window launches has been loaded; the record
        starts empty after."""
        for _ in range(rounds):
            for c in range(self.K):
                self.step(c)
        self.ctx.sync()
        self.rec_steps = [[] for _ in range(self.K)]

    def trace_mode(self) -> None:
        """Stop recording and open a host span around each step."""
        from torch.profiler import record_function

        self.recording = False
        self.span = record_function

    def free_program(self) -> None:
        del self.srv
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, control: bool = False) -> dict:
        """Each sampled stream's relative error against the reference, the
        worst of them, and the recorded steps with a non-finite output; with
        ``control``, also the worst error of the reference computed with
        float8 storage (:func:`fp8`) put in the program's place."""
        errs, ctrl, nonfinite = [], [], 0
        for c in range(self.K):
            got_steps = self.rec_steps[c]
            if not got_steps:
                continue
            S, n_steps = len(self.slots[c]), self.steps[c]
            src = self.pool[:, [c * self.B + s for s in self.slots[c]]].float()  # (hops, S, 256)
            audio = src[torch.arange(n_steps, device=src.device) % self.hops]
            audio = audio.permute(1, 0, 2).reshape(S, -1)
            at = torch.tensor(got_steps, device=audio.device)
            got = torch.cat(self.rec_bufs[c])[:len(got_steps)].float().transpose(0, 1)
            nonfinite += int((~torch.isfinite(got)).any(dim=(0, 2)).sum())
            with torch.no_grad(), gtcrn.no_tf32():
                ref = dsp.stream_enhance(self.P, audio).view(S, n_steps, 256)[:, at]
                errs += _rel_err(got, ref)
                if control:
                    low = dsp.stream_enhance(self.P, audio, rnd=fp8).view(S, n_steps, 256)[:, at]
                    ctrl += _rel_err(low, ref)
        out = {"rel_err": errs, "rel_err_max": max(errs) if errs else float("nan"),
               "nonfinite_steps": nonfinite}
        if control:
            out["control_rel_err_max"] = max(ctrl)
        return out

    def checks(self, limit: float, control: bool = False) -> tuple[list, int, dict]:
        res = self.compare(control)
        self.ctx.log(f"served sample: {len(res['rel_err'])} streams, worst relative error "
                     f"{res['rel_err_max']!r}, backend {self.backend}")
        readings = {k: res[k] for k in ("rel_err_max", "control_rel_err_max") if k in res}
        return [Check("rel_err_max", res["rel_err_max"], limit),
                Check("nonfinite_steps", res["nonfinite_steps"], 0)], res["nonfinite_steps"], readings


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> list:
    """Per stream: ||got - ref|| / ||ref|| over (S, steps, 256)."""
    d = (got.double() - ref.double()).square().sum(dim=(1, 2)).sqrt()
    return [float(x) for x in d / ref.double().square().sum(dim=(1, 2)).sqrt()]


class Done:
    """A completed step's stand-in for a CUDA event (the CPU's plain path in
    tests: a step is done when it returns)."""

    def synchronize(self):
        pass

    def record(self):
        pass

    def query(self):
        return True


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 and back: the control's storage for a bfloat16
    configuration."""
    return x.to(torch.float8_e4m3fn).float()
