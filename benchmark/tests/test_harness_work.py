"""The benchmark's frozen work counter agrees with the port's."""

from __future__ import annotations

import torch

from benchmark import work
from benchmark.reference.gtcrn import erb_filters


def test_frozen_counter_gives_the_published_count():
    assert work.frame_macs() == 550_815
    f = erb_filters()
    assert work.work_per_stream(f.T, f) == (550_815, 14_880, 7_440)


def test_frozen_counter_matches_the_port():
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params
    from gtcrn_micro_tpu_torch.ops.fused_step import pack_weights, unpack
    from gtcrn_micro_tpu_torch.utils.roofline import work_per_stream

    params = init_params(torch.Generator().manual_seed(0), device="cpu")
    W = unpack(pack_weights(params, device="cpu"))
    f = erb_filters()
    assert work_per_stream(W) == work.work_per_stream(f.T, f)


def test_bound_at_the_served_batch_is_the_bytes():
    cfg = {"storage_bytes": 2, "trainable_floats": 19014, "peak": "bf16"}
    bound = work.served_step_bound_s(cfg, 8192)
    assert abs(bound - 1.1416e-4) < 2e-7  # 382 MB at 3.35 TB/s
    assert bound > 2 * 550_815 * 8192 / work.PEAK_FLOPS["bf16"]
