"""Each plain reference agrees with the port at a tiny size on the CPU
(float32, where both compute exactly in float32 and differ only by the
order of their sums)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs
from benchmark.harness import worst_leaf_gap
from benchmark.reference import dsp, gtcrn
from benchmark.reference import train as ref_train

CPU = torch.device("cpu")


def _params(seed=7):
    return gtcrn.init_params(seed, CPU)


def test_tree_is_the_ports():
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import flatten, init_params

    ours = _params()
    theirs = flatten(init_params(torch.Generator().manual_seed(0), device="cpu"))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in theirs.items()}
    assert sum(v.numel() for k, v in ours.items() if gtcrn.is_trainable(k)) == 19014
    assert torch.equal(ours["erb.bm_w"], theirs["erb.bm_w"])


def test_forward_matches_the_layered_model():
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro

    P = _params()
    model = GTCRNMicro.from_params(gtcrn.nest(P), device="cpu")
    spec = torch.randn(2, 257, 20, 2, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for training in (False, True):
            got = model.apply(spec, training=training)
            ref = gtcrn.forward(P, spec, training=training)
            if training:
                (got, stats), (ref, ref_stats) = got, ref
                v = stats["encoder/en2/depth_bn/batch_var"]
                assert torch.allclose(v, ref_stats["encoder.en2.depth_bn"][1], rtol=1e-5)
            assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_streamed_audio_matches_the_cohort_server():
    """24 hops, past the longest ring's wrap of 16 frames, through the
    server's default backend (its plain version on the CPU)."""
    from gtcrn_micro_tpu_torch.serve import CohortServer

    P = _params()
    B, hops = 4, 24
    audio = inputs.speech_like(B, hops * 256, torch.Generator().manual_seed(2), CPU)
    srv = CohortServer(None, gtcrn.nest(P), batch=B, n_cohorts=1, dtype=torch.float32,
                       mode="audio", dft="mxu", device="cpu")
    got = torch.cat([srv.step(0, audio[:, 256 * n:256 * (n + 1)]) for n in range(hops)], dim=1)
    ref = dsp.stream_enhance(P, audio)
    assert float((got - ref).norm() / ref.norm()) < 1e-5


def test_offline_matches_enhance_wavs(tmp_path):
    from gtcrn_micro_tpu_torch.eval.infer import enhance_wavs
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro

    P = _params()
    paths, pcms = inputs.clip_set(3, (0.5, 1.2), 1, 2.5, 5, CPU, root=str(tmp_path))
    model = GTCRNMicro.from_params(gtcrn.nest(P), device="cpu")
    got = enhance_wavs(model, paths, batch_size=2, device="cpu", progress=False)
    ref = dsp.offline_enhance(P, [p.astype(np.float32) / 32768 for p in pcms], CPU)
    for p, r in zip(paths, ref):
        assert got[p].shape == r.shape
        assert np.linalg.norm(got[p] - r) / np.linalg.norm(r) < 1e-5


def test_training_steps_match_make_train_step():
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro
    from gtcrn_micro_tpu_torch.train.trainer import B1, make_optimizer, make_train_step

    P = _params()
    model = GTCRNMicro.from_params(gtcrn.nest(P), device="cpu")
    opt = make_optimizer(model, device="cpu")
    opt.count = 25000
    step = make_train_step(model, opt, device="cpu")
    gen = torch.Generator().manual_seed(3)
    batches = [(inputs.speech_like(2, 16000, gen, CPU), inputs.speech_like(2, 16000, gen, CPU))
               for _ in range(2)]
    losses = []
    for i, (noisy, clean) in enumerate(batches):
        losses.append(float(step(noisy, clean)))
        if i == 0:
            grad1 = {n: m / (1 - B1) for n, m in zip(opt.names, opt.mu)}
    ref = ref_train.train_steps(P, batches, 25000)
    assert np.allclose(losses, ref["losses"], rtol=1e-5)
    assert worst_leaf_gap(grad1, ref["grad1"])[0] < 1e-3
    state = model.state_dict()
    keep = ("decoder.de0.depth_conv.w", "gtcn1.block2.conv3.w", "gtcn1.block2.bn2.running_var")
    assert worst_leaf_gap({k: state[k] - P[k] for k in keep},
                          {k: ref["params"][k] - P[k] for k in keep})[0] < 1e-2
