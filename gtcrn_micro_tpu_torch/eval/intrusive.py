"""Intrusive metric evaluation CLI (the JAX package's ``eval/intrusive.py``;
reference eval/eval_intrusive_metrics.py).

``python -m gtcrn_micro_tpu_torch.eval.intrusive --ref_scp ref.scp --inf_scp
inf.scp --output_dir RESULTS [--nj N --nsplits N --job J]``

SDR / SI-SNR / PESQ-wb / STOI per ref/inf pair in a process pool; writes one
``<METRIC>.scp`` per metric and a ``RESULTS.txt`` of nanmeans, byte for byte
what the JAX package writes for the same wavs.  The workers are spawned, not
forked: the parent may hold a CUDA context and PyTorch's threads.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import multiprocessing
import os

import numpy as np

from gtcrn_micro_tpu_torch.eval.metrics import pesq_metric, sdr_metric, sisnr_metric, stoi_metric
from gtcrn_micro_tpu_torch.io.wav import read_wav, resample

METRICS = ["SDR", "SISNR", "PESQ", "STOI"]  # reference names (:93)


def read_scp(path: str) -> dict[str, str]:
    out = {}
    with open(path) as f:
        for line in f:
            uid, audio_path = line.strip().split(maxsplit=1)
            out[uid] = audio_path
    return out


def process_one_pair(item: tuple[str, str, str], fs: int = 16000):
    uid, ref_path, inf_path = item
    ref, fs_r = read_wav(ref_path)
    inf, fs_i = read_wav(inf_path)
    if ref.ndim > 1:
        ref = ref[:, 0]
    if inf.ndim > 1:
        inf = inf[:, 0]
    if fs_r != fs:
        ref = resample(ref, fs_r, fs)
    if fs_i != fs:
        inf = resample(inf, fs_i, fs)
    n = min(len(ref), len(inf))
    ref, inf = ref[:n], inf[:n]
    pesq = pesq_metric(ref, inf, fs)
    return uid, {
        "SDR": sdr_metric(ref, inf),
        "SISNR": sisnr_metric(ref, inf),
        "PESQ": float("nan") if pesq is None else pesq,
        "STOI": stoi_metric(ref, inf, fs),
    }


def main(args=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ref_scp", required=True)
    parser.add_argument("--inf_scp", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--nj", type=int, default=8)
    parser.add_argument("--nsplits", type=int, default=1)
    parser.add_argument("--job", type=int, default=1)
    ns = parser.parse_args(args)

    refs = read_scp(ns.ref_scp)
    pairs = [(uid, refs[uid], path) for uid, path in read_scp(ns.inf_scp).items()]
    if ns.nsplits > 1:  # manual job sharding (reference dnsmos :56-66)
        pairs = pairs[ns.job - 1 :: ns.nsplits]

    with cf.ProcessPoolExecutor(max_workers=ns.nj,
                                mp_context=multiprocessing.get_context("spawn")) as pool:
        ret = list(pool.map(process_one_pair, pairs))

    os.makedirs(ns.output_dir, exist_ok=True)
    # shard naming of the reference (eval_nonintrusive_dnsmos.py:67): <METRIC><.job>.scp
    suffix = "" if ns.nsplits == 1 else f".{ns.job}"
    for metric in METRICS:
        with open(os.path.join(ns.output_dir, f"{metric}{suffix}.scp"), "w") as f:
            f.writelines(f"{uid} {score[metric]}\n" for uid, score in ret)

    if ns.nsplits == 1:  # the reference only writes RESULTS for a full run
        with open(os.path.join(ns.output_dir, "RESULTS.txt"), "w") as f:
            for metric in METRICS:
                mean = np.nanmean([score[metric] for _, score in ret])
                f.write(f"{metric}: {mean:.4f}\n")
            f.write(
                "# NOTE: PESQ/STOI are from-spec implementations "
                "(eval/pesq.py, eval/metrics.py), ladder-calibrated, not "
                "the ITU/pystoi binaries (EVAL.md 'metric provenance').\n"
                "# NOTE: PESQ time alignment = global delay + per-utterance "
                "residual (piecewise-constant); delay drift WITHIN an "
                "utterance (e.g. clock skew) is not tracked and such pairs "
                "will be mis-scored.\n"
            )
        print(f"Overall results have been written in "
              f"{os.path.join(ns.output_dir, 'RESULTS.txt')}", flush=True)


if __name__ == "__main__":
    main()
