"""Evaluation dispatcher (the JAX package's ``eval/evaluate.py``; reference
eval/evaluate.py:8-38).

``python -m gtcrn_micro_tpu_torch.eval.evaluate -C configs/cfg_infer.yaml
--metric {intrusive,dnsmos}`` scores the ``inf.scp`` (and, for
``intrusive``, ``ref.scp``) manifests that ``gtcrn_micro_tpu_torch.eval.infer``
wrote.  ``dnsmos`` runs on ``--device`` (default: cuda).
"""

from __future__ import annotations

import argparse
import os

from gtcrn_micro_tpu_torch.utils.config import load_config


def main(args=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("-C", "--config", default="configs/cfg_infer.yaml")
    parser.add_argument("--metric", choices=["intrusive", "dnsmos"], default="intrusive")
    parser.add_argument("--nj", type=int, default=8)
    parser.add_argument("--device", default=None, help="dnsmos: default cuda")
    ns = parser.parse_args(args)
    cfg = load_config(ns.config)

    enh_dir = cfg["network"]["enh_folder"]
    inf_scp = os.path.join(enh_dir, "inf.scp")
    out_dir = os.path.join(enh_dir, f"RESULTS_{ns.metric}")

    if ns.metric == "intrusive":
        from gtcrn_micro_tpu_torch.eval.intrusive import main as run

        run(["--ref_scp", os.path.join(enh_dir, "ref.scp"), "--inf_scp", inf_scp,
             "--output_dir", out_dir, "--nj", str(ns.nj)])
    else:
        from gtcrn_micro_tpu_torch.eval.dnsmos import main as run

        run(["--inf_scp", inf_scp, "--output_dir", out_dir]
            + (["--device", ns.device] if ns.device else []))


if __name__ == "__main__":
    main()
