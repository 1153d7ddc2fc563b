"""Evaluation dispatcher (the JAX package's ``eval/evaluate.py``; reference
eval/evaluate.py:8-38).

``python -m gtcrn_micro_tpu_torch.eval.evaluate -C configs/cfg_infer.yaml
--metric intrusive`` scores the ``inf.scp`` / ``ref.scp`` manifests that
``gtcrn_micro_tpu_torch.eval.infer`` wrote.  ``--metric dnsmos`` needs an
ONNX executor the port does not have yet (ROADMAP queue A, item 7) and
raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os


def main(args=None) -> None:
    from gtcrn_micro_tpu_torch.utils.config import load_config

    parser = argparse.ArgumentParser()
    parser.add_argument("-C", "--config", default="configs/cfg_infer.yaml")
    parser.add_argument("--metric", choices=["intrusive", "dnsmos"], default="intrusive")
    parser.add_argument("--nj", type=int, default=8)
    ns = parser.parse_args(args)
    if ns.metric == "dnsmos":
        raise NotImplementedError(
            "--metric dnsmos needs the ONNX executor of io/onnx.py, not yet ported "
            "(ROADMAP queue A, item 7)")
    cfg = load_config(ns.config)

    enh_dir = cfg["network"]["enh_folder"]
    from gtcrn_micro_tpu_torch.eval.intrusive import main as run

    run(["--ref_scp", os.path.join(enh_dir, "ref.scp"),
         "--inf_scp", os.path.join(enh_dir, "inf.scp"),
         "--output_dir", os.path.join(enh_dir, f"RESULTS_{ns.metric}"),
         "--nj", str(ns.nj)])


if __name__ == "__main__":
    main()
