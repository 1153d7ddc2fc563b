"""The port's ``gptq_params`` against JAX's own bake on the JAX test's setup
(tests/test_torch_gptq.py's fixture), on the CPU.

The integer codes agree but for weights whose captured inputs differ by a
quantum (the two forwards round differently at float32 ties): measured
99.63 % equal (63 of 16,865 codes differ), every other code one quantum
apart; bound 99 % and one quantum.  JAX's bake takes about 100 s here (its
eager per-boundary scaffolding), so it has a file of its own.
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from gtcrn_micro_tpu.quant import gptq as jg
from gtcrn_micro_tpu_torch.quant import gptq as tg
from tests.test_torch_gptq import _two_torch_threads, check_bake, setup  # noqa: F401


def test_gptq_params_codes_match_jax(setup):
    model, qp = setup["model"], setup["qp"]
    report = []
    codes = check_bake(model, qp, setup["specs"], tg.gptq_params(model, qp, setup["specs"],
                                                                report=report), report)
    jflat = {jax.tree_util.keystr(p, simple=True, separator="/"): np.array(v)
             for p, v in jax.tree_util.tree_leaves_with_path(
                 jg.gptq_params(setup["jm"], setup["params"], setup["jqp"],
                                jnp.asarray(setup["specs"])))}
    equal = total = 0
    for tpath, (c, scale) in codes.items():
        j_codes = torch.round(torch.from_numpy(jflat[tpath]) / scale)
        assert float((c - j_codes).abs().max()) <= 1.0, tpath
        equal += int((c == j_codes).sum())
        total += c.numel()
    assert equal / total >= 0.99, (equal, total)
