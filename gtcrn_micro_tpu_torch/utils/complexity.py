"""Model complexity: the parameter count (reference: ptflops,
gtcrn_micro.py:539-544, published 19.01k parameters, gtcrn_micro/README.md:25).
"""

from __future__ import annotations

import math


def param_count(params: dict, trainable_only: bool = True) -> int:
    """Number of values in a nested param dict; ``trainable_only`` leaves
    out the frozen ERB filters and the BatchNorm running statistics."""
    total = 0

    def walk(node, path):
        nonlocal total
        for k, v in node.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                walk(v, p)
            elif not (trainable_only and ("erb" in p or "running" in p)):
                total += math.prod(v.shape)

    walk(params, "")
    return total
