"""The per-frame forward as ONE in-place kernel launch (kernel B2).

Counterpart of the JAX package's ``ops/fused_grid.py``.  B2 computes the
same forward as B1 (``ops/fused_step.py``) but needs no gather or scatter
around it: each CTA reads its streams' two tap frames of every ring straight
from the ring state at slots ``(t mod L, (t+d) mod L)`` and writes the new
frame in place at slot ``t mod L``.  The rings keep the port's ``(L, *frame,
B)`` layout (no pad of F to 40; that was a Mosaic DMA workaround).  With
bf16 storage and a batch that is a multiple of 8 the kernel copies each
ring-reading layer's taps into shared memory by TMA a layer ahead (the
staged path); otherwise each thread loads its own taps.

This is the default backend of :class:`gtcrn_micro_tpu_torch.serve.CohortServer`.
"""

from __future__ import annotations

from gtcrn_micro_tpu_torch.ops import _build
from gtcrn_micro_tpu_torch.ops.fused_step import FusedGTCRNMicro
from gtcrn_micro_tpu_torch.utils.profiling import count


class GridFusedGTCRNMicro(FusedGTCRNMicro):
    """Serving model: one launch of kernel B2 per step on CUDA tensors (the
    plain version on CPU tensors).  Same step protocol and state as
    :class:`FusedGTCRNMicro`; ``launches`` counts kernel launches and
    ``staged_launches`` those that took the staged path (also the counter
    ``serve.b2_staged`` under tracing)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.staged_launches = 0

    def _launch(self, spec, out, rings, t):
        if _build.launch_b2(self.kernel_weights, spec, out, rings, t):
            self.staged_launches += 1
            count("serve.b2_staged")
        self.launches += 1
