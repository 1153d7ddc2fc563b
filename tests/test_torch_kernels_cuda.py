"""The CUDA kernels B1 and B2 against their plain PyTorch version, on the card.

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc`` and skip elsewhere.
Run them on a GPU host with ``python -m pytest tests/test_torch_kernels_cuda.py``.
Tolerance: f32 max-abs 1e-4 over 24 frames (the kernels sum in another order
across ~40 layers and a 24-step recurrence), the bound chip_smoke.py uses.
"""

import pytest
import torch

from gtcrn_micro_tpu_torch.ops.fused_step import RING_DEFS

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels are CUDA C++ for sm_90a)")
    from gtcrn_micro_tpu_torch.ops import _build

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("backend", ["fused_step", "fused_grid"])
@pytest.mark.parametrize("batch", [16, 13])  # 13: a ragged last tile
def test_kernel_matches_plain(cuda, backend, batch):
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params
    from gtcrn_micro_tpu_torch.ops.fused_grid import GridFusedGTCRNMicro
    from gtcrn_micro_tpu_torch.ops.fused_step import FusedGTCRNMicro, LayoutGTCRNMicro

    params = init_params(torch.Generator().manual_seed(0), device=cuda)
    cls = FusedGTCRNMicro if backend == "fused_step" else GridFusedGTCRNMicro
    kern, plain = cls(params, device=cuda), LayoutGTCRNMicro(params, device=cuda)
    ks, ps = kern.init_state(batch), plain.init_state(batch)
    g = torch.Generator().manual_seed(1)
    for _ in range(24):
        x = (torch.randn((batch, 257, 1, 2), generator=g) * 0.2).to(cuda)
        yk, ks = kern.step(None, ks, x)
        yp, ps = plain.step(None, ps, x)
        torch.cuda.synchronize()
        assert (yk - yp).abs().max().item() <= 1e-4
    for name, *_ in RING_DEFS:
        assert (ks[name] - ps[name]).abs().max().item() <= 1e-4, name
    assert kern.launches == 24
