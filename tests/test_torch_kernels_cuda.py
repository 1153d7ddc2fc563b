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
        yk, ks = kern.step(ks, x)
        yp, ps = plain.step(ps, x)
        torch.cuda.synchronize()
        assert (yk - yp).abs().max().item() <= 1e-4
    for name, *_ in RING_DEFS:
        assert (ks[name] - ps[name]).abs().max().item() <= 1e-4, name
    assert kern.launches == 24


def _models(cuda, backend, dtype):
    from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params
    from gtcrn_micro_tpu_torch.ops.fused_grid import GridFusedGTCRNMicro
    from gtcrn_micro_tpu_torch.ops.fused_step import FusedGTCRNMicro, LayoutGTCRNMicro

    params = init_params(torch.Generator().manual_seed(0), device=cuda)
    cls = FusedGTCRNMicro if backend == "fused_step" else GridFusedGTCRNMicro
    return cls(params, dtype=dtype, device=cuda), LayoutGTCRNMicro(params, dtype=dtype, device=cuda)


@pytest.mark.parametrize("backend", ["fused_step", "fused_grid"])
def test_kernel_bf16_within_one_step(cuda, backend):
    """bf16 storage, one step from a random state at 2,000 streams: every
    output and ring value within one bf16 step (2^-7) of the largest
    magnitude of the plain version's."""
    kern, plain = _models(cuda, backend, torch.bfloat16)
    batch = 2000
    g = torch.Generator().manual_seed(2)
    ps = plain.init_state(batch)
    for name, *_ in RING_DEFS:
        ps[name].copy_(torch.rand(ps[name].shape, generator=g).mul_(0.6).sub_(0.3))
    ps["step"] = 7
    ks = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in ps.items()}
    x = (torch.randn((batch, 257, 1, 2), generator=g) * 0.2).to(cuda, torch.bfloat16)
    yk, ks = kern.step(ks, x)
    yp, ps = plain.step(ps, x)
    torch.cuda.synchronize()
    step = 2 ** -7 * yp.float().abs().max().item()
    assert (yk.float() - yp.float()).abs().max().item() <= step
    for name, *_ in RING_DEFS:
        ref = ps[name].float()
        assert (ks[name].float() - ref).abs().max().item() <= 2 ** -7 * ref.abs().max().item(), name


@pytest.mark.parametrize("backend", ["fused_step", "fused_grid"])
def test_kernel_multi_wave_ragged(cuda, backend):
    """1,061 streams (more than one wave of 132 CTAs of 8, last tile of 5)
    in f32 over 24 frames: max-abs 1e-4, rings included."""
    kern, plain = _models(cuda, backend, torch.float32)
    batch = 1061
    ks, ps = kern.init_state(batch), plain.init_state(batch)
    g = torch.Generator().manual_seed(3)
    for _ in range(24):
        x = (torch.randn((batch, 257, 1, 2), generator=g) * 0.2).to(cuda)
        yk, ks = kern.step(ks, x)
        yp, ps = plain.step(ps, x)
        torch.cuda.synchronize()
        assert (yk - yp).abs().max().item() <= 1e-4
    for name, *_ in RING_DEFS:
        assert (ks[name] - ps[name]).abs().max().item() <= 1e-4, name


@pytest.mark.parametrize("backend", ["fused_step", "fused_grid"])
def test_kernel_updates_rings_in_place(cuda, backend):
    """A step allocates its output and nothing else (B1 passes each ring's
    tap-0 slot as the frame's destination: no frame tensors, no copies), and
    every ring keeps its storage."""
    kern, _plain = _models(cuda, backend, torch.float32)
    batch = 64
    st = kern.init_state(batch)
    x = (torch.randn((batch, 257, 1, 2), generator=torch.Generator().manual_seed(4))).to(cuda)
    kern.step(st, x)  # first launch: builds and loads the library
    torch.cuda.synchronize()
    ptrs = {name: st[name].data_ptr() for name, *_ in RING_DEFS}
    before = {name: st[name].clone() for name, *_ in RING_DEFS}
    n0 = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    y, st = kern.step(st, x)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] - n0 == 1  # y
    for name, *_ in RING_DEFS:
        assert st[name].data_ptr() == ptrs[name], name
        assert not torch.equal(st[name], before[name]), name


@pytest.mark.parametrize("lib", ["fused_step", "fused_grid"])
def test_kernel_attrs_no_spills(cuda, lib):
    """Both instantiations of the kernel use no local memory (no spills, no
    stack frame)."""
    from gtcrn_micro_tpu_torch.ops import _build

    for dt, a in _build.kernel_attrs(lib).items():
        assert a["local_bytes"] == 0, dt
