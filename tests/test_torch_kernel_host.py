"""The CUDA kernels' shared forward, csrc/gtcrn_forward.cuh, run on the CPU
and held against the plain PyTorch version.

The header is compiled by the host C++ compiler against the stand-ins in
tests/kernel_host/ (one std::thread per CUDA thread, a std::barrier per
__syncthreads, a cp.async copy whose destination reads as NaN until the
issuing thread's next wait, shared memory filled with NaN before each CTA,
TF32 rounding and a warp's mma.sync product through a barrier of its 32
threads; a tensor copy whose destination reads as NaN until every thread
has reached its wait on the copy's mbarrier, when it lands), with the two C
entries of kernels B1 and B2 (B2's staged path for bf16 at B % 8 == 0, its
tensor maps checked against cuTensorMapEncodeTiled's alignment rules) and one warp's
channel mix (host_mix).  So the kernels' indexing,
staging, barriers, ring contract and weight-layout checks, and the
per-device shared-memory attribute of prepare(), are tested here without a
GPU; what nvcc and the card add (their compiler, FMA contraction,
timing) is checked by tests/test_torch_kernels_cuda.py and chip_smoke.py.

Tolerances are those of the card tests: f32 max-abs 1e-4 over 20 frames
(another summation order across ~40 layers and a recurrence that crosses
the 16-slot ring wrap); bf16 storage, one step from a random state, every
value within one bf16 step (2^-7) of the largest magnitude.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from gtcrn_micro_tpu_torch.models.gtcrn_micro import init_params
from gtcrn_micro_tpu_torch.ops import _build
from gtcrn_micro_tpu_torch.ops.fused_step import (
    RING_DEFS,
    LayoutGTCRNMicro,
    _slots,
    kernel_weights,
)

HOST = Path(__file__).resolve().parent / "kernel_host"
B = 13  # two CTAs of 8, the second ragged
_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The forward built for the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("kernel_host")
    for p in HOST.iterdir():
        shutil.copy(p, d / p.name)
    # beside the stand-ins, so that its include of gtcrn_async.cuh finds theirs
    shutil.copy(_build.CSRC / "gtcrn_forward.cuh", d / "gtcrn_forward.cuh")
    so = d / "libhost.so"
    r = subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", f"-I{d}", "-o",
                        str(so), str(d / "emu.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    lib.host_fused_grid_b2.argtypes = [_I, _P, ctypes.POINTER(_I), _I, _P, _P,
                                       ctypes.POINTER(_P), _I, _I, ctypes.POINTER(_I)]
    lib.host_fused_step_b1.argtypes = [_I, _P, ctypes.POINTER(_I), _I, _P, _P,
                                       ctypes.POINTER(_P), ctypes.POINTER(_P), _I]
    lib.host_mix.argtypes = [_P, _P, _P, _I, _I]
    lib.host_mma_products.restype = ctypes.c_ulonglong
    return lib


@pytest.fixture(scope="module")
def params():
    return init_params(torch.Generator().manual_seed(0), device="cpu")


def _host_step(lib, kernel, kw, state, spec, staged=None):
    """One step of kernel B1 or B2 on the host, rings updated in place as the
    wrappers of ops/fused_step.py and ops/fused_grid.py do it; B2 asserts
    that it took (``staged`` True) or did not take the staged path."""
    spec = spec.contiguous()
    out = torch.empty_like(spec)
    t = state["step"]
    code = {torch.float32: 0, torch.bfloat16: 1}[spec.dtype]
    offs = (_I * len(kw.offsets))(*kw.offsets)
    args = (code, kw.buf.data_ptr(), offs, kw.buf.numel(), spec.data_ptr(), out.data_ptr())
    if kernel == "b2":
        rings = (_P * len(RING_DEFS))(*[state[n].data_ptr() for n, *_ in RING_DEFS])
        took = _I(-1)
        rc = lib.host_fused_grid_b2(*args, rings, t, spec.shape[0], ctypes.byref(took))
        if staged is not None:
            assert took.value == int(staged)
    else:
        taps = []
        for n, L, d, _shape in RING_DEFS:
            s0, s1 = _slots(t, L, d)
            taps += [state[n][s0], state[n][s1]]
        rc = lib.host_fused_step_b1(*args, (_P * 40)(*[x.data_ptr() for x in taps]),
                                    (_P * 20)(*[x.data_ptr() for x in taps[0::2]]),
                                    spec.shape[0])
    assert rc == 0
    state["step"] = (t + 1) & 15
    return out, state


@pytest.mark.parametrize("kernel", ["b1", "b2"])
def test_host_forward_matches_plain_f32(host_lib, params, kernel):
    plain = LayoutGTCRNMicro(params, device="cpu")
    kw = kernel_weights(plain.weights)
    ks, ps = plain.init_state(B), plain.init_state(B)
    g = torch.Generator().manual_seed(1)
    for _ in range(20):
        x = torch.randn((B, 257, 1, 2), generator=g) * 0.2
        yk, ks = _host_step(host_lib, kernel, kw, ks, x)
        yp, ps = plain.step(ps, x)
        assert (yk - yp).abs().max().item() <= 1e-4
    for name, *_ in RING_DEFS:
        assert (ks[name] - ps[name]).abs().max().item() <= 1e-4, name
    assert ks["step"] == ps["step"] == 20 & 15


def _bf16_one_step(lib, params, kernel, batch, step, staged=None):
    """One bf16 step of the kernel from a random ring state: every output and
    ring value within one bf16 step (2^-7) of the largest magnitude of the
    plain version's."""
    plain = LayoutGTCRNMicro(params, dtype=torch.bfloat16, device="cpu")
    kw = kernel_weights(plain.weights)
    g = torch.Generator().manual_seed(2)
    ps = plain.init_state(batch)
    for name, *_ in RING_DEFS:
        ps[name].copy_(torch.rand(ps[name].shape, generator=g).mul_(0.6).sub_(0.3))
    ps["step"] = step
    ks = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in ps.items()}
    x = (torch.randn((batch, 257, 1, 2), generator=g) * 0.2).to(torch.bfloat16)
    yk, ks = _host_step(lib, kernel, kw, ks, x, staged)
    yp, ps = plain.step(ps, x)
    assert (yk.float() - yp.float()).abs().max().item() <= 2 ** -7 * yp.float().abs().max().item()
    for name, *_ in RING_DEFS:
        ref = ps[name].float()
        assert (ks[name].float() - ref).abs().max().item() <= 2 ** -7 * ref.abs().max().item(), name


@pytest.mark.parametrize("kernel", ["b1", "b2"])
def test_host_forward_bf16_within_one_step(host_lib, params, kernel):
    """B = 13: B2 reads each tap from the rings (B % 8 != 0)."""
    _bf16_one_step(host_lib, params, kernel, B, 11, staged=False if kernel == "b2" else None)


@pytest.mark.parametrize("batch", [16, 24])
def test_host_forward_bf16_staged_within_one_step(host_lib, params, batch):
    """B2's staged path (bf16, B % 8 == 0): every ring-reading layer's taps
    copied into shared memory by tensor copies a layer ahead, read only after
    the layer's wait; at step 13, so that the copies' slot coordinates are
    others than at the B = 13 case's step 11."""
    _bf16_one_step(host_lib, params, "b2", batch, 13, staged=True)



def _host_mix(lib, w, x, pair, products):
    y = torch.empty_like(x)
    assert lib.host_mix(w.data_ptr(), x.data_ptr(), y.data_ptr(), pair, products) == 0
    return y


def _mix_rel_err(lib, pair, products):
    """A warp's 16x16 mix of 32 items (seeded weights and activations, float32)
    against the float64 product: Frobenius norm of the error over the
    product's."""
    g = torch.Generator().manual_seed(5)
    w, x = torch.randn((16, 16), generator=g), torch.randn((16, 32), generator=g)
    ref = w.double() @ x.double()
    y = _host_mix(lib, w, x, pair, products)
    return ((y.double() - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize("order", ["split", "pair"])
def test_host_mix_three_tf32_products_are_float32(host_lib, order):
    """The tensor-core mix (mix_tc: operands split into TF32 big and small
    parts, three mma products) is within 2^-20 of the float64 product, with
    the input tile in either order."""
    assert _mix_rel_err(host_lib, order == "pair", 3) <= 2 ** -20


def test_host_mix_one_tf32_product_misses_the_bound(host_lib):
    """The same fragments with the big parts alone (one TF32 product) miss
    2^-20 by far, so dropping the split would fail the test above."""
    assert _mix_rel_err(host_lib, False, 1) > 2 ** -14


# The mixes kernels B1 and B2 issue on mma, per layer: (mixes a warp issues a
# frame, the (row, tap) pairs of a stream-frame they compute, output channels).
# A warp's mix covers 4 rows of 8 streams and every tap, so it issues rows
# past F = 33 and taps on the zero padding too.
TC_MIXES = {
    "en1": (5, 161, 16),  # (1,5) stride 2: 5 taps, 161 inside 65 bins
    "tcn_pw1_pw3": (8 * 2, 8 * 2 * 33, 16),
    "dec_3x3": (3 * 9, 3 * 3 * 97, 16),  # 3 frames x 3 freq taps, 97 inside
    "gtconv_pw2": (6, 6 * 33, 8),
    "de3": (5, 161, 16),  # (1,5) transposed, stride 2: 3 even + 2 odd taps
}


@pytest.mark.parametrize("kernel", ["b1", "b2"])
def test_host_forward_issues_the_tensor_core_mixes(host_lib, params, kernel):
    """One frame of 8 streams (one CTA of 9 warps) issues on mma exactly the
    mixes of TC_MIXES, three TF32 products of each m16n8k8 tile, and
    utils/roofline.tc_macs_per_stream counts the same mixes' multiply-adds
    inside the layers: a mix moved to or from the tensor cores fails here
    until both are brought up to date."""
    from gtcrn_micro_tpu_torch.utils.roofline import tc_macs_per_stream

    plain = LayoutGTCRNMicro(params, device="cpu")
    kw = kernel_weights(plain.weights)
    x = torch.randn((8, 257, 1, 2), generator=torch.Generator().manual_seed(3)) * 0.2
    host_lib.host_mma_products()
    _host_step(host_lib, kernel, kw, plain.init_state(8), x)
    # a mix of CO outputs: 2 m16 tiles x CO / 8 n8 tiles x 2 k8 steps x 3 products
    assert host_lib.host_mma_products() == 9 * sum(
        n * 2 * (co // 8) * 2 * 3 for n, _pairs, co in TC_MIXES.values())
    assert tc_macs_per_stream() == sum(pairs * 16 * co for _n, pairs, co in TC_MIXES.values())


BAD_LAYOUTS = ["entry_outside_its_group", "sfe_in_a_tcn_group", "misaligned_entry",
               "entry_past_buffer", "last_group_over_staging_buffer"]


def _bad_layout(case, kw):
    """Entry offsets and buffer length of a weight layout make_plan must
    refuse, each one change away from the real one."""
    offs, wlen = list(kw.offsets), kw.buf.numel()
    if case == "entry_outside_its_group":
        offs[4] = kw.offsets[7]  # en0's bias in en1's group: aligned, in the buffer
    elif case == "sfe_in_a_tcn_group":
        offs[2] = kw.offsets[50]
    elif case == "misaligned_entry":
        offs[5] += 1
    elif case == "entry_past_buffer":
        offs[157] = wlen
    elif case == "last_group_over_staging_buffer":
        wlen += 4096
    return offs, wlen


@pytest.mark.parametrize("case", BAD_LAYOUTS)
def test_host_make_plan_refuses_bad_layout(host_lib, params, case):
    """The C entries refuse a weight layout the staged forward would read
    from the wrong place (make_plan); the real layout is accepted and runs."""
    plain = LayoutGTCRNMicro(params, device="cpu")
    kw = kernel_weights(plain.weights)
    spec = torch.zeros((1, 257, 1, 2))
    out = torch.empty_like(spec)
    st = plain.init_state(1)
    rings = (_P * len(RING_DEFS))(*[st[n].data_ptr() for n, *_ in RING_DEFS])

    def rc(offs, wlen):
        return host_lib.host_fused_grid_b2(0, kw.buf.data_ptr(), (_I * len(offs))(*offs), wlen,
                                           spec.data_ptr(), out.data_ptr(), rings, 0, 1, None)

    assert rc(list(kw.offsets), kw.buf.numel()) == 0
    assert rc(*_bad_layout(case, kw)) == 1


def test_host_prepare_sets_the_attribute_once_per_device(host_lib):
    """prepare() gives a kernel its dynamic shared memory once on each
    device: CUDA keeps function attributes per device, so a kernel prepared
    on device 0 is prepared again on device 1 (the second card of a sharded
    server), and on neither twice."""
    host_lib.host_prepare_on.restype = _I
    host_lib.host_prepare_on.argtypes = [_I]
    assert [host_lib.host_prepare_on(d) for d in (0, 0, 1, 1, 0, 3)] == [1] * 6
