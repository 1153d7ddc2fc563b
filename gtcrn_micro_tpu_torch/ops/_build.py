"""Build and bind the CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` is compiled on first use by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/gtcrn_micro_tpu_torch/lib<name>-<hash>.so

The output lands in ``build/gtcrn_micro_tpu_torch/`` at the repository root,
named by a hash of the sources, so an edited kernel is rebuilt and an
unchanged one is reused.  The libraries are loaded with ``ctypes``: every
pointer and the stream are ``c_void_p``, kernels launch on PyTorch's current
stream, and each C entry returns ``cudaGetLastError()``; a non-zero code
raises here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gtcrn_micro_tpu_torch"
SOURCES = ("fused_step", "fused_grid")
TILE = 8  # streams per CTA: TILE in csrc/gtcrn_forward.cuh
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_I = ctypes.c_int
_SIGNATURES = {
    # int gtcrn_fused_step_b1(dtype, W, offsets, wlen, spec, out,
    #                         taps[40], frames[20], B, stream)
    "fused_step": ("gtcrn_fused_step_b1",
                   [_I, _P, ctypes.POINTER(_I), _I, _P, _P, _PP, _PP, _I, _P]),
    # int gtcrn_fused_grid_b2(dtype, W, offsets, wlen, spec, out,
    #                         rings[20], t, B, stream, int* staged)
    "fused_grid": ("gtcrn_fused_grid_b2",
                   [_I, _P, ctypes.POINTER(_I), _I, _P, _P, _PP, _I, _I, _P,
                    ctypes.POINTER(_I)]),
}
# int gtcrn_<source>_attrs(int out[4 * n]): per instantiation (_KINDS) the
# kernel's registers per thread, local bytes per thread, shared bytes per CTA
# and resident CTAs per SM
_ATTRS = ("regs", "local_bytes", "smem_bytes", "ctas_per_sm")
_KINDS = {"fused_step": ("float32", "bfloat16"),
          "fused_grid": ("float32", "bfloat16", "bfloat16_staged")}

_libs: dict = {}
_attr_fns: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "host with the CUDA toolkit")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every source whose library is missing, one ``nvcc`` each, all
    in parallel, printing what ptxas reports (registers, shared memory,
    spills).  Returns the seconds spent; raises with the compiler's output
    if a build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
            if log.strip():
                print(f"[nvcc {name}.cu]\n{log.strip()}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        sym, argtypes = _SIGNATURES[name]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        attrs = getattr(lib, f"gtcrn_{name}_attrs")
        attrs.argtypes = [ctypes.POINTER(_I)]
        attrs.restype = ctypes.c_int
        _libs[name], _attr_fns[name] = fn, attrs
    return _libs[name]


def kernel_attrs(name: str) -> dict:
    """What the compiled kernel of source ``name`` uses, per instantiation:
    ``{"float32": {"regs", "local_bytes", "smem_bytes", "ctas_per_sm"},
    "bfloat16": {...}}``, and for B2 ``"bfloat16_staged"`` (its staged
    taps), from cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current card."""
    _load(name)
    kinds = _KINDS[name]
    vals = (ctypes.c_int * (4 * len(kinds)))()
    _raise_on(_attr_fns[name](vals), f"gtcrn_{name}_attrs")
    return {kind: dict(zip(_ATTRS, vals[4 * i : 4 * i + 4]))
            for i, kind in enumerate(kinds)}


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_ring(ring: torch.Tensor, name: str, shape: tuple,
               spec: torch.Tensor) -> torch.Tensor:
    """Raise unless a ring state tensor is what the kernels take."""
    if (tuple(ring.shape) != shape or ring.dtype != spec.dtype
            or ring.device != spec.device or not ring.is_contiguous()):
        raise ValueError(
            f"ring {name}: want contiguous {shape} {spec.dtype} on "
            f"{spec.device}, got {tuple(ring.shape)} {ring.dtype} on {ring.device}")
    return ring


def _common(kw, spec: torch.Tensor, out: torch.Tensor):
    """Check the arguments every kernel takes: ``kw`` is the
    :class:`~gtcrn_micro_tpu_torch.ops.fused_step.KernelWeights` (float32
    whatever the storage dtype), spec and out in the storage dtype."""
    if spec.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernels take float32 or bfloat16, got {spec.dtype}")
    if out.dtype != spec.dtype or out.device != spec.device:
        raise ValueError(f"out must be {spec.dtype} on {spec.device}")
    if kw.buf.dtype != torch.float32 or kw.buf.device != spec.device or kw.buf.dim() != 1:
        raise ValueError(f"kernel weights must be 1-D float32 on {spec.device}")
    if not (spec.is_contiguous() and out.is_contiguous() and kw.buf.is_contiguous()):
        raise ValueError("spec, out and weights must be contiguous")
    offs = (ctypes.c_int * len(kw.offsets))(*kw.offsets)
    stream = ctypes.c_void_p(torch.cuda.current_stream(spec.device).cuda_stream)
    return _DTYPE_CODE[spec.dtype], offs, kw.buf.numel(), stream


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code} "
                           f"({torch.cuda.get_device_name()})")


def launch_b1(kw, spec, out, taps: list, frames: list) -> None:
    """Kernel B1: 40 tap frames in, 20 new frames out (all ``(*frame, B)``).
    A frame may be its ring's tap 0: the kernel writes it after its last
    read of that tap."""
    dt, offs, wlen, stream = _common(kw, spec, out)
    tap_arr = (ctypes.c_void_p * len(taps))(*[t.data_ptr() for t in taps])
    frame_arr = (ctypes.c_void_p * len(frames))(*[f.data_ptr() for f in frames])
    fn = _load("fused_step")
    with torch.cuda.device(spec.device):
        code = fn(dt, _ptr(kw.buf), offs, wlen, _ptr(spec), _ptr(out),
                  tap_arr, frame_arr, spec.shape[0], stream)
    _raise_on(code, "gtcrn_fused_step_b1")


def launch_b2(kw, spec, out, rings: list, t: int) -> bool:
    """Kernel B2: reads each ring's taps at slots (t mod L, (t+d) mod L) and
    writes the new frame at slot t mod L in place.  Returns whether the
    launch staged the taps in shared memory by tensor copies, which the C
    entry does for bf16 storage with B a multiple of 8."""
    dt, offs, wlen, stream = _common(kw, spec, out)
    ring_arr = (ctypes.c_void_p * len(rings))(*[r.data_ptr() for r in rings])
    fn = _load("fused_grid")
    staged = ctypes.c_int(0)
    with torch.cuda.device(spec.device):
        code = fn(dt, _ptr(kw.buf), offs, wlen, _ptr(spec), _ptr(out),
                  ring_arr, t, spec.shape[0], stream, ctypes.byref(staged))
    _raise_on(code, "gtcrn_fused_grid_b2")
    return bool(staged.value)
