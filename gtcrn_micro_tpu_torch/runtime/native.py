"""The native C++ streaming engine: its build and its ctypes bindings.

Counterpart of the JAX package's ``runtime/native.py``.  The engine in
``native/`` is the deployment analog of the reference's microcontroller
runner: a dependency-free C++ program that runs the streaming model frame by
frame on the host CPU, from a GTM1 or GTM8 file (``io/export_native.py``).
It is bound through its C interface (``native/c_api.cc``) with ctypes.

:func:`build_native` compiles it on first use with ``g++`` directly (no
CMake), with the flags of ``native/CMakeLists.txt``: ``-O3
-fno-math-errno -ffp-contract=off -march=native``, and ``-fopenmp`` where
the toolchain links it.  ``-ffp-contract=off`` keeps every float epilogue
one IEEE operation at a time, which is what lets the engines bit-match the
fake-quant simulation.  The library and the ``gtcrn_stream`` CLI land in
``build/gtcrn_micro_tpu_torch/native/<key>/`` at the repository root, next
to the CUDA kernels, keyed by a hash of the sources, the flags and the
build host's ``-march=native`` target, so an edited source or another CPU
gets its own build.

    eng = NativeEngine("weights.bin")    # builds on first use
    out_spec = eng.step(spec_frame)      # (257, 2) -> (257, 2)
    enhanced = eng.enhance(samples)      # whole-utterance wav -> wav

``CLI_PATH`` (the ``gtcrn_stream`` binary) is resolved, and built, on first
access.  ``python -m gtcrn_micro_tpu_torch.runtime.native`` builds both and
prints the CLI's path (the root ``scripts/build_native.sh``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _REPO_ROOT / "native"
BUILD_ROOT = _REPO_ROOT / "build" / "gtcrn_micro_tpu_torch" / "native"
LIB_SOURCES = ("gtcrn_micro.cc", "gtcrn_micro_q.cc", "gtcrn_micro_pc.cc", "gtcrn_micro_v4.cc",
               "c_api.cc")
CXX_FLAGS = ["-std=c++17", "-O3", "-fno-math-errno", "-ffp-contract=off", "-march=native",
             "-fPIC"]
LIB_NAME, CLI_NAME = "libgtcrn_micro.so", "gtcrn_stream"


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native engine builds with g++")
    return cxx


def _run(cmd: list, cwd) -> None:
    res = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{' '.join(map(str, cmd))} failed:\n{res.stdout}{res.stderr}")


@functools.cache
def _build_dir() -> Path:
    """The build directory for these sources, flags and this CPU."""
    h = hashlib.sha256()
    for p in sorted(NATIVE_DIR.glob("*.cc")) + sorted(NATIVE_DIR.glob("*.h")):
        h.update(p.name.encode() + p.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    target = subprocess.run([_cxx(), "-march=native", "-E", "-dM", "-x", "c++", os.devnull],
                            capture_output=True, text=True, check=True).stdout
    h.update(target.encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _links_openmp(cxx: str, work: Path) -> bool:
    probe = work / "omp_probe.cc"
    probe.write_text("#include <omp.h>\nint main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n")
    res = subprocess.run([cxx, "-fopenmp", str(probe), "-o", str(work / "omp_probe")],
                         capture_output=True)
    return res.returncode == 0


def build_native(force: bool = False) -> str:
    """Compile the shared library and the CLI once (one ``g++`` per source,
    all at once, then the links) and return the library's path.  A build is
    made in a temporary directory and renamed into place, so a concurrent
    build or an interrupted one never leaves a partial library."""
    out = _build_dir()
    lib = out / LIB_NAME
    if lib.exists() and (out / CLI_NAME).exists() and not force:
        return str(lib)
    cxx = _cxx()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix=".tmp-"))
    try:
        flags = CXX_FLAGS + (["-fopenmp"] if _links_openmp(cxx, work) else [])
        inc = ["-I", str(NATIVE_DIR)]
        objs = [work / (Path(s).stem + ".o") for s in LIB_SOURCES]
        with ThreadPoolExecutor(len(LIB_SOURCES)) as pool:
            for f in [pool.submit(_run, [cxx, *flags, *inc, "-c", str(NATIVE_DIR / s), "-o", str(o)],
                                  work) for s, o in zip(LIB_SOURCES, objs)]:
                f.result()
        _run([cxx, *flags, "-shared", "-o", str(work / LIB_NAME), *map(str, objs)], work)
        _run([cxx, *flags, *inc, str(NATIVE_DIR / "main.cc"), "-o", str(work / CLI_NAME),
              "-L", str(work), "-lgtcrn_micro", "-Wl,-rpath,$ORIGIN"], work)
        for p in list(work.iterdir()):
            if p.name not in (LIB_NAME, CLI_NAME):
                p.unlink()
        if force and out.exists():
            shutil.rmtree(out)
        try:
            work.rename(out)
        except OSError:  # another process put the same build in place first
            shutil.rmtree(work)
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    return str(lib)


def __getattr__(name: str):
    if name == "CLI_PATH":
        return str(Path(build_native()).parent / CLI_NAME)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_PREFIX = {None: "gtm_", "int8": "gtm_q", "int16": "gtm_q16", "mixed": "gtm_q16",
           "pc": "gtm_pc", "v4": "gtm_v4", "v48": "gtm_v48"}


class NativeEngine:
    """One engine and one stream state (:meth:`step_batch` for servers).

    ``quant``: ``None`` loads a GTM1 float32 file; ``"int8"`` a GTM8
    full-int8 artifact through the int8 engine; ``"int16"`` the 16x8
    engine (int16 activations, int8 weights), which ``"mixed"`` names too
    since it also runs v2 mixed artifacts (per-boundary 8/16 bits); ``"pc"``
    a v3 per-lane artifact through the PC engine (int8 weights dequantized at
    load, per-lane fake-quant, float MACs); ``"v4"`` a v4 full-integer
    per-lane artifact (act-scale-folded int8 weights, integer MACs, int16
    activation storage), ``"v48"`` its int8-storage variant for pure-int8
    grids.  An engine refuses a file of another kind with ``RuntimeError``."""

    def __init__(self, weights_path: str, lib_path: str | None = None,
                 quant: str | None = None):
        self._lib = ctypes.CDLL(lib_path or build_native())
        if quant not in _PREFIX:
            raise ValueError(f"quant must be one of {list(_PREFIX)}, got {quant!r}")
        p = _PREFIX[quant]
        self._fn = {name: getattr(self._lib, f"{p}{name}")
                    for name in ("engine_create", "engine_destroy", "state_create",
                                 "state_destroy", "state_reset", "step", "enhance",
                                 "state_batch_create", "state_batch_destroy", "step_batch")}
        vp, fp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)
        sig = {"engine_create": (vp, [ctypes.c_char_p]), "engine_destroy": (None, [vp]),
               "state_create": (vp, [vp]), "state_destroy": (None, [vp]),
               "state_reset": (None, [vp, vp]), "step": (None, [vp, vp, fp, fp]),
               "enhance": (None, [vp, fp, ctypes.c_int, fp]),
               "state_batch_create": (vp, [vp, ctypes.c_int]),
               "state_batch_destroy": (None, [vp]),
               "step_batch": (None, [vp, vp, fp, fp, ctypes.c_int])}
        for name, (restype, argtypes) in sig.items():
            self._fn[name].restype, self._fn[name].argtypes = restype, argtypes
        self._state = self._batch_states = None
        self._engine = self._fn["engine_create"](os.fsencode(weights_path))
        if not self._engine:
            raise RuntimeError(f"failed to load weights: {weights_path}")
        self._state = self._fn["state_create"](self._engine)
        self._batch_n = 0

    def reset(self) -> None:
        self._fn["state_reset"](self._engine, self._state)

    def step(self, spec_frame: np.ndarray) -> np.ndarray:
        """(257, 2) spec frame -> enhanced (257, 2)."""
        buf = np.ascontiguousarray(np.asarray(spec_frame).T, np.float32)  # (2, 257)
        out = np.empty((2, 257), np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        self._fn["step"](self._engine, self._state, buf.ctypes.data_as(fp),
                         out.ctypes.data_as(fp))
        return out.T.copy()

    def step_batch(self, spec_frames: np.ndarray) -> np.ndarray:
        """(N, 257, 2) spec frames, one per stream -> enhanced (N, 257, 2).
        The N stream states are made on the first call and persist across
        calls; a call with another N starts N fresh ones."""
        n = spec_frames.shape[0]
        if self._batch_states is None or n != self._batch_n:
            if self._batch_states is not None:
                self._fn["state_batch_destroy"](self._batch_states)
            self._batch_states = self._fn["state_batch_create"](self._engine, n)
            self._batch_n = n
        buf = np.ascontiguousarray(np.swapaxes(spec_frames, 1, 2), np.float32)  # (N, 2, 257)
        out = np.empty((n, 2, 257), np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        self._fn["step_batch"](self._engine, self._batch_states, buf.ctypes.data_as(fp),
                               out.ctypes.data_as(fp), n)
        return np.swapaxes(out, 1, 2).copy()

    def enhance(self, samples: np.ndarray) -> np.ndarray:
        """16 kHz waveform -> enhanced waveform (same length)."""
        x = np.ascontiguousarray(samples, np.float32)
        out = np.empty_like(x)
        fp = ctypes.POINTER(ctypes.c_float)
        self._fn["enhance"](self._engine, x.ctypes.data_as(fp), len(x), out.ctypes.data_as(fp))
        return out

    def close(self) -> None:
        """Free the native states and the engine (idempotent)."""
        if self._batch_states is not None:
            self._fn["state_batch_destroy"](self._batch_states)
            self._batch_states = None
        if self._state is not None:
            self._fn["state_destroy"](self._state)
            self._state = None
        if getattr(self, "_engine", None):
            self._fn["engine_destroy"](self._engine)
            self._engine = None

    def __del__(self):
        if hasattr(self, "_fn"):
            self.close()


if __name__ == "__main__":
    lib = build_native()
    print(f"built: {lib} and {Path(lib).parent / CLI_NAME}")
