"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> ctypes).

The sources are compiled on first use into a shared library with a plain C
interface, ``_build/libraytracer_kernels-<hash>.so``, keyed on a hash of
the sources and flags, and loaded with ctypes. Nothing here runs at
import. ``-fmad=false`` and no fast math keep every multiply-add, divide
and square root IEEE, so the kernels agree bit for bit with their plain
PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("trace4.cu", "bounce12.cu")
HEADERS = ("walk.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _declare(lib) -> None:
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rt_trace4.restype = i32
    lib.rt_trace4.argtypes = [vp, vp, vp, vp, vp, i32, f32, f32, f32, vp]
    lib.rt_bounce12.restype = i32
    lib.rt_bounce12.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, f32,
                                i32, f32, f32, f32, vp]


def library():
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = os.path.join(BUILD_DIR, f"libraytracer_kernels-{_digest()}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   *(os.path.join(CSRC, s) for s in SOURCES)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            with open(so[:-3] + ".log", "w") as f:
                f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stderr[-4000:]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _declare(lib)
        _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")
