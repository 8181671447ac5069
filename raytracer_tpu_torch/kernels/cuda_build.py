"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> ctypes).

The sources are compiled on first use, one ``nvcc`` process per source,
all started together, then linked into a shared library with a plain C
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
SOURCES = ("trace4.cu", "trace2.cu", "bounce12.cu", "bounce_pd5.cu",
           "bounce_om9.cu", "tonemap.cu", "mega.cu")
HEADERS = ("walk.cuh", "walk2.cuh", "pcg.cuh", "bounce.cuh")
# Kernel B's builds of other keys and walk orders go by
# kernels/bounce.py build_name ("bounce12_pd5", ...).
KERNELS = ("trace4", "trace2", "trace2_warp", "bounce12", "bounce12_pl",
           "bounce15", "bounce15_pmega", "bounce_packed", "tonemap", "mega",
           "bounce12_pd5", "bounce12_om9", "bounce12_unordered",
           "bounce15_pd5", "bounce15_om9", "bounce15_unordered",
           "bounce_packed_pd5", "bounce_packed_om9")
ATTRS = ("regs", "local_bytes", "smem_bytes", "blocks_per_sm", "threads")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    lib.rt_trace4.argtypes = [vp, vp, vp, vp, vp, i32, f32, f32, f32, i32,
                              vp]
    for name in ("rt_trace2", "rt_trace2_warp"):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, f32, f32, f32, i32,
                       vp]
    for name in ("rt_bounce12", "rt_bounce12_pl", "rt_bounce15"):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = [vp] * 7 + [i32, i32, i32, f32, i32, f32, f32, f32,
                                  i32, i32, vp]
    lib.rt_bounce_packed.restype = i32
    lib.rt_bounce_packed.argtypes = [vp] * 9 + [i32, i32, i32, i32, f32, i32,
                                                f32, f32, f32, i32, vp]
    lib.rt_bounce_packed_count.restype = i32
    lib.rt_bounce_packed_count.argtypes = [vp] * 11 + [
        i32, i32, i32, i32, f32, i32, f32, f32, f32, vp]
    lib.rt_tonemap.restype = i32
    lib.rt_tonemap.argtypes = [vp, vp, vp, i32, i32, vp, vp, vp]
    lib.rt_mega.restype = i32
    lib.rt_mega.argtypes = [vp] * 9 + [i32] * 7 + [f32] * 4 + [vp]
    for name in KERNELS:
        fn = getattr(lib, f"rt_{name}_attrs")
        fn.restype = i32
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]


def library():
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = os.path.join(BUILD_DIR, f"libraytracer_kernels-{_digest()}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            _build(so)
        lib = ctypes.CDLL(so)
        _declare(lib)
        _lib = lib
        return _lib


def _run(cmds, log_path: str) -> None:
    """Run the commands in parallel; log them all, raise on a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    with open(log_path, "a") as f:
        for c, out in zip(cmds, outs):
            f.write(" ".join(c) + "\n" + out)
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {c[-1]}\n"
                               f"{out[-4000:]}")


def _build(so: str) -> None:
    """One nvcc per source, all at once, then one link into ``so``."""
    tag = f"{so[:-3]}.{os.getpid()}"
    log = so[:-3] + ".log"
    objs = [f"{tag}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
    _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)]
          for o, s in zip(objs, SOURCES)], log)
    _run([[_nvcc(), "-shared", "-o", f"{tag}.tmp", *objs]], log)
    os.replace(f"{tag}.tmp", so)
    for o in objs:
        os.remove(o)


def kernel_attrs(name: str) -> dict:
    """What a launch of kernel ``name`` (one of KERNELS) gets, from
    ``cudaFuncGetAttributes`` and the occupancy calculator: registers and
    local memory bytes a thread, shared memory bytes a block, resident
    blocks per SM, threads a block."""
    out = (ctypes.c_int * len(ATTRS))()
    check(getattr(library(), f"rt_{name}_attrs")(out), f"rt_{name}_attrs")
    return dict(zip(ATTRS, out))


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")
