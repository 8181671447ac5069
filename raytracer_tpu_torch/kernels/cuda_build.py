"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> ctypes).

The sources are compiled on first use, one ``nvcc`` process per source,
all started together, then linked into a shared library with a plain C
interface, ``_build/libraytracer_kernels-<hash>.so``, keyed on a hash of
the sources and flags, and loaded with ctypes. Nothing here runs at
import. ``-fmad=false`` and no fast math keep every multiply-add, divide
and square root IEEE, so the kernels agree bit for bit with their plain
PyTorch versions.

One library a table layout (``FastScene.layout``: cluster size, wide
width): the default (8, 8) is built with no layout flags; any other with
``-DRT_CLUSTER=<cs> -DRT_WIDE=<w>``, which ``walk.cuh`` reads at compile
time, into ``libraytracer_kernels-c<cs>w<w>-<hash>.so``. Each is built
the first time a scene of its layout is walked on the card (or by
``build``, which starts several at once). A launch books under
``kernel_name``: the kernel's own name at the default layout, else with
the layout's tag ("trace4_c4", "bounce12_pd5_w16", "trace2_c2w16").
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from raytracer_tpu_torch.core.fast_types import DEFAULT_LAYOUT

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("trace4.cu", "trace2.cu", "bounce12.cu", "bounce_pd5.cu",
           "bounce_om9.cu", "tonemap.cu", "mega.cu", "front.cu")
HEADERS = ("walk.cuh", "walk2.cuh", "pcg.cuh", "bounce.cuh", "shade.cuh")
# Kernel B's builds of other keys and walk orders go by
# kernels/bounce.py build_name ("bounce12_pd5", ...).
KERNELS = ("trace4", "trace2", "trace2_warp", "bounce12", "bounce12_pl",
           "bounce15", "bounce15_pmega", "bounce_packed", "tonemap", "mega",
           "bounce12_pd5", "bounce12_om9", "bounce12_unordered",
           "bounce15_pd5", "bounce15_om9", "bounce15_unordered",
           "bounce_packed_pd5", "bounce_packed_om9", "bounce12_pd5_unordered",
           "bounce12_om9_unordered", "bounce15_pd5_unordered",
           "bounce15_om9_unordered", "raygen", "shade")
ATTRS = ("regs", "local_bytes", "smem_bytes", "blocks_per_sm", "threads")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Every layout of the JAX package's knobs: (cluster size, wide width).
LAYOUTS = ((8, 8), (2, 8), (4, 8), (8, 16), (2, 16), (4, 16))

_lock = threading.Lock()
_libs: dict = {}


def layout_tag(layout) -> str:
    """"" for the default layout, else "_c<cs>", "_w<w>" or
    "_c<cs>w<w>" (the parts off their default)."""
    cs, w = layout
    tag = (f"c{cs}" if cs != 8 else "") + (f"w{w}" if w != 8 else "")
    return f"_{tag}" if tag else ""


def kernel_name(name: str, layout) -> str:
    """The name a launch of kernel ``name`` on tables of ``layout``
    books under (``launches``)."""
    return name + layout_tag(tuple(layout))


def leaf_layout(layout) -> tuple:
    """The library of a kernel that reads leaves and no wide node (the
    binary walks ``trace2`` / ``trace2_warp`` and ``mega``): the layout
    with the default width, so a 16-wide scene's binary walks run the
    same build as an 8-wide one's."""
    return (layout[0], DEFAULT_LAYOUT[1])


def leaf_kernel_name(name: str, layout) -> str:
    """``kernel_name`` of a kernel that reads no wide node, on tables of
    ``layout`` ("trace2_c2"; "trace2" at width 16)."""
    return kernel_name(name, leaf_layout(layout))


def _flags(layout) -> tuple:
    cs, w = layout
    if tuple(layout) == DEFAULT_LAYOUT:
        return NVCC_FLAGS
    return NVCC_FLAGS + (f"-DRT_CLUSTER={cs}", f"-DRT_WIDE={w}")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest(layout) -> str:
    h = hashlib.sha256(" ".join(_flags(layout)).encode())
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
    lib.rt_raygen.restype = i32
    lib.rt_raygen.argtypes = [vp] * 9 + [i32] * 11 + [vp]
    lib.rt_shade.restype = i32
    lib.rt_shade.argtypes = [vp] * 4 + [i32] * 3 + [f32, vp]
    lib.rt_mega_count.restype = i32
    lib.rt_mega_count.argtypes = ([vp] * 11 + [i32] * 7 + [f32] * 4
                                  + [i32, vp])
    for name in KERNELS:
        fn = getattr(lib, f"rt_{name}_attrs")
        fn.restype = i32
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]


def _path(layout) -> str:
    tag = layout_tag(layout).lstrip("_")
    return os.path.join(BUILD_DIR, f"libraytracer_kernels-"
                        f"{tag + '-' if tag else ''}{_digest(layout)}.so")


def library(layout=DEFAULT_LAYOUT):
    """The loaded kernel library of a table layout (cluster size, wide
    width), building it first if needed. A layout outside ``LAYOUTS``
    raises, and so does a build that fails."""
    layout = tuple(layout)
    if layout not in LAYOUTS:
        raise ValueError(f"no kernel library for layout {layout} "
                         f"(layouts: {LAYOUTS})")
    with _lock:
        lib = _libs.get(layout)
        if lib is None:
            so = _path(layout)
            if not os.path.exists(so):
                _build({layout: so})
            lib = ctypes.CDLL(so)
            _declare(lib)
            _libs[layout] = lib
        return lib


def build(layouts) -> None:
    """Build the libraries of ``layouts`` that are not built yet, every
    nvcc of every one of them started at once, then load them."""
    with _lock:
        todo = {tuple(l): _path(tuple(l)) for l in layouts}
        todo = {l: so for l, so in todo.items() if not os.path.exists(so)}
        if todo:
            _build(todo)
    for layout in layouts:
        library(layout)


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


def _build(targets: dict) -> None:
    """For each layout -> .so path of ``targets``: one nvcc per source,
    every one of every layout at once, then one link a library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    compiles, links = [], []
    for layout, so in targets.items():
        tag = f"{so[:-3]}.{os.getpid()}"
        objs = [f"{tag}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
        compiles += [[_nvcc(), *_flags(layout), "-c", "-o", o,
                      os.path.join(CSRC, s)] for o, s in zip(objs, SOURCES)]
        links.append((so, tag, objs))
    log = os.path.join(BUILD_DIR, "nvcc.log")
    _run(compiles, log)
    _run([[_nvcc(), "-shared", "-o", f"{tag}.tmp", *objs]
          for _, tag, objs in links], log)
    for so, tag, objs in links:
        os.replace(f"{tag}.tmp", so)
        for o in objs:
            os.remove(o)


def kernel_attrs(name: str, layout=DEFAULT_LAYOUT) -> dict:
    """What a launch of kernel ``name`` (one of KERNELS) of the library of
    ``layout`` gets, from ``cudaFuncGetAttributes`` and the occupancy
    calculator: registers and local memory bytes a thread, shared memory
    bytes a block, resident blocks per SM, threads a block."""
    out = (ctypes.c_int * len(ATTRS))()
    check(getattr(library(layout), f"rt_{name}_attrs")(out),
          f"rt_{name}_attrs")
    return dict(zip(ATTRS, out))


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")
