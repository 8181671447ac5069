"""ctypes bridge to the framework-neutral C++ runtime in ``native/``.

Shares ``native/raytpu_native.so`` with the JAX package: the library is
built with the Makefile of ``native/`` when it is missing or older than its
source, as ``raytracer_tpu/native_bridge.py`` does (``ensure_built``), but
under a lock file and into a private copy of the directory, then renamed
into place: processes that build at once (test workers, JAX reference
children) never load a half-written library. This bridge exposes only what
the port's scene build needs — the median, binned-SAH, SBVH and PLOC BVH
builds, cluster packing and the .obj parser — and raises when the library
cannot be built or loaded, or a build fails (the JAX package logs such a
failure and builds a median tree in NumPy instead; the port does not:
``RAYTPU_NATIVE=0`` selects the NumPy builds).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "raytpu_native.so")

_lock = threading.Lock()
_lib = None


def _stale() -> bool:
    src = os.path.join(_NATIVE_DIR, "raytpu_native.cpp")
    return (not os.path.exists(_SO_PATH)
            or os.path.getmtime(src) > os.path.getmtime(_SO_PATH))


def ensure_built() -> None:
    """Build the library if it is missing or older than its source: one
    process at a time (an exclusive lock on ``native/.build.lock``), with
    ``make`` in a temporary copy of ``native/``, the result renamed over
    the library."""
    if not _stale():
        return
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():
            return
        with tempfile.TemporaryDirectory(dir=_NATIVE_DIR) as tmp:
            for name in ("Makefile", "raytpu_native.cpp"):
                shutil.copy2(os.path.join(_NATIVE_DIR, name), tmp)
            subprocess.run(["make", "-C", tmp], check=True,
                           capture_output=True, timeout=300)
            os.replace(os.path.join(tmp, "raytpu_native.so"), _SO_PATH)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        ensure_built()
        lib = ctypes.CDLL(_SO_PATH)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.rt_free.argtypes = [ctypes.c_void_p]
        lib.rt_free.restype = None
        lib.rt_load_obj.restype = ctypes.c_int64
        lib.rt_load_obj.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
        lib.rt_bvh_node_count.restype = ctypes.c_int64
        lib.rt_bvh_node_count.argtypes = [ctypes.c_int64, ctypes.c_int32]
        for name in ("rt_build_bvh", "rt_build_bvh_sah"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [f32p, ctypes.c_int64, ctypes.c_int32,
                           f32p, f32p, i32p, i32p, i32p, i32p, i32p, i64p]
        lib.rt_build_bvh_sbvh.restype = ctypes.c_int64
        lib.rt_build_bvh_sbvh.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
            f32p, f32p, i32p, i32p, i32p, i32p, i32p, i64p]
        lib.rt_build_bvh_ploc.restype = ctypes.c_int64
        lib.rt_build_bvh_ploc.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            f32p, f32p, i32p, i32p, i32p, i32p, i32p, i64p]
        lib.rt_pack_clusters.restype = None
        lib.rt_pack_clusters.argtypes = [
            f32p, f32p, ctypes.c_int64, i64p, i32p, i32p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, f32p, i32p]
        _lib = lib
        return _lib


def load_obj(path: str) -> np.ndarray:
    """Native .obj parse -> f32[T, 3, 3]."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_float)()
    t = lib.rt_load_obj(path.encode(), ctypes.byref(out))
    if t < 0:
        if t == -1:
            raise FileNotFoundError(path)
        raise ValueError(f"parse error in {path}")
    try:
        if t == 0:
            return np.zeros((0, 3, 3), np.float32)
        return np.ctypeslib.as_array(out, shape=(int(t), 3, 3)).copy()
    finally:
        lib.rt_free(out)


def build_bvh_sah(tris: np.ndarray, leaf_size: int) -> dict:
    """Binned-SAH BVH, pre-order flattened -> dict of NumPy arrays
    (node_min/max f32[M,3], node_tri/ntri/skip/data/count i32[M],
    order i64[T])."""
    return _build(tris, leaf_size, "sah")


def build_bvh_median(tris: np.ndarray, leaf_size: int) -> dict:
    """Median split on the longest axis (the NumPy reference builder's
    tree, ``bvh/build.build_bvh_numpy``), in the same layout and dict."""
    return _build(tris, leaf_size, "median")


def build_bvh_sbvh(tris: np.ndarray, leaf_size: int) -> dict:
    """Spatial-split BVH (SBVH): a straddling triangle may be referenced
    by several leaves with clipped bounds, so ``order`` repeats triangle
    ids and is longer than T (up to the budget ``sbvh_refs``)."""
    return _build(tris, leaf_size, "sbvh")


# PLOC nearest-neighbour search window, as the JAX package passes it
# (``raytracer_tpu/native_bridge.py:156-160``).
PLOC_WINDOW = 8


def build_bvh_ploc(tris: np.ndarray, leaf_size: int) -> dict:
    """Capped-leaf PLOC BVH (window ``PLOC_WINDOW``), in the same
    pre-order layout and dict as ``build_bvh_sah``."""
    return _build(tris, leaf_size, "ploc")


def sbvh_refs(n: int) -> int:
    """The SBVH reference budget for n triangles: n + max(3n/4, 64), the
    JAX package's (``raytracer_tpu/native_bridge.py:126``)."""
    return n + max(n * 3 // 4, 64)


def _build(tris: np.ndarray, leaf_size: int, method: str) -> dict:
    lib = _load()
    tris = np.ascontiguousarray(tris, np.float32)
    n = tris.shape[0]
    refs = sbvh_refs(n) if method == "sbvh" else n
    if method == "median":
        m_cap = int(lib.rt_bvh_node_count(n, leaf_size))
    else:
        m_cap = 2 * refs - 1  # worst case; the build returns its count
    out = dict(node_min=np.empty((m_cap, 3), np.float32),
               node_max=np.empty((m_cap, 3), np.float32),
               node_tri=np.empty(m_cap, np.int32),
               node_ntri=np.empty(m_cap, np.int32),
               node_skip=np.empty(m_cap, np.int32),
               node_data=np.empty(m_cap, np.int32),
               node_count=np.empty(m_cap, np.int32))
    order = np.empty(refs, np.int64)
    outs = (out["node_min"].reshape(-1), out["node_max"].reshape(-1),
            out["node_tri"], out["node_ntri"], out["node_skip"],
            out["node_data"], out["node_count"], order)
    flat = tris.reshape(-1)
    if method == "median":
        m = int(lib.rt_build_bvh(flat, n, leaf_size, *outs))
    elif method == "sah":
        m = int(lib.rt_build_bvh_sah(flat, n, leaf_size, *outs))
    elif method == "sbvh":
        m = int(lib.rt_build_bvh_sbvh(flat, n, leaf_size, refs, *outs))
    else:
        m = int(lib.rt_build_bvh_ploc(flat, n, leaf_size, PLOC_WINDOW,
                                      *outs))
    if m <= 0 or (method == "median" and m != m_cap):
        raise RuntimeError(f"native {method} BVH build failed (m={m})")
    res = {k: v[:m].copy() for k, v in out.items()}
    # SBVH: the leaves' references, in leaf order (sum of leaf counts).
    n_refs = (int(res["node_ntri"][res["node_tri"] >= 0].sum())
              if method == "sbvh" else n)
    res["order"] = order[:n_refs].copy()
    return res


def pack_clusters(verts: np.ndarray, mats: np.ndarray, order: np.ndarray,
                  node_tri: np.ndarray, node_ntri: np.ndarray,
                  clusters: np.ndarray, cluster_size: int,
                  tri_stride: int) -> None:
    """Pack leaf triangles into ``clusters`` (f32[L, cluster_size *
    tri_stride], written in place) in leaf order."""
    lib = _load()
    n = verts.shape[0]
    m = node_tri.shape[0]
    if clusters.dtype != np.float32 or not clusters.flags.c_contiguous:
        raise ValueError("clusters must be C-contiguous f32")
    lib.rt_pack_clusters(
        np.ascontiguousarray(verts, np.float32).reshape(-1),
        np.ascontiguousarray(mats, np.float32).reshape(-1),
        n, np.ascontiguousarray(order, np.int64),
        np.ascontiguousarray(node_tri, np.int32),
        np.ascontiguousarray(node_ntri, np.int32), m,
        cluster_size, tri_stride, clusters.reshape(-1),
        np.empty(m, np.int32))
