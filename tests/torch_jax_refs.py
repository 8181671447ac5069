"""JAX reference values for the port's tests (``tests/test_torch_*.py``).

The JAX package computes them in a child process that runs
``tests/jax_ref_jobs.py`` (the jobs; ``run_jobs`` runs several in one
child, each under its own knobs, so a test module starts at most one JAX
process).

Why a child process: XLA:CPU contracts ``a * b + c`` into fused
multiply-adds on a CPU that has them, so the JAX side would round
differently from the port, whose plain versions and CUDA kernels never
contract. ``--xla_cpu_max_isa=AVX`` keeps FMA instructions out of XLA's
code, and that flag only applies when the JAX backend starts — before
any other test in the worker has started it. ``run_child`` sets it.

The store: a child's output is a pure function of what it reads (its
jobs' names, inputs and knobs, the environment variables that reach the
JAX package, ``jax_ref_jobs.py``, the JAX package's sources and the
installed JAX), so ``run_job`` / ``run_jobs`` / ``run_children`` first
look for it in ``tests/jax_refs/<first job>-<key>.npz`` (``key``:
``store_key``) and start a child only when it is not there, writing what
the child returns for the next run and warning (``StoreMiss``) with the
key's parts. The store is a cache of the child's output and is
committed; to fill it anew, delete ``tests/jax_refs/`` and run
``python -m pytest tests/test_torch_*.py -n 6 --dist loadfile``. An edit
of ``jax_ref_jobs.py`` or of the JAX package changes every key; an edit
of this file changes none.
"""

from __future__ import annotations

import functools
import glob
import hashlib
import importlib.metadata
import json
import os
import subprocess
import sys
import warnings

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE = os.path.join(_REPO, "tests", "jax_refs")
JOBS_FILE = os.path.join(_REPO, "tests", "jax_ref_jobs.py")

# What every child runs under, over the parent's environment: JAX on the
# CPU without FMA contraction and the production path knobs.
FIXED_ENV = {"JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_cpu_max_isa=AVX "
                          "--xla_backend_optimization_level=0",
             "RAYTPU_B0": "pallas", "RAYTPU_BOUNCE": "wave",
             "RAYTPU_TAIL_MERGE": "1"}

# JAX settings a child inherits from the parent that change its results
# (the others, such as memory or cache settings, change none).
JAX_RESULT_VARS = ("JAX_ENABLE_X64", "JAX_DEFAULT_MATMUL_PRECISION",
                   "JAX_DISABLE_JIT", "JAX_DEFAULT_DTYPE_BITS",
                   "JAX_NUMPY_DTYPE_PROMOTION", "JAX_DEFAULT_PRNG_IMPL",
                   "JAX_THREEFRY_PARTITIONABLE")


class StoreMiss(UserWarning):
    """A JAX reference was not in the store, so a child computed it."""


@functools.lru_cache(maxsize=None)
def sources_digest(repo: str = _REPO) -> str:
    """sha256 of the code a child runs: ``tests/jax_ref_jobs.py``, the
    JAX package's sources, the native library's sources (the JAX package
    builds and loads it) and the installed jax, jaxlib and numpy."""
    h = hashlib.sha256()
    files = [os.path.join(repo, "tests", "jax_ref_jobs.py"),
             *sorted(glob.glob(os.path.join(repo, "raytracer_tpu", "**",
                                            "*.py"), recursive=True)),
             os.path.join(repo, "native", "Makefile"),
             os.path.join(repo, "native", "raytpu_native.cpp")]
    for path in files:
        with open(path, "rb") as f:
            _put(h, os.path.relpath(path, repo), f.read())
    for dist in ("jax", "jaxlib", "numpy"):
        _put(h, dist, importlib.metadata.version(dist))
    return h.hexdigest()


def _put(h, *parts) -> None:
    for p in parts:
        b = p if isinstance(p, bytes) else str(p).encode()
        h.update(len(b).to_bytes(8, "little"))
        h.update(b)


def _child_env(env: dict | None) -> dict:
    """The child's environment: the parent's, ``FIXED_ENV`` over it, and
    ``env`` over that."""
    out = dict(os.environ)
    out.update(FIXED_ENV)
    out["PYTHONPATH"] = _REPO + os.pathsep + out.get("PYTHONPATH", "")
    out.update(env or {})
    return out


def read_env(env: dict | None = None) -> dict:
    """The variables of the child's environment that reach its results:
    ``FIXED_ENV``'s (or what ``env`` sets over them), every ``RAYTPU_*``
    (the knobs, inherited or set) and ``JAX_RESULT_VARS``."""
    return {k: v for k, v in sorted(_child_env(env).items())
            if k in FIXED_ENV or k in JAX_RESULT_VARS
            or k.startswith("RAYTPU_")}


def _key_parts(child: str, jobs, env: dict | None):
    """What ``store_key`` hashes, in order: the child's job, each of
    ``jobs`` (its name, every input's name, dtype, shape and bytes, its
    knobs), ``read_env(env)`` and ``sources_digest()``."""
    parts = [("child", child)]
    for job, inputs, job_env in jobs:
        parts.append(("job", job))
        for name, v in inputs.items():
            a = np.asarray(v)
            parts.append((name, (a.dtype.str, repr(a.shape), a.tobytes())))
        parts.append(("knobs", json.dumps(sorted((job_env or {}).items()))))
    parts.append(("env", json.dumps(sorted(read_env(env).items()))))
    parts.append(("sources", sources_digest()))
    return parts


def store_key(child: str, jobs, env: dict | None = None) -> str:
    """sha256 over ``_key_parts``: everything the child reads (``child``:
    a job's name, or "multi" for ``run_jobs``)."""
    return _digest(_key_parts(child, jobs, env))


def _digest(parts) -> str:
    h = hashlib.sha256()
    for label, value in parts:
        _put(h, label, *(value if isinstance(value, tuple) else (value,)))
    return h.hexdigest()


def _describe(parts) -> str:
    """The key's parts in a line a person can read (an input as its
    dtype, shape and the start of its bytes' sha256)."""
    out = []
    for label, value in parts:
        if isinstance(value, tuple):
            dtype, shape, raw = value
            value = f"{dtype}{shape}:{hashlib.sha256(raw).hexdigest()[:12]}"
        elif label == "sources":
            value = value[:16]
        out.append(f"{label}={value}")
    return " ".join(out)


def store_path(jobs, key: str) -> str:
    return os.path.join(STORE, f"{jobs[0][0]}-{key[:16]}.npz")


def _stored(child: str, jobs, env: dict | None, run) -> dict:
    """The child's output for ``jobs`` from the store, or ``run()``'s,
    written there through a temporary name (test workers racing on one
    key write the same bytes). A miss is reported on stderr and as a
    ``StoreMiss`` warning, with the key's parts."""
    parts = _key_parts(child, jobs, env)
    path = store_path(jobs, _digest(parts))
    if os.path.exists(path):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    msg = (f"no JAX reference {os.path.relpath(path, _REPO)} in the store;"
           f" a child computes it. Key: {_describe(parts)}")
    print(msg, file=sys.stderr)
    warnings.warn(msg, StoreMiss, stacklevel=3)
    out = run()
    os.makedirs(STORE, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **out)
    os.replace(tmp, path)
    return out


def run_job(job: str, inputs: dict, tmp_path, env: dict | None = None
            ) -> dict:
    """``job``'s results (a dict of numpy arrays): from the store, or from
    a child process (``run_child``). ``env``: path knobs (``RAYTPU_*``)
    for the child, over the production ones."""
    return _stored(job, [(job, inputs, None)], env,
                   lambda: run_child(job, inputs, tmp_path, env))


def run_child(job: str, inputs: dict, tmp_path, env: dict | None = None
              ) -> dict:
    """Run ``job`` in a child process, past the store -> dict of numpy
    results. The native library is built first
    (``native_bridge.ensure_built``: one process at a time), so the child
    finds it up to date and does not run ``make`` itself while another
    process builds or loads it."""
    from raytracer_tpu_torch import native_bridge

    native_bridge.ensure_built()
    src = os.path.join(str(tmp_path), f"{job}_in.npz")
    dst = os.path.join(str(tmp_path), f"{job}_out.npz")
    np.savez(src, **inputs)
    proc = subprocess.run([sys.executable, JOBS_FILE, job, src, dst],
                          env=_child_env(env), capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"JAX reference job {job} failed:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    with np.load(dst) as f:
        return {k: f[k] for k in f.files}


def run_jobs(jobs, tmp_path, env: dict | None = None) -> list:
    """Run several (job, inputs, env) in ONE child process (or read their
    results from the store) -> their results, in order. Each job runs
    with its ``env`` knobs set over the production ones and then restored
    (the JAX package reads the path knobs when it traces, and its jit
    cache keys on them). ``env``: knobs for the whole child, such as
    those the JAX package reads at import."""

    def run():
        specs = []
        for j, (job, inputs, job_env) in enumerate(jobs):
            src = os.path.join(str(tmp_path), f"multi{j}_{job}_in.npz")
            np.savez(src, **inputs)
            specs.append({"job": job, "src": src, "env": dict(job_env or {})})
        manifest = os.path.join(str(tmp_path), "multi_jobs.json")
        with open(manifest, "w") as f:
            json.dump(specs, f)
        return run_child("multi", {"manifest": np.array(manifest)},
                         tmp_path, env=env)

    out = _stored("multi", jobs, env, run)
    return [{k[len(f"j{j}_"):]: v for k, v in out.items()
             if k.startswith(f"j{j}_")} for j in range(len(jobs))]


def run_children(groups, tmp_path) -> list:
    """``run_jobs`` for each (jobs, env) of ``groups``, each in a child of
    its own, the children at once (threads) -> their results, in order.
    For knobs the JAX package reads at import, which differ per child, and
    to split a module's Pallas interpret lowerings (~20 s each)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(groups)) as pool:
        futs = []
        for g, (jobs, env) in enumerate(groups):
            sub = os.path.join(str(tmp_path), f"child{g}")
            os.makedirs(sub, exist_ok=True)
            futs.append(pool.submit(run_jobs, jobs, sub, env))
        return [f.result() for f in futs]


def tie_lanes(scene, ray_o, ray_d, active, cfg):
    """bool[P]: active rays whose closest hit is an equal-t tie, i.e. at
    least two triangles of the scene hit at exactly the closest t (found
    by brute force with the port's Moller-Trumbore arithmetic). Only there
    may a per-ray walk and the TPU's per-tile walk pick different
    winners."""
    import torch

    from raytracer_tpu_torch.kernels.trace import _mt_candidates

    p = active.shape[0]
    o = [c.reshape(-1) for c in ray_o]
    d = [c.reshape(-1) for c in ray_d]
    closest = torch.full((p,), cfg.t_max)
    full = torch.ones(p, dtype=torch.bool)
    cands = [_mt_candidates(row.view(1, 8, 16).expand(p, 8, 16), o, d,
                            closest, full, cfg.t_min, cfg.det_eps)
             for row in scene.clusters]
    t = torch.cat(cands, dim=1)
    best = t.min(dim=1).values
    n_at_best = (t == best[:, None]).sum(1)
    return active & (best < cfg.t_max) & (n_at_best >= 2)


def assert_scene_tables(got, want: dict, prefix: str = "") -> None:
    """A port FastScene against JAX FastScene leaves (``_leaves``): 0
    differing bytes in ``nodes8``, ``nodes4`` and every cluster column
    but the unit normal's, which may differ by 2 ulp (XLA:CPU's rsqrt);
    equal counts. Where the JAX scene has no wide table (no ``nodes4``
    leaf), the port's has none either."""
    if prefix + "nodes4" not in want:
        assert got.nodes4 is None and got.num_nodes4 is None
    for name in ("nodes8", "nodes4"):
        if prefix + name not in want:
            continue
        a = getattr(got, name).cpu().numpy()
        b = want[prefix + name]
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=name)
    a = got.clusters.cpu().numpy().reshape(-1, 16)
    b = want[prefix + "clusters"].reshape(-1, 16)
    assert a.shape == b.shape, ("clusters", a.shape, b.shape)
    np.testing.assert_array_equal(a[:, :13].view(np.int32),
                                  b[:, :13].view(np.int32))
    ulp = np.abs(a[:, 13:].view(np.int32).astype(np.int64)
                 - b[:, 13:].view(np.int32).astype(np.int64))
    assert ulp.max(initial=0) <= 2, ulp.max()
    for name in ("num_nodes", "num_triangles", "num_nodes4"):
        if prefix + name in want:
            assert getattr(got, name) == int(want[prefix + name]), name
