"""Live-edit scene builds on the device: meshes cached on the card, one
device program per edit.

The port of ``raytracer_tpu/scene/device_builder.py``. Each mesh goes to
the device once; an edit ships only the instances' params (scale,
position, colour, material: f32[K, 10], one non-blocking copy) and runs
one of three strategies (``RAYTPU_DEVICE_BUILD``, read per build):

* ``instanced`` (default): per-mesh host SAH trees built once and cached
  on the device, grafted under a TLAS per edit (``scene/instanced.py``);
* ``refit``: one captured host tree per instance set, refit per edit
  (``scene/refit.py``); also the instanced mode's fallback past
  ``MAX_INSTANCES``, with a periodic recapture;
* ``lbvh``: the full rebuild, for edits that change geometry, and the
  last fallback: the Morton / Karras tree (``bvh/lbvh.py``) or, with
  ``RAYTPU_DEVICE_TREE=ploc``, the agglomerative PLOC tree
  (``bvh/ploc_device.py``); ``last_mode`` is ``"lbvh"`` for either.

As in the JAX package, a strategy that fails falls back to the next one
(instanced -> refit -> lbvh), except that a refused knob
(``NotImplementedError``) and a CUDA error pass through, and
``last_mode`` records which strategy built the last scene. An empty
scene goes through the host builder.

Each strategy builds in the layout of ``knobs.layout()`` and takes the
same turns as the JAX package under it: at ``RAYTPU_CLUSTER=2|4`` all
three run; at ``RAYTPU_WIDE=16`` the refit capture refuses (it emits
8-wide tables only), so ``refit`` falls back to ``lbvh``, whose scenes
have no wide table and walk the binary one; the device PLOC tree refuses
any layout but the default.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from raytracer_tpu_torch import knobs
from raytracer_tpu_torch.bvh.lbvh import build_fast_scene_device
from raytracer_tpu_torch.bvh.ploc_device import build_fast_scene_device_ploc
from raytracer_tpu_torch.core.fast_types import ROW_TRIS, FastScene
from raytracer_tpu_torch.core.types import to_device
from raytracer_tpu_torch.scene.builder import bucket, build_fast_scene
from raytracer_tpu_torch.scene.instanced import (MAX_INSTANCES,
                                                 combine_instanced,
                                                 pack_params,
                                                 prep_mesh_blas)
from raytracer_tpu_torch.scene.objloader import load_obj
from raytracer_tpu_torch.scene.refit import capture_refit
from raytracer_tpu_torch.scene.scene import ModelInstance
from raytracer_tpu_torch.utils.log import get_logger

_log = get_logger("srt")


def _passes_through(e: Exception) -> bool:
    """A refused knob or an error of the card: never a reason to try
    another strategy."""
    accel = getattr(torch, "AcceleratorError", ())
    return (isinstance(e, (NotImplementedError, torch.cuda.OutOfMemoryError))
            or (accel and isinstance(e, accel))
            or (isinstance(e, RuntimeError) and "CUDA" in str(e)))


def _assemble(meshes, params: torch.Tensor, capacity: int):
    """Instance transforms, concat and zero padding to ``capacity`` on
    the device: meshes f32[Ti, 3, 3], params f32[K, 10] -> (verts
    f32[capacity, 3, 3], mats f32[capacity, 4])."""
    parts_v, parts_m = [], []
    for j, mesh in enumerate(meshes):
        p = params[j]
        parts_v.append(mesh * p[0:3] + p[3:6])  # scale, then translate
        parts_m.append(p[6:10].expand(mesh.shape[0], 4))
    dev = params.device
    pad = capacity - sum(m.shape[0] for m in meshes)
    parts_v.append(torch.zeros((pad, 3, 3), device=dev))
    parts_m.append(torch.zeros((pad, 4), device=dev))
    return torch.cat(parts_v), torch.cat(parts_m)


def _assemble_and_build(meshes, params: torch.Tensor, capacity: int,
                        tree: str = "karras") -> FastScene:
    """Transform on the device, then the LBVH build of ``tree``
    ("karras" or "ploc"); the padding triangles never hit, and the scene
    keeps the true count."""
    build = (build_fast_scene_device_ploc if tree == "ploc"
             else build_fast_scene_device)
    scene = build(*_assemble(meshes, params, capacity))
    scene.num_triangles = sum(m.shape[0] for m in meshes)
    return scene


class DeviceSceneBuilder:
    """Mesh, BLAS, param and refit caches + the per-edit build entry."""

    def __init__(self, device="cuda"):
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError("DeviceSceneBuilder(device='cuda') needs a "
                               "CUDA device; pass device='cpu'")
        self.device = device
        self.last_mode = None
        self._mesh_cache: dict = {}
        self._blas_cache: dict = {}
        self._param_cache: dict = {}
        self._refit_cache: dict = {}

    def _meshes(self, path: str):
        """(host f32[T, 3, 3], the same on the device), loaded once."""
        pair = self._mesh_cache.get(path)
        if pair is None:
            host = load_obj(path)
            pair = (host, to_device(host, self.device))
            self._mesh_cache[path] = pair
        return pair

    def _mesh(self, path: str) -> torch.Tensor:
        return self._meshes(path)[1]

    def _blas(self, path: str):
        blas = self._blas_cache.get(path)
        if blas is None:
            t0 = time.perf_counter()
            blas = prep_mesh_blas(self._meshes(path)[0], self.device)
            _log.info("BLAS built for %s: %d tris in %.1f ms", path,
                      blas.num_triangles, (time.perf_counter() - t0) * 1e3)
            self._blas_cache[path] = blas
        return blas

    @staticmethod
    def _host_params(live: Sequence[ModelInstance]):
        return [(inst.scale, inst.position, inst.color, inst.material_type)
                for inst in live]

    def _params(self, live: Sequence[ModelInstance]) -> torch.Tensor:
        """The instances' params f32[K, 10] on the device, cached by value
        (an unchanged instance set costs no copy)."""
        host = pack_params(self._host_params(live))
        key = host.tobytes()
        dev = self._param_cache.get(key)
        if dev is None:
            dev = to_device(host, self.device)
            if len(self._param_cache) > 4096:
                self._param_cache.clear()
            self._param_cache[key] = dev
        return dev

    def build(self, instances: Sequence[ModelInstance]) -> FastScene:
        """Snapshot -> FastScene, geometry staying on the device."""
        mode = knobs.device_build()
        live = [inst for inst in instances
                if self._try_mesh(inst) is not None]
        if not live:
            self.last_mode = "host_empty"
            return build_fast_scene([], device=self.device)
        params = self._params(live)

        if mode == "instanced" and len(live) <= MAX_INSTANCES:
            try:
                scene = combine_instanced(
                    [self._blas(inst.model_path) for inst in live], params)
                self.last_mode = "instanced"
                return scene
            except Exception as e:
                if _passes_through(e):
                    raise
                _log.exception("instanced build failed; trying refit")

        if mode in ("refit", "instanced"):
            # Captured topology + per-edit refit: also the past-
            # MAX_INSTANCES fallback of the instanced mode, which
            # recaptures periodically so sustained motion cannot degrade
            # the tree without bound (refit mode keeps the user's knob).
            try:
                built = self._refit_build(
                    live, params,
                    default_refresh=0 if mode == "refit" else 256)
                if built is not None:
                    self.last_mode = "refit"
                    return built
            except Exception as e:
                if _passes_through(e):
                    raise
                _log.exception("refit build failed; using LBVH")

        meshes = [self._mesh(inst.model_path) for inst in live]
        total = sum(m.shape[0] for m in meshes)
        capacity = bucket(-(-total // ROW_TRIS) * ROW_TRIS)
        scene = _assemble_and_build(meshes, params, capacity,
                                    knobs.device_tree())
        self.last_mode = "lbvh"
        return scene

    def _refit_build(self, live: Sequence[ModelInstance],
                     params: torch.Tensor, default_refresh: int = 0):
        """Captured-topology refit. None when a capture is needed but
        impossible (a scene under 2 leaves): the caller builds an LBVH."""
        key = tuple(inst.model_path for inst in live)
        cap = self._refit_cache.get(key)
        # Rigid drags keep the captured tree valid; recapturing every N
        # edits re-anchors its quality to the current pose.
        refresh = knobs.count("RAYTPU_REFIT_REFRESH", default_refresh)
        if cap is not None and refresh and cap.edits >= refresh:
            _log.info("refit topology refresh after %d edits (%s)",
                      cap.edits, key)
            cap = None
        if cap is None:
            meshes = [self._meshes(inst.model_path)[0] for inst in live]
            try:
                cap = capture_refit(meshes, self._host_params(live),
                                    device=self.device)
            except ValueError as e:
                _log.info("refit capture unavailable: %s", e)
                return None
            # Each capture holds whole-scene tables on the device: keep
            # the most recent few instance sets.
            if len(self._refit_cache) >= 4 and key not in self._refit_cache:
                self._refit_cache.pop(next(iter(self._refit_cache)))
            self._refit_cache[key] = cap
        return cap.refit(params)

    def _try_mesh(self, inst: ModelInstance):
        try:
            mesh = self._mesh(inst.model_path)
        except NotImplementedError:
            raise
        except Exception as e:  # skip-and-continue, as the host builder
            _log.warning("failed to load %s: %s", inst.model_path, e)
            return None
        return mesh if mesh.shape[0] else None
