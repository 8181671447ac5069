"""Editable scene graph: ``ModelInstance`` + ``Scene`` with snapshot reads
and JSON save / load.

The port of ``raytracer_tpu/scene/scene.py`` (pure Python and NumPy, so
the same instances, transforms and JSON): a scene is a flat list of model
instances, each an .obj path, display name, position, per-axis scale, RGB
colour and material-type float. One writer edits; builds read snapshots.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Iterable, Optional

import numpy as np

from raytracer_tpu_torch.core.types import MAT_LAMBERTIAN


@dataclasses.dataclass
class ModelInstance:
    """One placed model (defaults as the JAX twin's)."""

    model_path: str
    display_name: str = ""
    position: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)
    color: tuple = (0.8, 0.8, 0.8)
    material_type: float = MAT_LAMBERTIAN

    def __post_init__(self):
        if not self.display_name:
            self.display_name = self.model_path.rsplit("/", 1)[-1]
        self.position = tuple(float(x) for x in self.position)
        self.scale = tuple(float(x) for x in self.scale)
        self.color = tuple(float(x) for x in self.color)
        self.material_type = float(self.material_type)

    def transform(self, verts: np.ndarray) -> np.ndarray:
        """Scale-then-translate, per vertex (order matters)."""
        s = np.asarray(self.scale, np.float32)
        p = np.asarray(self.position, np.float32)
        return verts * s + p

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "ModelInstance":
        return ModelInstance(**d)


class Scene:
    """Thread-safe instance list with snapshot reads (a lock and a list
    copy: one writer, snapshot readers)."""

    def __init__(self, instances: Optional[Iterable[ModelInstance]] = None):
        self._lock = threading.Lock()
        self._instances: list[ModelInstance] = list(instances or [])

    def add_instance(self, inst: ModelInstance) -> None:
        with self._lock:
            self._instances.append(inst)

    def remove_instance(self, inst: ModelInstance) -> None:
        with self._lock:
            self._instances.remove(inst)

    def remove_at(self, index: int) -> ModelInstance:
        with self._lock:
            return self._instances.pop(index)

    def clear(self) -> None:
        with self._lock:
            self._instances.clear()

    def get_instances(self) -> list[ModelInstance]:
        with self._lock:
            return list(self._instances)

    def create_snapshot(self) -> list[ModelInstance]:
        """A copy for a scene build (instances are replaced, not mutated,
        by editors)."""
        with self._lock:
            return [dataclasses.replace(i) for i in self._instances]

    def __len__(self) -> int:
        with self._lock:
            return len(self._instances)

    def save_json(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump([i.to_json() for i in self.get_instances()], f, indent=2)

    @staticmethod
    def load_json(path: str) -> "Scene":
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        return Scene(ModelInstance.from_json(d) for d in data)


def default_scene(asset_dir: str = "assets") -> Scene:
    """The reference default scene: a grey matte ground plane and a metal
    car, whose slot falls back to ``white_mesh.obj`` when ``car.obj`` is
    absent. Missing meshes are skipped (with a warning) at build time."""
    scene = Scene()
    scene.add_instance(ModelInstance(
        model_path=os.path.join(asset_dir, "ground_plane.obj"),
        display_name="Ground Plane",
        position=(0.0, -10.0, 0.0),
        scale=(150.0, 1.0, 150.0),
        color=(0.5, 0.5, 0.5),
        material_type=0.0,
    ))
    car_path = os.path.join(asset_dir, "car.obj")
    if not os.path.exists(car_path):
        car_path = os.path.join(asset_dir, "white_mesh.obj")
    scene.add_instance(ModelInstance(
        model_path=car_path,
        display_name="Car",
        position=(0.0, -8.0, 0.0),
        scale=(2.0, 2.0, 2.0),
        color=(0.6, 0.7, 0.1),
        material_type=1.0,
    ))
    return scene
