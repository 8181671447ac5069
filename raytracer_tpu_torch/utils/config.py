"""``RenderConfig`` from defaults, a ``.env`` file, the environment and
explicit overrides, in that order of precedence (lowest first), as the
JAX package's ``utils/config.py`` resolves it.

.env format: KEY=VALUE lines, '#' comments. Keys are the upper-cased
field names with a RAYTPU_ prefix, e.g. ``RAYTPU_WIDTH=1920``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from raytracer_tpu_torch.core.types import RenderConfig

ENV_PREFIX = "RAYTPU_"


def parse_env_file(path: str) -> dict:
    values = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            values[k.strip()] = v.strip().strip("\"'")
    return values


def _coerce(value: str, typ):
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


def load_config(env_file: Optional[str] = None, **overrides) -> RenderConfig:
    """RenderConfig from defaults < .env file < environment < overrides.
    With no ``env_file``, ``.env`` in the working directory is read when
    it exists."""
    if env_file is None and os.path.exists(".env"):
        env_file = ".env"
    file_values = parse_env_file(env_file) if env_file else {}

    kwargs = {}
    for field in dataclasses.fields(RenderConfig):
        key = ENV_PREFIX + field.name.upper()
        raw = os.environ.get(key, file_values.get(key))
        if raw is not None:
            kwargs[field.name] = _coerce(raw, type(field.default))
    kwargs.update(overrides)
    return RenderConfig(**kwargs)
