"""Files found by their name in ``BENCHMARK.json`` or a configuration:
``portbench/<folder>/<name>.py`` loaded as a module of its own. Scene
generators (``scenes/<kind>.py``, a ``make(spec, seed)``), drivers
(``drivers/<driver>.py``, a ``run(env)``) and per-layer metric readers
(``metrics/<metric>.py``, a ``read(ctx)``) are found this way, so a later
scene, driver or metric is a new file, not an edit here or in the
harness."""

from __future__ import annotations

import importlib.util
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))


def load(folder: str, name: str):
    """The module ``portbench/<folder>/<name>.py``."""
    path = os.path.join(HERE, folder, f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no {folder} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + re.sub(r"[^A-Za-z0-9_]", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
