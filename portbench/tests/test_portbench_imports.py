"""Nothing the benchmark runs imports JAX, the JAX package or the root
scripts that measure it; top-level module names are compared whole."""

import ast
import os

import pbtest
from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "raytracer_tpu", "bench",
             "__graft_entry__", "chip_smoke", "kernel_times"}


def _sources():
    top = os.path.join(pbtest.ROOT, "portbench")
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    seen = set()
    for path in _sources():
        names = set(_imported(path))
        seen |= names
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
    assert "raytracer_tpu_torch" in seen      # the port is what runs


def test_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["raytracer_tpu_torch.engine.loop", "numpy", "jax_free"]) == []
    assert harness.forbidden_modules(
        ["raytracer_tpu.kernels.packet", "jaxlib.xla_client", "flax"]) == [
            "flax", "jaxlib", "raytracer_tpu"]
    assert "raytracer_tpu" not in harness.forbidden_modules()
