"""The store of JAX references (``tests/jax_refs/``, ``torch_jax_refs``).

The port's tests read the JAX package's outputs from the store, keyed by
everything the child that made them read. These tests keep it honest: a
live child's output equals the stored record bit for bit, each part of
the key changes the key alone, and a record reads back as it was written
without a child.
"""

import os
import shutil

import numpy as np
import pytest

import torch_jax_refs as refs
from test_torch_chain import chain_inputs


def _assert_same(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_stored_reference_matches_a_live_child(tmp_path):
    """``test_torch_chain.py``'s reference (XLA only, ~1 s of JAX) run
    past the store equals its record."""
    inp = chain_inputs()
    jobs = [("chain", inp, None)]
    path = refs.store_path(jobs, refs.store_key("chain", jobs))
    assert os.path.exists(path), (
        "the store holds no record of the chain reference: fill it anew "
        "(delete tests/jax_refs/, run tests/test_torch_*.py)")
    with np.load(path) as f:
        stored = {k: f[k] for k in f.files}
    _assert_same(refs.run_child("chain", inp, tmp_path), stored)


def _base():
    inp = {"verts": np.arange(24, dtype=np.float32).reshape(2, 12),
           "fc": 2, "shadings": np.array(["path", "fixed_light"])}
    return inp, {"RAYTPU_SORT_KEY": "pd5"}


def _copy_sources(dst):
    """The files ``sources_digest`` reads, copied under ``dst``."""
    shutil.copytree(os.path.join(refs._REPO, "raytracer_tpu"),
                    os.path.join(dst, "raytracer_tpu"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel in ("tests/jax_ref_jobs.py", "native/Makefile",
                "native/raytpu_native.cpp"):
        os.makedirs(os.path.join(dst, os.path.dirname(rel)), exist_ok=True)
        shutil.copy2(os.path.join(refs._REPO, rel), os.path.join(dst, rel))
    return str(dst)


def _flip_first_byte(path):
    with open(path, "r+b") as f:
        head = f.read(1)
        f.seek(0)
        f.write(bytes([head[0] ^ 1]))


@pytest.mark.parametrize("change", ["input_byte", "job_knob", "child_env",
                                    "inherited_knob", "jax_setting",
                                    "jax_package", "jobs_file"])
def test_store_key_changes_with_each_part(change, tmp_path, monkeypatch):
    """One input byte, one job knob, the child's knobs, an inherited knob,
    an inherited JAX setting that changes results, one byte of the JAX
    package or one byte of the jobs the child runs: each alone gives
    another key."""
    monkeypatch.delenv("RAYTPU_WAVE_MINW", raising=False)
    monkeypatch.delenv("JAX_ENABLE_X64", raising=False)
    inp, knobs = _base()
    base = refs.store_key("multi", [("chain", inp, knobs)])
    # The key is a function of the values, not of the objects.
    again, knobs2 = _base()
    assert refs.store_key("multi", [("chain", again, knobs2)]) == base
    env = None
    if change == "input_byte":
        inp["verts"].view(np.uint8).reshape(-1)[37] ^= 1
    elif change == "job_knob":
        knobs["RAYTPU_SORT_KEY"] = "om9"
    elif change == "child_env":
        env = {"RAYTPU_WAVE_MINW": "4096"}
    elif change == "inherited_knob":
        monkeypatch.setenv("RAYTPU_WAVE_MINW", "4096")
    elif change == "jax_setting":
        monkeypatch.setenv("JAX_ENABLE_X64", "1")
    else:
        src = refs.sources_digest()
        assert refs.sources_digest(_copy_sources(tmp_path / "a")) == src
        edited = _copy_sources(tmp_path / "b")
        _flip_first_byte(os.path.join(edited, "raytracer_tpu", "kernels",
                                      "wavefront.py")
                         if change == "jax_package"
                         else os.path.join(edited, "tests", "jax_ref_jobs.py"))
        src = refs.sources_digest(edited)
        assert src != refs.sources_digest()
        monkeypatch.setattr(refs, "sources_digest", lambda: src)
    assert refs.store_key("multi", [("chain", inp, knobs)], env) != base


@pytest.mark.parametrize("name, value", [
    ("XLA_FLAGS", "--xla_force_host_platform_device_count=8"),
    ("JAX_PLATFORMS", "tpu"), ("XLA_PYTHON_CLIENT_PREALLOCATE", "false"),
    ("JAX_COMPILATION_CACHE_DIR", "/nonexistent/cache"),
    ("PYTHONPATH", "/nonexistent")])
def test_store_key_ignores_what_the_child_does_not_read(name, value,
                                                        monkeypatch):
    """A variable of the parent that the child overrides (``FIXED_ENV``,
    ``PYTHONPATH``) or whose value changes no result leaves the key as it
    was."""
    inp, knobs = _base()
    jobs = [("chain", inp, knobs)]
    monkeypatch.delenv(name, raising=False)
    base = refs.store_key("multi", jobs)
    monkeypatch.setenv(name, value)
    assert refs.store_key("multi", jobs) == base


def test_store_reads_back_what_it_wrote(tmp_path, monkeypatch):
    """A miss runs the child once, warns with the key's parts and writes
    the output; a hit returns the same arrays (dtypes, shapes, 0-d values,
    order) and starts none."""
    monkeypatch.setattr(refs, "STORE", str(tmp_path / "store"))
    out = {"image": np.arange(12, dtype=np.uint8).reshape(3, 4),
           "rays": np.float64(123.5), "hit": np.array([True, False]),
           "key": np.array([-1, 7], np.int32), "name": np.array("pd5")}
    calls = []

    def run():
        calls.append(1)
        return out

    jobs = [("chain", {"fc": 2}, None)]
    with pytest.warns(refs.StoreMiss, match=r"job=chain fc=<i8\(\):"):
        refs._stored("chain", jobs, None, run)
    got = refs._stored("chain", jobs, None, run)
    assert calls == [1]
    _assert_same(got, {k: np.asarray(v) for k, v in out.items()})
    assert os.listdir(refs.STORE) == [os.path.basename(
        refs.store_path(jobs, refs.store_key("chain", jobs)))]
