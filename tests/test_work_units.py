"""The work-unit rule of the root ``conftest.py`` (xdist scheduling)."""
import importlib.util
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


# Loaded by path: ``tests/conftest.py`` shares the module name.
_spec = importlib.util.spec_from_file_location("_root_conftest",
                                               ROOT / "conftest.py")
rule = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rule)


class _Config:
    """What the scheduler reads of pytest's config."""

    def __init__(self, dist):
        self.option = SimpleNamespace(dist=dist, tx=["2*popen"],
                                      loadscopereorder=True)

    def getvalue(self, name):
        return getattr(self.option, name)


class _Node:
    """A worker that takes what it is sent and runs nothing."""

    shutting_down = False
    gateway = SimpleNamespace(id="gw")

    def send_runtest_some(self, indices):
        pass

    def shutdown(self):
        self.shutting_down = True


@pytest.mark.parametrize("path", rule.SPLIT_FILES)
def test_listed_file_collects_cases(path):
    assert (ROOT / path).is_file()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", path, "--collect-only", "-q",
         "-p", "no:xdist", "-p", "no:cacheprovider"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    cases = [line for line in out.stdout.splitlines()
             if line.startswith(path + "::")]
    assert out.returncode == 0, out.stdout + out.stderr
    assert cases


@pytest.mark.parametrize("case", [
    "::test_wavefront_matches_megakernel",
    "::test_fused12_matches_fused[pd5]",
    "::test_deposit_modes_match_default[a::b]",
])
def test_listed_file_case_is_its_own_unit(case):
    nodeid = rule.SPLIT_FILES[0] + case
    assert rule.work_unit(nodeid) == nodeid


@pytest.mark.parametrize("nodeid, path", [
    ("tests/test_packet.py::test_pallas_b0_matches_megakernel",
     "tests/test_packet.py"),
    ("tests/test_torch_paths.py::test_path_matches_jax[mega]",
     "tests/test_torch_paths.py"),
    ("tests/test_wavefront_other.py::test_x", "tests/test_wavefront_other.py"),
    ("other/tests/test_wavefront.py::test_x", "other/tests/test_wavefront.py"),
    ("tests/test_core.py::TestCamera::test_rays[0]", "tests/test_core.py"),
])
def test_other_file_case_is_its_file(nodeid, path):
    assert rule.work_unit(nodeid) == path


@pytest.mark.parametrize("dist", ["load", "no", "loadscope", "worksteal"])
def test_hook_leaves_other_modes_alone(dist):
    assert rule.pytest_xdist_make_scheduler(_Config(dist), None) is None


def test_loadfile_splits_only_the_listed_files():
    listed = rule.SPLIT_FILES[0]
    collection = [
        "tests/test_a.py::test_1", "tests/test_a.py::test_2",
        listed + "::test_1", listed + "::test_2[x]", listed + "::test_2[y]",
        "tests/test_b.py::test_1",
    ]
    sched = rule.pytest_xdist_make_scheduler(_Config("loadfile"), None)
    nodes = [_Node(), _Node()]
    for node in nodes:
        sched.add_node(node)
        sched.add_node_collection(node, collection)
    sched.schedule()

    units = list(sched.workqueue)
    for node in nodes:
        units += list(sched.assigned_work[node])
    assert sorted(units) == sorted([
        "tests/test_a.py", "tests/test_b.py", listed + "::test_1",
        listed + "::test_2[x]", listed + "::test_2[y]"])
