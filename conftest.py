"""Work units of the test run under ``pytest-xdist --dist loadfile``.

``loadfile`` sends every case of a file to one worker. The files in
``SPLIT_FILES`` hold long cases; grouped on one worker they set the run's
wall time, so each of their cases is a work unit of its own. Every other
file stays one unit, and every case still runs once.
"""
import pytest

# Files whose cases are scheduled one by one; seconds are the cases' own
# (junit times under -n 6 --dist loadfile on an 8-core CPU).
SPLIT_FILES = (
    # Pallas interpret renders of the JAX wavefront engines: 24 cases,
    # 1,650 s together, 16 of them 54-131 s each.
    "tests/test_wavefront.py",
)


def work_unit(nodeid: str) -> str:
    """The work unit of a case: its nodeid in a listed file, else its file."""
    path = nodeid.split("::", 1)[0]
    return nodeid if path in SPLIT_FILES else path


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SplitFileScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return work_unit(nodeid)

    return SplitFileScheduling(config, log)
