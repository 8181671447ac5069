"""The benchmark's arithmetic on synthetic timestamps."""

import pytest

import pbtest  # noqa: F401  (import path)
from portbench import stats


def test_union_and_idle_share():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 40)]
    assert stats.union_length(iv) == 15 + 11
    assert stats.clip(iv, 8, 25) == [(8, 10), (8, 15), (20, 25)]
    busy = stats.union_length(stats.clip(iv, 0, 50))
    assert 1.0 - busy / 50 == pytest.approx(0.48)


def test_gaps_cover_the_rest_of_the_window():
    iv = [(10, 20), (15, 25), (40, 45)]
    g = stats.gaps(iv, 0, 50)
    assert g == [(0, 10), (25, 40), (45, 50)]
    assert sum(b - a for a, b in g) + stats.union_length(iv) == 50
    assert stats.gaps([], 0, 5) == [(0, 5)]


def test_percentile_interpolates_like_numpy():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert stats.percentile(xs, 0) == 1.0
    assert stats.percentile(xs, 100) == 5.0
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_frame_ms_counts_only_frames_in_the_window():
    arrivals = [10.0, 20.0, 30.0, 40.0, 101.0]
    assert stats.frame_ms(100.0, arrivals) == 25.0
    assert stats.intervals_between([10.0, 25.0, 27.0], 0.0) == [
        10.0, 15.0, 2.0]
    with pytest.raises(ValueError):
        stats.frame_ms(5.0, arrivals)
