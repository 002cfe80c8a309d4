"""The end-to-end metrics' arithmetic on hand-made token times."""

import statistics

import pytest

from portbench.harness import stats


def test_rate_is_every_token_over_the_whole_window():
    times = {0: [1.0, 1.5, 2.0, 9.5], 1: [0.5, 3.0], 2: [10.5]}
    # window [1, 10]: tokens at 1.0, 1.5, 2.0, 9.5, 3.0 -> 5 over 9 s
    assert stats.tokens_per_s(times, 1.0, 10.0) == pytest.approx(5 / 9)


def test_tail_is_over_every_gap_inside_the_window():
    times = {0: [0.0, 1.0, 1.1, 1.2], 1: [0.9, 1.4, 3.4]}
    gaps = stats.token_gaps(times, 0.5, 3.5)
    assert sorted(gaps) == pytest.approx(sorted([0.1, 0.1, 0.5, 2.0]))
    assert stats.percentile(gaps, 95) == pytest.approx(0.5 + 0.85 * 1.5)
    assert stats.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_percentile_matches_linear_interpolation():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0, 10.0]
    assert stats.percentile(xs, 50) == pytest.approx(statistics.median(xs))
    assert stats.percentile(xs, 100) == 10.0 and stats.percentile(xs, 0) == 1.0


def test_ttft_of_an_unserved_request_is_its_wait_so_far():
    due = {0: 1.0, 1: 2.0, 2: 8.0, 3: 20.0}
    first = {0: 1.25, 1: 9.0}  # 1 served after the close, 2 never
    got = stats.ttfts(due, first, 0.0, 10.0)
    assert sorted(got) == pytest.approx(sorted([0.25, 7.0, 2.0]))
