"""Rate and tail over every case of the window."""

import numpy as np
import pytest

from portbench.harness import stats


def test_rate_counts_every_case_over_the_window():
    assert stats.rate(150, 10.0) == 15.0


@pytest.mark.parametrize("n", [1, 2, 19, 20, 100, 357])
def test_p95_is_numpy_linear_over_all_values(n):
    values = np.random.default_rng(n).exponential(0.08, n).tolist()
    assert stats.p95(values) == pytest.approx(float(np.percentile(values, 95)), rel=1e-12)


def test_p95_sees_the_tail_of_all_cases():
    # one slow case in twenty moves the p95: no median of chunks hides it
    values = [0.07] * 19 + [0.5]
    assert stats.p95(values) > 0.07

