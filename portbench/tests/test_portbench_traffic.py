"""The traffic generators: pools are a function of the seed alone, their
cases distinct, every case of a mix the same size; a mix's kind names its
generator file."""

import numpy as np
import pytest
from conftest import tiny_cell

from portbench.harness import traffic

CELLS = ("oct280-single.synthetic", "oct280-single.realfix")
SEEDS = (0, 7, 2**31 + 5, 2**33 + 1, -3)


def _pool(name, seed):
    cell = tiny_cell(name)
    return traffic.make_pool(cell.traffic, cell.config, seed, cell.bench_dir / "data")


def _lumens(pool):
    return [p[1] for case in pool for p in case]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_pool_repeats_for_a_seed(name, seed):
    a, b = _pool(name, seed), _pool(name, seed)
    for x, y in zip(_lumens(a), _lumens(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", CELLS)
def test_cases_distinct_within_and_across_seeds(name):
    lumens = [lum for seed in SEEDS for lum in _lumens(_pool(name, seed))]
    keys = {lum.tobytes() for lum in lumens}
    assert len(keys) == len(lumens)


@pytest.mark.parametrize("name", CELLS)
def test_every_case_has_the_same_size(name):
    shapes = {(lum.shape, len(np.unique(lum[:, 0]))) for seed in SEEDS
              for lum in _lumens(_pool(name, seed))}
    assert len(shapes) == 1


def test_fixture_twist_within_its_range():
    cell = tiny_cell("oct280-single.realfix")
    lo, hi = cell.traffic["twist_rad"]
    draws = [traffic.rng_for(s, c).uniform(lo, hi) for s in SEEDS for c in range(3)]
    assert all(lo <= d < hi for d in draws) and len(set(draws)) == len(draws)


def test_fixture_reference_frame_by_phase_count():
    cell = tiny_cell("oct280-single.realfix")
    raw = np.loadtxt(cell.bench_dir / "data" / cell.traffic["files"][0], delimiter="\t")
    fixture = traffic.generator(cell.traffic["kind"])
    assert fixture.ref_frame(cell.traffic, 1, 280, raw) == 0
    # the last of 93 whole copies of 3 source frames
    assert fixture.ref_frame(cell.traffic, 4, 280, raw) == 278


def test_an_unknown_kind_has_no_generator():
    cell = tiny_cell("oct280-single.synthetic")
    with pytest.raises(FileNotFoundError):
        traffic.make_pool(dict(cell.traffic, kind="no_such_kind"), cell.config, 1,
                          cell.bench_dir / "data")
