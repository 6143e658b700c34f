"""What decides ``correct``: the lower-precision control and the faults a
cell can have must come out not correct, a sound run correct.  The runs go
through the harness's own window and judgement on the CPU at 12 frames
(the look for a card is skipped), with the timed path broken underneath."""

import time

import numpy as np
import pytest
from conftest import CPU_CARD, tiny_cell

import portbench.run as run
from portbench.harness import traffic

CELLS = ("oct280-single.synthetic", "oct280-single.realfix")
FULL = "oct4x280-full.synthetic"


def _measure(name):
    cell = tiny_cell(name)
    res, _ = run.measure(cell, 2**31 + 9, 0.2, False, "cpu", lambda: None, CPU_CARD,
                         lambda m: None, time.perf_counter())
    return res


@pytest.mark.parametrize("name", CELLS + (FULL,))
def test_sound_run_is_correct(name, cpu_port):
    res = _measure(name)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("name", CELLS + (FULL,))
def test_control_fails_every_number(name, cpu_port):
    """The reference one precision below the program's (bfloat16 tables,
    float32 geometry) in the program's place fails each limit."""
    cell = tiny_cell(name, frames=12 if name == FULL else 24)
    args = cell.entry.call_args(cell.config["args"])
    pool = traffic.make_pool(cell.traffic, cell.config, 2**31 + 1, cell.bench_dir / "data")
    limits = cell.config["limits"]
    for case in pool[:1 if name == FULL else 2]:
        got = cell.entry.judge(case, cell.entry.control(case, args, "cpu"), args, "cpu")
        assert all(got[k] > limits[k] for k in limits), got


def _chain_fault(monkeypatch, alter):
    """Wrap the port's chain search so that ``alter`` edits the packed
    answer ``[angles | tie codes | centres]`` where it is produced."""
    from multimodars_torch.pipelines import align_within

    inner = align_within.chain_rotation_search

    def broken(*a, **k):
        flat = inner(*a, **k).clone()
        n = flat.shape[0] // 3
        flat[n:2 * n] = 0.0  # no repair re-decides the altered pairs
        alter(flat[:n])
        return flat

    monkeypatch.setattr(align_within, "chain_rotation_search", broken)


@pytest.mark.parametrize("name", CELLS)
def test_half_the_pairs_left_out_is_not_correct(name, cpu_port, monkeypatch):
    def drop_half(angles):
        angles[angles.shape[0] // 2:] = 0.0

    _chain_fault(monkeypatch, drop_half)
    assert not _measure(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_produced_is_not_correct(name, cpu_port, monkeypatch):
    def one_step(angles):
        angles[angles.shape[0] // 2] += np.radians(0.01)

    _chain_fault(monkeypatch, one_step)
    assert not _measure(name)["correct"]


@pytest.mark.parametrize("name", CELLS + (FULL,))
def test_a_finish_that_returns_its_state_unchanged_is_not_correct(name, cpu_port,
                                                                   monkeypatch):
    from multimodars_torch.models.tensor import TensorGeometry

    monkeypatch.setattr(TensorGeometry, "finish_transform", lambda self, *a, **k: None)
    assert not _measure(name)["correct"]


def test_a_failed_case_is_counted_and_not_correct(cpu_port, monkeypatch):
    import multimodars_torch as mt

    def fails(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(mt, "from_array_single", fails)
    cell = tiny_cell("oct280-single.synthetic")
    cell.config["warmup_cases"] = 0
    res, _ = run.measure(cell, 3, 0.1, False, "cpu", lambda: None, CPU_CARD,
                         lambda m: None, time.perf_counter())
    assert not res["correct"] and res["failed"] == res["attempted"] >= 1


def _within_batch_fault(monkeypatch, alter):
    """Wrap the full path's batched within search (every pullback's pairs
    in one batch) so that ``alter`` edits its angles."""
    from multimodars_torch.pipelines import align_within

    inner = align_within.sharded_search

    def broken(*a, **k):
        delta, ties = inner(*a, **k)
        delta = delta.copy()
        alter(delta)
        return delta, ties & False

    monkeypatch.setattr(align_within, "sharded_search", broken)


def test_full_half_the_batch_left_out_is_not_correct(cpu_port, monkeypatch):
    def drop_half(delta):
        delta[delta.shape[0] // 2:] = 0.0

    _within_batch_fault(monkeypatch, drop_half)
    assert not _measure(FULL)["correct"]


def test_full_between_answer_altered_is_not_correct(cpu_port, monkeypatch):
    """The first between slot's rotation one grid step off where the
    search produces it."""
    from multimodars_torch.pipelines import align_between

    inner = align_between.dispatch_between_search

    def broken(clouds, step_deg, range_deg, bruteforce=False):
        flat = inner(clouds, step_deg, range_deg, bruteforce).copy()
        n = flat.shape[0] // 2
        flat[0] += np.radians(step_deg)
        flat[n:] = 0.0
        return flat

    monkeypatch.setattr(align_between, "dispatch_between_search", broken)
    assert not _measure(FULL)["correct"]
