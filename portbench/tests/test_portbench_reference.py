"""The plain reference against the port's float64 path on the CPU at 12
frames: the same grid angle in every pair, the same centroids and
translations, the same final coordinates."""

import numpy as np
import pytest
import torch
from conftest import tiny_cell

from portbench.harness import traffic
from portbench.reference import oct_single

CELLS = ("oct280-single.synthetic", "oct280-single.realfix")


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_port_f64(name, cpu_port):
    mt = cpu_port
    cell = tiny_cell(name)
    args = cell.entry.call_args(cell.config["args"])
    pool = traffic.make_pool(cell.traffic, cell.config, 11, cell.bench_dir / "data")
    mt.config.set_device("cpu")
    mt.config.set_compute_dtype(torch.float64)
    for case in pool[:2]:
        out = cell.entry.run_case(mt, case, args, lambda: None)
        ans = cell.entry.answer(out)
        (_, lumen, ref, _), = case
        want = oct_single.register(lumen, ref, args, "cpu")
        step = args["step_rotation_deg"]
        np.testing.assert_array_equal(np.rint(ans["logs"][:, 2] / step),
                                      np.rint(want["logs"][:, 2] / step))
        np.testing.assert_allclose(ans["logs"][:, [0, 1, 3, 4, 5, 6]],
                                   want["logs"][:, [0, 1, 3, 4, 5, 6]], rtol=0, atol=1e-12)
        assert set(ans["coords"]) == set(want["coords"]) == {"Lumen", "Catheter", "Wall"}
        for k in want["coords"]:
            assert oct_single.set_distance(ans["coords"][k], want["coords"][k], "cpu") < 1e-9
        got = oct_single.judge(lumen, ref, args, ans, "cpu")
        assert got["centroid_gap_mm"] < 1e-12 and got["angle_gap_rel"] < 1e-12
        assert got["coord_gap_mm"] < 1e-12


def test_ladder_stages_match_the_documented_plans():
    assert [k for k in oct_single.ladder_stages(0.01, 6.0)] == [
        (1.0, 6.0, False), (0.1, 5.0, True), (0.01, 0.1, True)]
    # 0.5 deg over +-90: the ladder saves less than half, one sweep of the grid
    assert oct_single.ladder_stages(0.5, 90.0) == [(0.5, 90.0, False)]


def test_grid_counts_and_clamps():
    angles, valid = oct_single.grid(torch.tensor([0.0, 0.1], dtype=torch.float64), 1.0, 6.0, 6.0)
    assert angles.shape == (2, 14)
    assert int(valid[0].sum()) == 13
    assert float(angles[1][valid[1]].max()) <= np.radians(6.0) + 1e-15


def test_cost_table_is_the_squared_hausdorff():
    g = torch.Generator().manual_seed(3)
    test = torch.rand((2, 7, 2), generator=g, dtype=torch.float64) - 0.5
    ref = torch.rand((2, 5, 2), generator=g, dtype=torch.float64) - 0.5
    angles = torch.tensor([[0.0, 0.3], [1.0, -2.0]], dtype=torch.float64)
    got = oct_single.cost_table(test, ref, angles, torch.float64)
    for f in range(2):
        for k in range(2):
            c, s = np.cos(float(angles[f, k])), np.sin(float(angles[f, k]))
            t = test[f].numpy() @ np.array([[c, s], [-s, c]])
            d2 = ((t[:, None] - ref[f].numpy()[None]) ** 2).sum(-1)
            want = max(d2.min(1).max(), d2.min(0).max())
            assert float(got[f, k]) == pytest.approx(want, rel=1e-14)


@pytest.mark.parametrize("name,frames", [("oct4x280-full.synthetic", 12),
                                         ("oct4x280-full.realfix", 6)])
def test_full_reference_equals_port_f64(name, frames, cpu_port):
    """Four pullbacks: within, both between stages, postprocessing (one
    spacing for the synthetic mix; resampling, trimming and rebuilt walls of
    anomalous vessels for the fixtures)."""
    from portbench.reference import oct_full

    mt = cpu_port
    cell = tiny_cell(name, frames=frames)
    args = cell.entry.call_args(cell.config["args"])
    case = traffic.make_pool(cell.traffic, cell.config, 13, cell.bench_dir / "data")[0]
    mt.config.set_device("cpu")
    mt.config.set_compute_dtype(torch.float64)
    ans = cell.entry.answer(cell.entry.run_case(mt, case, args, lambda: None))
    want = oct_full.register(case, args, "cpu")
    for got_logs, want_logs in zip(ans["logs"], want["logs"]):
        np.testing.assert_allclose(got_logs, want_logs, rtol=0, atol=1e-9)
    for got_pair, want_pair in zip(ans["coords"], want["coords"]):
        for g, w in zip(got_pair, want_pair):
            assert set(g) == set(w)
            for k in w:
                assert oct_single.set_distance(g[k], w[k], "cpu") < 1e-9
    got = oct_full.judge(case, args, ans, "cpu")
    assert max(got.values()) < 1e-12, got


def test_predict_z_grows_the_grid_from_the_reference():
    from portbench.reference import oct_full

    z = oct_full.predict_z(1.0, 0.0, 2.05, 0.5)
    assert z == pytest.approx([0.0, 0.5, 1.0, 1.5, 2.0])
    assert oct_full.predict_z(0.0, 0.0, 1.0, 0.5) == pytest.approx([0.0, 0.5, 1.0])
    assert oct_full.predict_z(0.0, 0.0, 1.0, 0.0) == []


def test_logged_degrees_give_back_the_grid_angles():
    args = {"step_rotation_deg": 0.5, "range_rotation_deg": 90.0}
    angles, valid = oct_single.grid(torch.zeros(1, dtype=torch.float64), 0.5, 90.0, 90.0)
    g = angles[0][valid[0]].numpy()
    np.testing.assert_array_equal(oct_single.logged_radians(np.degrees(g), args), g)
    off_grid = np.radians([0.25, -10.1])
    np.testing.assert_array_equal(
        oct_single.logged_radians(np.degrees(off_grid), args), np.radians(np.degrees(off_grid)))
    ladder = {"step_rotation_deg": 0.01, "range_rotation_deg": 6.0}
    assert oct_single.logged_radians([1.0], ladder)[0] == np.radians(1.0)


def test_full_judge_follows_a_tied_start_and_no_other(monkeypatch):
    """Where two points of a turned real contour tie for its start (the
    fixture's closing point repeats its first), a program that starts the
    frame at the other one is judged exact; one that starts a frame with no
    tie a point off is not."""
    from portbench.reference import oct_full

    cell = tiny_cell("oct4x280-full.realfix", frames=6)
    args = cell.entry.call_args(cell.config["args"])
    case = traffic.make_pool(cell.traffic, cell.config, 3800000002, cell.bench_dir / "data")[0]
    monkeypatch.setattr(oct_full.single, "judge_chain",
                        lambda *a: {"centroid_gap_mm": 0.0, "angle_gap_rel": 0.0})
    zero = [np.zeros(len(np.unique(lumen[:, 0])) - 1) for _, lumen, _, _ in case]
    own = oct_full.register(case, args, "cpu", deltas=zero)
    k, f, off = next((k, f, offs[0]) for k, t in enumerate(own["ties"]) for f, offs in t.items())
    untied = next(g for g in range(6) if g not in own["ties"][k])

    def judged(starts):
        ans = oct_full.register(case, args, "cpu", deltas=zero, starts=starts)
        return oct_full.judge(case, args, ans, "cpu")["coord_gap_mm"]

    none = [{} for _ in case]
    assert judged(none) < 1e-12
    assert judged([{f: off} if j == k else {} for j in range(4)]) < 1e-12
    assert judged([{untied: 1} if j == k else {} for j in range(4)]) > 1e-4


def test_full_judge_follows_several_tied_starts(monkeypatch):
    """Three tied starts taken the other way, in two pullbacks: the judge
    finds all three."""
    from portbench.reference import oct_full

    cell = tiny_cell("oct4x280-full.realfix", frames=30)
    args = cell.entry.call_args(cell.config["args"])
    case = traffic.make_pool(cell.traffic, cell.config, 2200000403, cell.bench_dir / "data")[1]
    monkeypatch.setattr(oct_full.single, "judge_chain",
                        lambda *a: {"centroid_gap_mm": 0.0, "angle_gap_rel": 0.0})
    zero = [np.zeros(len(np.unique(lumen[:, 0])) - 1) for _, lumen, _, _ in case]
    ties = oct_full.register(case, args, "cpu", deltas=zero)["ties"]
    flips = [(k, f, offs[0]) for k, t in enumerate(ties) for f, offs in t.items()]
    pick = [flips[0], flips[-2], flips[-1]]
    assert len({k for k, _, _ in pick}) == 2
    starts = [{f: off for kk, f, off in pick if kk == k} for k in range(4)]
    ans = oct_full.register(case, args, "cpu", deltas=zero, starts=starts)
    assert oct_full.judge(case, args, ans, "cpu")["coord_gap_mm"] < 1e-12
