"""The command: no card, no result; its result line's keys; the window's
count of cases; on the card, one short run (marked, skipped here)."""

import json
import subprocess
import sys
import time

import pytest
import torch
from conftest import CPU_CARD, ROOT, tiny_cell

import portbench.run as run


def test_without_a_card_it_fails_and_prints_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", "oct280-single.synthetic", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    assert code == run.EXIT_NO_CARD
    assert capsys.readouterr().out == ""


def test_with_fewer_cards_than_the_cell_asks_it_fails(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    code = run.main(["--workload", "oct280-single.realfix", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    assert code == run.EXIT_NO_CARD and capsys.readouterr().out == ""


def test_only_the_benchmark_files_fail(tmp_path):
    """A directory with BENCHMARK.json and portbench/ alone has no port."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "oct280-single.synthetic", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_mmtpu_switches_are_cleared(monkeypatch, tmp_path):
    monkeypatch.setenv("MMTPU_NO_PRUNE", "1")
    monkeypatch.setenv("MMTPU_COMPUTE_DTYPE", "float64")
    run.clean_environment(tmp_path)
    import os

    assert not [k for k in os.environ if k.startswith("MMTPU_")]
    assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / ".portbench_cache/triton")


def test_every_case_of_the_window_is_counted(cpu_port):
    cell = tiny_cell("oct280-single.synthetic")
    cell.end_to_end = [{"name": "cases_per_s", "unit": "cases/s"},
                       {"name": "case_p95_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}]
    res, lines = run.measure(cell, 4, 0.5, False, "cpu", lambda: None, CPU_CARD,
                             lambda m: None, time.perf_counter())
    m = res["metrics"]
    assert res["attempted"] >= 2
    assert m["cases_per_s"]["value"] * 0.5 <= res["attempted"] + 1e-9
    assert m["case_p95_s"]["value"] > 0 and m["setup_s"]["value"] > 0
    assert lines[-1].startswith("[check] failed cases 0")
    json.dumps(res)


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "oct280-single.synthetic", "--seed", "2", "--seconds", "2",
                          "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["metrics"]["sweep_roofline"]["value"] <= 100
