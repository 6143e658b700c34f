"""A cell's parts are found by name: a new configuration, mix, entry and
metric are new files and a BENCHMARK.json entry, nothing else."""

import json
import shutil
from types import SimpleNamespace

import pytest

from portbench.harness import spec


@pytest.fixture
def dummy_bench(tmp_path):
    bench = tmp_path / "portbench"
    for d in ("configs", "traffic", "entries", "metrics"):
        (bench / d).mkdir(parents=True)
    (bench / "configs" / "dummy-config.json").write_text(json.dumps({"entry": "dummy_entry"}))
    (bench / "traffic" / "dummy-mix.json").write_text(json.dumps({"kind": "dummy"}))
    (bench / "entries" / "dummy_entry.py").write_text("NAME = 'dummy entry'\n")
    (bench / "metrics" / "dummy_ms.per.case.py").write_text(
        "def read(ctx):\n    return 2 * ctx.cases\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "dummy-config.dummy-mix", "config": "dummy-config",
                       "traffic": "dummy-mix", "chips": 1, "why": "test"}],
        "end_to_end": [{"name": "cases_per_s"},
                       {"name": "case_p95_s", "workloads": ["another.cell"]}],
        "per_layer": [{"name": "dummy_ms.per.case", "workloads": ["dummy-config.dummy-mix"]}],
    }))
    return tmp_path, bench


def test_cell_found_by_name(dummy_bench):
    root, bench = dummy_bench
    cell = spec.load_cell(root, "dummy-config.dummy-mix", bench)
    assert cell.config == {"entry": "dummy_entry"}
    assert cell.traffic == {"kind": "dummy"}
    assert cell.entry.NAME == "dummy entry"
    assert [m["name"] for m in cell.end_to_end] == ["cases_per_s"]
    assert [m["name"] for m in cell.per_layer] == ["dummy_ms.per.case"]


def test_metric_found_by_name(dummy_bench):
    _, bench = dummy_bench
    assert spec.metric_reader(bench, "dummy_ms.per.case")(SimpleNamespace(cases=3)) == 6


def test_unknown_cell_and_missing_files_raise(dummy_bench):
    root, bench = dummy_bench
    with pytest.raises(KeyError):
        spec.load_cell(root, "no.such-cell", bench)
    with pytest.raises(FileNotFoundError):
        spec.metric_reader(bench, "no_such_metric")


def test_every_metric_of_benchmark_json_has_its_reader():
    bench = json.loads((spec.BENCH_DIR.parent / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(spec.BENCH_DIR, m["name"]))
    for w in bench["workloads"]:
        cell = spec.load_cell(spec.BENCH_DIR.parent, w["name"])
        assert cell.config["limits"] and all(v > 0 for v in cell.config["limits"].values())
        assert all(callable(getattr(cell.entry, f)) for f in
                   ("call_args", "run_case", "searches", "answer", "judge", "control"))


def test_a_copied_benchmark_runs_without_edits(tmp_path):
    """A new cell of an existing configuration and a copied mix: files and a
    BENCHMARK.json entry only."""
    root = spec.BENCH_DIR.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench")
    shutil.copy(tmp_path / "portbench" / "traffic" / "synthetic.json",
                tmp_path / "portbench" / "traffic" / "synthetic-copy.json")
    bench["workloads"].append({"name": "oct280-single.synthetic-copy",
                               "config": "oct280-single", "traffic": "synthetic-copy",
                               "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(tmp_path, "oct280-single.synthetic-copy", tmp_path / "portbench")
    assert cell.traffic["kind"] == "ellipse"


def test_a_cell_of_a_new_kind_runs_from_new_files_only(tmp_path, cpu_port):
    """A configuration with none of the OCT keys, a mix of a kind no
    generator had, its generator and its entry: new files and a
    BENCHMARK.json entry, run through the harness's own window."""
    import time

    import portbench.run as run
    from conftest import CPU_CARD

    bench = tmp_path / "portbench"
    shutil.copytree(spec.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "configs" / "sums.json").write_text(json.dumps({
        "entry": "sum_entry", "dtype": "float64", "pool_cases": 3, "warmup_cases": 1,
        "check_cases": 2, "args": {"scale": 2.0}, "limits": {"sum_gap": 1e-9}}))
    (bench / "traffic" / "ramps.json").write_text(json.dumps({"kind": "ramp", "length": 7}))
    (bench / "generators" / "ramp.py").write_text(
        "from portbench.harness.traffic import rng_for\n\n"
        "def make_pool(mix, config, seed, data_dir):\n"
        "    return [rng_for(seed, c).random(mix['length']) for c in range(config['pool_cases'])]\n")
    (bench / "entries" / "sum_entry.py").write_text(
        "import torch\n\n"
        "def call_args(raw):\n    return dict(raw)\n\n"
        "def run_case(mt, case, args, sync):\n"
        "    return float(torch.as_tensor(case).sum()) * args['scale']\n\n"
        "def searches(case):\n    return 0\n\n"
        "def answer(out):\n    return out\n\n"
        "def judge(case, ans, args, device):\n"
        "    return {'sum_gap': abs(ans - float(case.sum()) * args['scale'])}\n\n"
        "def control(case, args, device):\n"
        "    return float(case.astype('float16').sum()) * args['scale']\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "sums.ramps", "config": "sums", "traffic": "ramps",
                       "chips": 1, "why": "test"}],
        "end_to_end": [{"name": "cases_per_s", "unit": "cases/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": []}))
    cell = spec.load_cell(tmp_path, "sums.ramps", bench)
    res, _ = run.measure(cell, 2**33 + 5, 0.2, False, "cpu", lambda: None, CPU_CARD,
                         lambda m: None, time.perf_counter())
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"cases_per_s", "setup_s"}
