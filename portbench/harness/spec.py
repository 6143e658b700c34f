"""Finds a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout names the cell, its configuration (``configs/<name>.json``), its
traffic mix (``traffic/<name>.json``) and its metrics; the configuration
names its entry (``entries/<entry>.py``), the mix its generator
(``generators/<kind>.py``, see ``traffic.py``); each metric is read by
``metrics/<name>.py``.  A new cell, configuration, mix, kind of traffic,
entry or metric is a new file and an entry in ``BENCHMARK.json``: nothing
here names one."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    entry: object
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    bench_dir: Path = BENCH_DIR


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(path: Path):
    """The Python file ``path`` as a module of its own."""
    tag = re.sub(r"\W", "_", str(path.relative_to(path.parents[1])))
    spec = importlib.util.spec_from_file_location(f"portbench_{tag}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(root: Path, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files read from
    ``bench_dir``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config = json.loads((bench_dir / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    entry = load_module(bench_dir / "entries" / f"{config['entry']}.py")
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=traffic, entry=entry,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        bench_dir=bench_dir,
    )


def metric_reader(bench_dir: Path, name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    return load_module(bench_dir / "metrics" / f"{name}.py").read
