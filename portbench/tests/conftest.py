"""Shared set-up of the benchmark's CPU tests: the checkout's root on the
path, and cells of ``BENCHMARK.json`` cut to a size a CPU test holds."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import spec  # noqa: E402

# 12 frames of 120 points (the synthetic mix) or of the fixture's 501
TINY = dict(frames=12, pool_cases=3, warmup_cases=1, check_cases=2)
CPU_CARD = {"name": "cpu", "sms": 132, "power_limit": "not read"}


def tiny_cell(name: str, frames: int = 12):
    """The cell ``<configuration>.<traffic>`` (listed in BENCHMARK.json or
    not) at ``frames`` frames, three cases a pool, its synthetic lumens at
    120 points."""
    config, traffic = name.split(".", 1)
    bench = spec.BENCH_DIR
    cfg = json.loads((bench / "configs" / f"{config}.json").read_text())
    cell = spec.Cell(
        name=name, chips=1, config_name=config, config=cfg, traffic_name=traffic,
        traffic=json.loads((bench / "traffic" / f"{traffic}.json").read_text()),
        entry=spec.load_module(bench / "entries" / f"{cfg['entry']}.py"))
    cell.config.update(TINY, frames=frames)
    if cell.traffic["kind"] == "ellipse":
        cell.traffic["points"] = 120
        cell.config["args"]["sample_size"] = 120
    return cell


@pytest.fixture
def cpu_port():
    """The port on the CPU, its device and dtype restored afterwards."""
    import multimodars_torch as mt

    device, dtype = mt.config.device, mt.config.compute_dtype
    yield mt
    mt.config.set_device(device)
    mt.config.set_compute_dtype(dtype)
