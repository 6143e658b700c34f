"""Readings that set a cell's limits: the program's sound runs on many
seeds and the lower-precision control on a few, at the cell's own sizes.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 --seed0 <n>

The program's readings are those of :func:`run.measure` itself: a short
window of each seed (``--seconds``) and the judged sample of its answers.
The control puts the plain reference in the program's place, computed one
precision below the program's (the entry's ``control``), on the first
``check_cases`` cases of each seed's pool, and judges that.  Prints one
line a judged case and, last, the largest program reading and the smallest
control reading of each number; limits go between the two.  Runs on the
card (``--device cuda``) or, for a rehearsal, on the CPU."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402
from portbench.harness import spec, traffic  # noqa: E402

CPU_CARD = {"name": "cpu", "sms": 1, "power_limit": "not read"}


def readings(cell, seeds, control_seeds, seed0, device, seconds, log=print):
    import torch

    if device == "cpu":
        card, sync = CPU_CARD, (lambda: None)
    else:
        card, sync = run.card_info(torch), torch.cuda.synchronize
    program, control = {}, {}
    for k in range(seeds):
        result, _ = run.measure(cell, seed0 + k, seconds, False, device, sync, card, log,
                                time.perf_counter())
        for name, c in result["checks"].items():
            program[name] = max(program.get(name, 0.0), c["value"])
        log(f"program seed {seed0 + k}: {result['attempted']} cases, failed "
            f"{result['failed']}, " + ", ".join(f"{n} {c['value']!r}"
                                               for n, c in result["checks"].items()))
    entry = cell.entry
    args = entry.call_args(cell.config["args"])
    for k in range(control_seeds):
        pool = traffic.make_pool(cell.traffic, cell.config, seed0 + k, cell.bench_dir / "data")
        for case in pool[:cell.config["check_cases"]]:
            got = entry.judge(case, entry.control(case, args, device), args, device)
            for name, v in got.items():
                control[name] = min(control.get(name, float("inf")), v)
            log(f"control seed {seed0 + k}: " + ", ".join(f"{n} {v!r}" for n, v in got.items()))
    return program, control


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seed0", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args(argv)
    run.clean_environment(Path.cwd())
    cell = spec.load_cell(Path.cwd(), opts.workload)
    program, control = readings(cell, opts.seeds, opts.control_seeds, opts.seed0,
                                opts.device, opts.seconds,
                                lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps({"workload": opts.workload, "program_max": program,
                      "control_min": control, "limits": cell.config["limits"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
