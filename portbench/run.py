"""Run one cell of the benchmark of ``multimodars_torch`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) is a closed loop:
one client registers one patient's pullbacks after another.  Set-up makes a
pool of distinct cases from ``--seed`` (``harness/traffic.py``) and runs
the configuration's warm-up cases; the window then runs the pool's cases in
turn for ``--seconds``, timing each on the host clock from the conversion
of its arrays to the card's last operation.  After the window a sample of
the answers, drawn from the seed, is judged against the plain reference.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics, read from the
port's spans and counters and a torch.profiler trace of the window),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit.  The last lines of standard error give the
same numbers.  Without a card, with fewer cards than the cell asks for, or
where JAX or the JAX package was loaded, it exits with another code than 0
and prints no result.
"""

import os
import time

T_START = time.perf_counter()

# the host of every configuration (its "host"): one thread for every
# numerical library, set before numpy and torch load, and the CPUs the
# scheduler gives the process, none pinned
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
if __name__ == "__main__":
    for _var in THREAD_VARS:
        os.environ[_var] = "1"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import devtrace, guard, spec, sweepwork, traffic  # noqa: E402

# kernel caches of PyTorch and Triton, at fixed paths inside the checkout
# (the port builds its own kernels into multimodars_torch/_build/)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": ".portbench_cache/torch_extensions",
              "TRITON_CACHE_DIR": ".portbench_cache/triton"}
EXIT_NO_CARD, EXIT_FORBIDDEN, EXIT_FAILED = 2, 3, 1
# the random stream, beside the pool's, that draws the judged sample
SAMPLE_STREAM = 1 << 40


class Failure(Exception):
    """The run cannot report a result."""


def clean_environment(root: Path) -> None:
    """The port at its defaults: every ``MMTPU_*`` switch cleared."""
    for key in [k for k in os.environ if k.startswith("MMTPU_")]:
        del os.environ[key]
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(root / rel)


def card_info(torch) -> dict:
    """The card's name, SM count and power limit."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        limit = smi.stdout.splitlines()[0].strip() if smi.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        limit = "not read"
    props = torch.cuda.get_device_properties(0)
    return {"name": torch.cuda.get_device_name(0), "sms": props.multi_processor_count,
            "power_limit": limit}


def _reset_counters(spans, prune_stats, repair_stats, sweep):
    spans.reset()
    for d in (prune_stats, repair_stats):
        for k in d:
            d[k] = 0
    sweep.launches = 0
    sweep.masked_launches = 0


def measure(cell, seed: int, seconds: float, trace: bool, device: str, sync, card: dict,
            log=print, t_start: float = T_START):
    """Set up, run the window, judge the sample; returns the result line
    (a dict) and the check lines."""
    import torch

    import multimodars_torch as mt
    from multimodars_torch.ops import argmin_repair, rotation_search, sweep
    from multimodars_torch.utils import trace as spans

    cfg = cell.config
    mt.config.set_device(device)
    mt.config.set_compute_dtype(getattr(torch, cfg["dtype"]))
    entry = cell.entry
    args = entry.call_args(cfg["args"])
    log(f"[portbench] {cell.name}: {cfg['entry']} in {cfg['dtype']} on {card['name']} "
        f"(power limit {card['power_limit']}), seed {seed}, {seconds} s, trace {int(trace)}, "
        f"CPUs {sorted(os.sched_getaffinity(0))}")
    t_imported = time.perf_counter()
    pool = traffic.make_pool(cell.traffic, cfg, seed, cell.bench_dir / "data")
    t_pool = time.perf_counter()
    # the port prints a table a pullback: the window times it, not a terminal
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        for i in range(cfg["warmup_cases"]):
            entry.run_case(mt, pool[i % len(pool)], args, sync)
    setup_s = time.perf_counter() - t_start
    log(f"[portbench] set-up {setup_s:.3f} s: start to imports {t_imported - t_start:.3f} s, "
        f"pool {t_pool - t_imported:.3f} s, warm-up {t_start + setup_s - t_pool:.3f} s")

    _reset_counters(spans, rotation_search.prune_stats, argmin_repair.stats, sweep)
    rng = traffic.rng_for(seed, SAMPLE_STREAM)
    keep = cfg["check_cases"]
    kept = []  # (window call, pool index, answer): a uniform sample of the calls
    case_s, searches, failed = [], 0, 0
    tables, prof = None, None
    with contextlib.ExitStack() as stack:
        if trace:
            tables = stack.enter_context(sweepwork.recorded_tables(sweep))
            prof = stack.enter_context(torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]))
        stack.enter_context(contextlib.redirect_stdout(stack.enter_context(open(os.devnull, "w"))))
        with torch.profiler.record_function(devtrace.WINDOW):
            w0 = time.perf_counter()
            n = 0
            while True:
                idx = n % len(pool)
                t0 = time.perf_counter()
                try:
                    out = entry.run_case(mt, pool[idx], args, sync)
                except Exception:  # a failed case is counted, and the window goes on
                    if not failed:
                        log(traceback.format_exc())
                    failed += 1
                    out = None
                t1 = time.perf_counter()
                case_s.append(t1 - t0)
                searches += entry.searches(pool[idx])
                slot = n if n < keep else int(rng.integers(0, n + 1))
                if slot < keep:
                    if len(kept) < keep:
                        kept.append((n, idx, out))
                    else:
                        kept[slot] = (n, idx, out)
                del out
                n += 1
                if t1 - w0 >= seconds:
                    break
            window_s = time.perf_counter() - w0
    memory_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    span_totals = spans.summary()
    prune = dict(rotation_search.prune_stats)
    repair = dict(argmin_repair.stats)
    launches = sweep.launches
    log(f"[portbench] window: {n} cases in {window_s:.3f} s, median case "
        f"{sorted(case_s)[n // 2]:.4f} s; sweep launches {launches}, prune {prune}, "
        f"repair {repair}")

    found = guard.loaded_forbidden()
    if found:
        raise Failure(f"loaded after the window: {', '.join(found)}")

    reduced = None
    if trace:
        reduced = devtrace.reduce(devtrace.profiler_events(prof))
        del prof

    ctx = SimpleNamespace(
        cases=n, window_s=window_s, case_s=case_s, setup_s=setup_s, spans=span_totals,
        config=cfg, prune=prune, repair=repair, launches=launches, searches=searches,
        tables=tables, device=reduced, n_sms=card["sms"], card=card)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        got = spec.metric_reader(cell.bench_dir, m["name"])(ctx)
        if got is None:
            log(f"[portbench] {m['name']}: nothing to read in this run")
            continue
        extra = got if isinstance(got, dict) else {"value": got}
        metrics[m["name"]] = {"value": extra.pop("value"), "unit": m["unit"], **extra}

    # the reference runs after the program's state is freed
    if device != "cpu":
        torch.cuda.empty_cache()
    readings = {}
    for call, idx, out in kept:
        if out is None:
            continue
        t0 = time.perf_counter()
        got = entry.judge(pool[idx], entry.answer(out), args, device)
        log(f"[portbench] judged window call {call} (pool case {idx}) in "
            f"{time.perf_counter() - t0:.2f} s: "
            + ", ".join(f"{k} {v!r}" for k, v in got.items()))
        for k, v in got.items():
            readings[k] = max(readings.get(k, 0.0), v)
    limits = cfg["limits"]
    checks = {k: {"value": readings.get(k, float("inf")), "limit": limits[k]} for k in limits}
    correct = (failed == 0 and bool(readings)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    dev = {"platform": "gpu" if device != "cpu" else "cpu", "kind": card["name"],
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": n, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = checks
    lines = [f"[check] {k} {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    lines.append(f"[check] failed cases {failed} of {n}; correct {correct}")
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opts = ap.parse_args(argv)
    root = Path.cwd()
    clean_environment(root)
    try:
        cell = spec.load_cell(root, opts.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"[portbench] cannot load workload {opts.workload!r}: {e}", file=sys.stderr)
        return EXIT_FAILED

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[portbench] needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_CARD
    card = card_info(torch)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    try:
        result, lines = measure(cell, opts.seed, opts.seconds, bool(opts.trace), "cuda",
                                torch.cuda.synchronize, card, log)
    except Failure as e:
        log(f"[portbench] {e}")
        return EXIT_FORBIDDEN
    except Exception:
        log(traceback.format_exc())
        return EXIT_FAILED
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
