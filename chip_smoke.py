#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``multimodars_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

It builds the hand-written sweep kernel from ``multimodars_torch/csrc``,
holds it against its plain PyTorch version at the OCT-280 shapes, drives
the port's single-pullback main path (``from_array_single`` on a 280-frame,
500-point pullback at step 0.01 deg / range 6 deg, the reference's headline
protocol) and checks what comes out.  Phases:

1. environment: card name and power limit, torch/CUDA versions, kernel build
2. kernel against plain on the card: masked/dense, outer strides 1 and 6,
   f32 and f64; f64 within rtol 1e-12 with equal argmins, f32 within the
   certification band; the f32 divergence from f64 in band units; times
3. the main path on the card: f32 and f64 runs, launches counted, rot logs
   on the same grid angles, coordinates within 1e-4 mm, repair counters,
   exact host-f64 ladder spot checks, wall clock (median of 5 after 2
   warm-ups)
4. the port against itself across devices: ``from_file_single`` on the
   vendored ivus_rest fixture on CUDA and on the CPU plain path

Every phase prints its lines; any failure exits non-zero.  The line before
the last is the kernel summary JSON, the last line is
``{"ok": true, "device": {...}}``.  ``--only kernel`` stops after phase 2;
``--profile`` adds a torch.profiler breakdown of one steady main-path run.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OCT_FRAMES, OCT_POINTS = 280, 500
STEP_DEG, RANGE_DEG = 0.01, 6.0
MAIN_ARGS = dict(
    step_rotation_deg=STEP_DEG, range_rotation_deg=RANGE_DEG, sample_size=500,
    image_center=(4.5, 4.5), radius=0.5, n_points=20, write_obj=False,
    smooth=False, bruteforce=False,
)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def cuda_ms(torch, fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_environment(torch, sweep):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip(), flush=True)
    say("env", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
               f"device {torch.cuda.get_device_name(0)}, "
               f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    sweep._library()
    load_s = time.perf_counter() - t0
    built = sweep.build_seconds
    say("env", f"sweep kernel: nvcc build {built:.2f} s, load total {load_s:.2f} s"
        if built is not None else
        f"sweep kernel: already built, load {load_s:.2f} s")
    for line in sweep.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("env", "ptxas: " + line.strip())
    # the host I/O and finish steps of the main path use native/libmmio.so
    # when it builds, else their pure-Python versions: say which path runs
    from multimodars_torch.io import native

    t0 = time.perf_counter()
    lib = quiet(native.get_library)
    say("env", f"native I/O library (native/libmmio.so): "
               f"{'loaded' if lib is not None else 'unavailable, pure-Python host paths'}"
               f" in {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def oct_sample_sets():
    """The [280, 520, 2] centered sample sets the main path sweeps for the
    OCT-280 pullback (500 lumen points + the 20-point catheter ring)."""
    from bench import synthetic_oct_pullback
    from multimodars_torch import numpy_to_inputdata
    from multimodars_torch._processing import _to_inputdata
    from multimodars_torch.io.build import build_any_from_inputdata
    from multimodars_torch.pipelines.align_within import _validate_and_pack

    lumen, ref = synthetic_oct_pullback(OCT_FRAMES, OCT_POINTS)
    data = numpy_to_inputdata(lumen, ref, True, label="oct280")
    tg = build_any_from_inputdata(
        _to_inputdata(data), None, "oct280", True, (4.5, 4.5), 0.5, 20,
        verbose=False,
    )
    _obj, _tg, pts, mask = _validate_and_pack(tg, 500)
    check(mask is None and pts.shape == (OCT_FRAMES, 520, 2),
          f"unexpected sample sets {pts.shape}, mask {mask is not None}")
    return pts


def phase_kernel(torch, sweep, rs):
    import numpy as np

    dev = torch.device("cuda", 0)
    pts = oct_sample_sets()
    F = pts.shape[0] - 1
    rng = np.random.default_rng(11)
    # masked variant: ~5% of the slots invalid, from a seed
    mask = rng.random(pts.shape[:2]) > 0.05
    results = {}
    for dtype in (torch.float64, torch.float32):
        t = torch.as_tensor(pts, dtype=dtype, device=dev)
        m = torch.as_tensor(mask, device=dev)
        test, ref = t[1:].contiguous(), t[:-1].contiguous()
        tm, rm = m[1:].contiguous(), m[:-1].contiguous()
        centers = torch.zeros(F, dtype=dtype, device=dev)
        angles, valid = rs.candidate_angles(centers, 0.1, 5.0, RANGE_DEG)
        check(angles.shape == (F, 102), f"K = {angles.shape[1]}, expected 102")
        for dense in (False, True):
            for stride in (1, 6):
                kw = dict(dense=dense, outer_stride_test=stride,
                          outer_stride_ref=stride)
                args = (test, ref, None if dense else tm, None if dense else rm,
                        angles, valid)
                k_out = sweep.cost_table(*args, **kw)
                p_out = sweep.cost_table_plain(*args, **kw)
                torch.cuda.synchronize()
                ms = cuda_ms(torch, lambda: sweep.cost_table(*args, **kw), 10)
                plain_ms = cuda_ms(
                    torch, lambda: sweep.cost_table_plain(*args, **kw), 3
                )
                results[(dtype, dense, stride)] = dict(
                    k=k_out.double().cpu().numpy(),
                    p=p_out.double().cpu().numpy(),
                    ms=ms, plain_ms=plain_ms,
                    scale2=rs._point_scale2(test, ref).double().cpu().numpy(),
                )
    max_err = 0.0
    for (dtype, dense, stride), r in results.items():
        k, p = r["k"], r["p"]
        name = (f"{'f64' if dtype == torch.float64 else 'f32'} "
                f"{'dense' if dense else 'masked'} stride {stride}")
        check(k.shape == (F, 102), f"{name}: shape {k.shape}")
        check((np.isinf(k) == np.isinf(p)).all(), f"{name}: inf slots differ")
        fin = np.isfinite(p)
        err = float(np.abs(k[fin] - p[fin]).max())
        rel = float((np.abs(k[fin] - p[fin]) / np.maximum(np.abs(p[fin]), 1e-300)).max())
        max_err = max(max_err, err)
        argmin_eq = bool((k.argmin(axis=1) == p.argmin(axis=1)).all())
        line = (f"{name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                f"max |kernel-plain| {err:.3e} (rel {rel:.3e}), "
                f"argmin equal {argmin_eq}")
        if dtype == torch.float64:
            check(rel <= 1e-12, f"{name}: rel err {rel:.3e} > 1e-12")
            check(argmin_eq, f"{name}: argmin differs from plain")
        else:
            # f32 tolerance: the argmin-certification band at each cost
            eps = rs._eps_eff(torch.float32)
            s2 = r["scale2"][:, None]
            kf, pf = k[fin], p[fin]
            c = np.maximum(pf, 0.0)
            unit_c = eps * (np.sqrt(np.broadcast_to(s2, k.shape)[fin] * c) + c)
            check((np.abs(kf - pf) <= rs._TIE_C * unit_c).all(),
                  f"{name}: kernel differs from plain by more than the band")
            # divergence from the f64 table in units eps32*(sqrt(scale2*m)+m)
            # of the band at the winning cost m (the band is _TIE_C units):
            # over all candidates, over those within 2 bands of m, and in
            # each candidate's own unit eps32*(sqrt(scale2*c)+c)
            ref64 = results[(torch.float64, dense, stride)]["k"]
            m64 = np.where(np.isfinite(ref64), ref64, np.inf).min(axis=1)
            unit_m = eps * (np.sqrt(r["scale2"] * m64) + m64)
            um = np.broadcast_to(unit_m[:, None], k.shape)[fin]
            r64 = ref64[fin]
            div = np.abs(kf - r64) / um
            divp = np.abs(pf - r64) / um
            near = r64 <= np.broadcast_to(m64[:, None], k.shape)[fin] + 2 * rs._TIE_C * um
            own = np.abs(kf - r64) / (eps * (np.sqrt(np.broadcast_to(s2, k.shape)[fin] * r64) + r64))
            line += (f"; |cost_f32 - cost_f64| in units at m: max {float(div.max()):.3f} "
                     f"(= {float(div.max()) / rs._TIE_C:.3f} bands) over all, "
                     f"{float(div[near].max()):.3f} within 2 bands of m; "
                     f"own-cost units max {float(own.max()):.3f}; "
                     f"plain f32 {float(divp.max()):.3f} units at m")
        say("kernel", line)
    headline = results[(torch.float32, True, 1)]
    return dict(max_abs_err=max_err, ms=headline["ms"],
                plain_ms=headline["plain_ms"])


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def lumen_coords(geom):
    import numpy as np

    return np.concatenate([f.lumen.xyz_view() for f in geom.frames])


def phase_main_path(torch, sweep, mt, profile=False):
    import numpy as np

    from bench import synthetic_oct_pullback
    from multimodars_torch.ops import argmin_repair
    from multimodars_torch.ops.argmin_repair import exact_ladder
    from multimodars_torch.utils import trace

    lumen, ref = synthetic_oct_pullback(OCT_FRAMES, OCT_POINTS)
    data = mt.numpy_to_inputdata(lumen, ref, True, label="oct280")
    check(mt.config.device.type == "cuda", f"config.device {mt.config.device}")
    check(mt.config.compute_dtype == torch.float32,
          f"compute dtype {mt.config.compute_dtype}")

    def run():
        out = quiet(mt.from_array_single, data, **MAIN_ARGS)
        torch.cuda.synchronize()
        return out

    def counters():
        return {k: argmin_repair.stats.get(k, 0)
                for k in ("flagged", "repaired", "changed", "host_exact")}

    # the counted run: every launch count set to 0 just before it
    for k in argmin_repair.stats:
        argmin_repair.stats[k] = 0
    sweep.launches = 0
    trace.reset()
    t0 = time.perf_counter()
    geom32, logs32 = run()
    first_s = time.perf_counter() - t0
    launches = sweep.launches
    spans = trace.summary()
    stats32 = counters()
    say("main", f"from_array_single OCT-280 f32: {first_s:.3f} s (first run), "
                f"sweep launches {launches}, repair counters {stats32}")
    say("main", "spans (s): " + ", ".join(
        f"{k} {v[0]:.4f}" for k, v in sorted(spans.items(), key=lambda kv: -kv[1][0])))
    check(launches > 0, "the main path launched no sweep kernel")

    check(len(logs32) == OCT_FRAMES - 1, f"{len(logs32)} logs")
    c32 = lumen_coords(geom32)
    check(len(geom32.frames) == OCT_FRAMES, f"{len(geom32.frames)} frames")
    check(c32.shape == (OCT_FRAMES * OCT_POINTS, 3) and np.isfinite(c32).all(),
          "output coordinates not finite or of the wrong shape")

    for k in argmin_repair.stats:
        argmin_repair.stats[k] = 0
    with mt.config.use(dtype=torch.float64):
        geom64, logs64 = run()
    stats64 = counters()
    r32 = np.array([l[2] for l in logs32])
    r64 = np.array([l[2] for l in logs64])
    same_grid = bool(np.array_equal(np.rint(r32 / STEP_DEG), np.rint(r64 / STEP_DEG)))
    d_rot = float(np.abs(r32 - r64).max())
    d_xyz = float(np.abs(c32 - lumen_coords(geom64)).max())
    say("main", f"f64 run: repair counters {stats64}; f32 vs f64: same grid "
                f"angle in every pair {same_grid}, max |rot diff| {d_rot:.3e} deg, "
                f"max |coord diff| {d_xyz:.3e} mm")
    check(same_grid and d_rot < 1e-4,
          "f32 and f64 rot logs land on different grid angles")
    check(d_xyz <= 1e-4, f"f32 vs f64 coordinates differ by {d_xyz} mm")

    # exact host f64 ladder on a few pairs, from the same sample sets
    pts = oct_sample_sets()
    for i in (0, 69, 139, 208, 278):
        want = math.degrees(exact_ladder(pts[i + 1], pts[i], STEP_DEG, RANGE_DEG, False))
        check(abs(want - r32[i]) < 1e-4,
              f"pair {i}: port {r32[i]} deg, exact host ladder {want} deg")
    say("main", "exact host f64 ladder agrees on pairs 0, 69, 139, 208, 278")

    for _ in range(2):
        run()
    trace.reset()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[2]
    say("main", f"wall clock f32, median of 5 after 2 warm-ups: {med:.4f} s "
                f"(runs {', '.join(f'{t:.4f}' for t in times)})")
    say("main", "mean spans of those runs (s): " + ", ".join(
        f"{k} {v[0] / v[1]:.4f}"
        for k, v in sorted(trace.summary().items(), key=lambda kv: -kv[1][0])))
    if profile:
        profile_main_path(torch, run)
    return launches, med


def profile_main_path(torch, run):
    """One steady f32 run under torch.profiler: device time by kernel and
    the device's busy share of the wall clock.  The trace goes to
    chiprun_out/oct280_profile.json."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    rows = []
    busy_us = 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, evt.count, evt.key))
            busy_us += dev_us
    rows.sort(reverse=True)
    say("profile", f"wall {wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
                   f"({100.0 * busy_us / 1e6 / wall:.2f}% busy, "
                   f"{100.0 - 100.0 * busy_us / 1e6 / wall:.2f}% idle)")
    for dev_us, count, key in rows[:12]:
        say("profile", f"{dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / "oct280_profile.json"))


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def phase_cross_device(torch, mt):
    import numpy as np

    path = REPO / "tests" / "data" / "fixtures" / "ivus_rest"
    check(path.is_dir(), f"fixture {path} missing")

    def run():
        return quiet(mt.from_file_single, str(path), label="ivus_rest",
                     write_obj=False)

    g_cuda, l_cuda = run()
    with mt.config.use(device="cuda", dtype=torch.float64):
        g_c64, l_c64 = run()
    with mt.config.use(device="cpu", dtype=torch.float64):
        g_cpu, l_cpu = run()
    check(len(l_cuda) == len(l_cpu) > 0, "log lengths differ")
    arr = {k: np.array([l[2:5] for l in v])
           for k, v in (("cuda", l_cuda), ("c64", l_c64), ("cpu", l_cpu))}
    d_f32 = np.abs(arr["cuda"] - arr["cpu"]).max(axis=0)
    d_f64 = np.abs(arr["c64"] - arr["cpu"]).max(axis=0)
    d_xyz = float(np.abs(lumen_coords(g_c64) - lumen_coords(g_cpu)).max())
    say("cross", f"ivus_rest from_file_single: CUDA f32 vs CPU f64 max |diff| "
                 f"rot {d_f32[0]:.3e} deg, tx {d_f32[1]:.3e}, ty {d_f32[2]:.3e}; "
                 f"CUDA f64 vs CPU f64 rot {d_f64[0]:.3e} deg, coords {d_xyz:.3e} mm")
    check(d_f32[0] < 1e-4 and d_f32[1] == 0.0 and d_f32[2] == 0.0,
          "CUDA f32 and CPU f64 logs disagree")
    check(d_f64[0] < 1e-12 and d_xyz < 1e-9, "CUDA f64 and CPU f64 logs disagree")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["kernel"], default=None,
                    help="stop after the kernel phase")
    ap.add_argument("--profile", action="store_true",
                    help="profile one steady main-path run (torch.profiler)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: no GPU to run on",
              flush=True)
        return 1
    if not (REPO / "multimodars_torch" / "csrc" / "sweep_cost.cu").is_file():
        print(f"FAIL: {REPO} is not a checkout of the repository", flush=True)
        return 1
    sys.path.insert(0, str(REPO))

    import multimodars_torch as mt
    from multimodars_torch.ops import rotation_search as rs
    from multimodars_torch.ops import sweep

    phase = "env"
    try:
        phase_environment(torch, sweep)
        phase = "kernel"
        kres = phase_kernel(torch, sweep, rs)
        launches = None
        if args.only != "kernel":
            phase = "main"
            launches, _ = phase_main_path(torch, sweep, mt, args.profile)
            phase = "cross"
            phase_cross_device(torch, mt)
    except SmokeFailure as e:
        print(f"FAIL [{phase}]: {e}", flush=True)
        return 1
    for name in sorted(sys.modules):
        if name == "jax" or name.startswith(("jax.", "multimodars_tpu")):
            print(f"FAIL: {name} was imported", flush=True)
            return 1
    print(json.dumps({"kernels": [{
        "name": "sweep_cost",
        "route": "cuda",
        "source": "multimodars_torch/csrc/sweep_cost.cu",
        "replaces": "multimodars_tpu/ops/pallas_kernels.py:50",
        "launches": launches,
        "max_abs_err": kres["max_abs_err"],
        "ms": kres["ms"],
        "plain_ms": kres["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
