#!/usr/bin/env python3
"""Time the kernels of one checkout at the main paths' shapes.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 sweep_bench.py                        # this checkout's sweep kernel
    python3 sweep_bench.py --root OTHER_TREE      # another checkout's
    python3 sweep_bench.py --family ccta [--root OTHER_TREE]

It imports ``multimodars_torch`` from ``--root`` (default: the directory of
this script) and builds its kernels.

- ``--family sweep`` (the default) times ``sweep.cost_table`` on seeded
  ring-shaped point sets at the shapes the single, four-phase and cohort
  paths give it (chip_smoke.py records them from the runs themselves): CUDA
  events around 5 calls in a row, the median of 3 such windows.
- ``--family ccta`` times ``radius_count.radius_count(a, b, r2lo, r2hi,
  flags=...)``, ``nearest.nearest(a, b)`` and ``morph_sweep.morph_sweep(
  points, unit, reference, xs)``, the signatures every checkout since the
  CCTA toolkit's port has, on seeded tube-like clouds at the CCTA fusion
  run's recorded shapes (chip_smoke.py phase 8): CUDA events around 5 calls
  (median of 11 windows), and for every shape the kernel's device time per
  launch (torch.profiler, 20 calls) and the host time per call (the
  wrapper's enqueue: 40 calls with one synchronise after them, median of 11
  windows).  The scale stage's three sweeps are timed alone and as one
  stage: one ``morph_sweep.morph_sweep_batch`` call where the checkout has
  it, else its three ``morph_sweep`` calls; for a sweep or a stage the
  device time is per call, over every morph-sweep kernel and every fill
  or memset a call makes.
  ``--sass`` adds the instructions per pair (per offset and pair for the
  sweep) of each kernel's inner loop, read from ``cuobjdump -sass`` of the
  libraries just built.
- ``--family ccta-wall`` times the CCTA fusion run of chip_smoke.py phase 8
  (``label`` -> ``scale`` -> ``stitch`` in f32 on the 57,606-vertex case,
  the public entry points every checkout since the toolkit's port has):
  the host clock around each run, ending in a synchronise, median of 11
  after 2 warm-ups, and the mean of the ``ccta.*`` stage spans.

Bounds and shares are chip_smoke.py's.  To compare two versions, time them
in one run on one card, in turns: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# (name, F, N, M, K, outer stride, dtype, masked)
SHAPES = [
    ("f32 exact [279] x K 102", 279, 520, 520, 102, 1, "float32", False),
    ("f32 stride 6 [279] x K 102", 279, 520, 520, 102, 6, "float32", False),
    ("f32 exact [279] x K 14", 279, 520, 520, 14, 1, "float32", False),
    ("f32 exact [279] x K 12", 279, 520, 520, 12, 1, "float32", False),
    ("f32 exact [279] x K 22", 279, 520, 520, 22, 1, "float32", False),
    ("f32 stride 6 [1116] x K 362", 1116, 520, 520, 362, 6, "float32", False),
    ("f32 exact [1116] x K 12", 1116, 520, 520, 12, 1, "float32", False),
    ("f32 stride 6 [4464] x K 362", 4464, 520, 520, 362, 6, "float32", False),
    ("f32 exact [4464] x K 12", 4464, 520, 520, 12, 1, "float32", False),
    ("f32 masked stride 6 [2, 560] x K 362", 2, 560, 560, 362, 6, "float32", True),
    ("f32 masked exact [2, 560] x K 12", 2, 560, 560, 12, 1, "float32", True),
    ("f64 exact [279] x K 102", 279, 520, 520, 102, 1, "float64", False),
    ("f64 exact [4] x K 362", 4, 520, 520, 362, 1, "float64", False),
    ("f64 masked stride 6 [2, 560] x K 362", 2, 560, 560, 362, 6, "float64", True),
]


def ring_sets(np, F, N, seed):
    """F noisy ellipses of N points around the origin, from a seed."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0.0, 2.0 * math.pi, N, endpoint=False)[None] + rng.uniform(0.0, 0.1, (F, 1))
    a = 2.0 + 0.1 * rng.standard_normal((F, 1))
    b = 1.4 + 0.1 * rng.standard_normal((F, 1))
    return np.stack([a * np.cos(th), b * np.sin(th)], -1) + rng.normal(0.0, 0.01, (F, N, 2))


def table_args(torch, np, F, N, M, K, stride, dtype, masked):
    dev = torch.device("cuda", 0)
    dt = getattr(torch, dtype)
    test = torch.tensor(ring_sets(np, F, N, 1), dtype=dt, device=dev)
    ref = torch.tensor(ring_sets(np, F, M, 2), dtype=dt, device=dev)
    angles = torch.linspace(-math.pi / 2, math.pi / 2, K, dtype=dt, device=dev)
    angles = angles[None].repeat(F, 1).contiguous()
    valid = torch.ones((F, K), dtype=torch.bool, device=dev)
    valid[:, -1] = False  # the grids' last slot is often past the window
    tm = rm = None
    if masked:  # the between clouds' padding
        tm = torch.ones((F, N), dtype=torch.bool, device=dev)
        rm = torch.ones((F, M), dtype=torch.bool, device=dev)
        tm[:, -20:] = False
        rm[:, -15:] = False
    kw = dict(dense=not masked, outer_stride_test=stride, outer_stride_ref=stride)
    return (test, ref, tm, rm, angles, valid), kw


# (name, kernel, N, M, dtype, squared radius or None, flags): the CCTA
# fusion run's recorded shapes at 57,606 vertices, and the seeded f64 count
CCTA_SHAPES = [
    ("f32 island count [18864] x [21587], r 2", "radius_count", 18864, 21587, "float32", 4.0, False),
    ("f32 island self-count [18864] x [18864], r 2", "radius_count", 18864, 18864, "float32", 4.0,
     False),
    ("f32 split absorption [4514] x [4032], r 1", "radius_count", 4514, 4032, "float32", 1.0, False),
    ("f32 split absorption [8609] x [4032], r 1", "radius_count", 8609, 4032, "float32", 1.0, False),
    ("f32 bounded flags [57606] x [60], r 3", "radius_count", 57606, 60, "float32", 9.0, True),
    ("f32 membership flags [18864] x [1047], r 0.71", "radius_count", 18864, 1047, "float32", 0.5,
     True),
    ("f32 region pick [4036] x [576]", "nearest", 4036, 576, "float32", None, False),
    ("f32 morph pick [26449] x [50]", "nearest", 26449, 50, "float32", None, False),
    ("f64 island count [18864] x [21587], r 2", "radius_count", 18864, 21587, "float64", 4.0, False),
    ("f64 seeded count [17000] x [40000], r 2", "radius_count", 17000, 40000, "float64", 4.0, False),
]


def tube_cloud(np, n, seed):
    """n points on the surfaces of a few 1.4-6 mm tubes along a 60 mm
    path, about a mesh's vertex spacing apart: the CCTA case's density."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 60.0, n)
    th = rng.uniform(0.0, 2.0 * math.pi, n)
    r = rng.choice([1.4, 1.4, 6.0], n)
    return np.stack([r * np.cos(th) + 0.1 * t, r * np.sin(th), t], 1)


def _device_us(evt):
    """An averaged profiler event's device time in µs (the attribute's name
    differs between torch versions)."""
    got = getattr(evt, "device_time_total", None)
    return evt.cuda_time_total if got is None else got


def device_ms(torch, fn, name, calls=20, also=()):
    """(device ms per call, launches per call) of the kernels whose name
    holds ``name``, plus the device time of every kernel, fill or memset
    whose name holds one of ``also``: torch.profiler over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if name in evt.key or any(a in evt.key.lower() for a in also):
            total += _device_us(evt)
            if name in evt.key:
                count += evt.count
    return total / 1e3 / calls, count / calls


def events_ms(torch, fn, calls=5, windows=11):
    """CUDA events around ``calls`` calls in a row, divided by ``calls``;
    the median of ``windows`` such windows (a small call's time is its
    host time, which wanders more than a device time)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[windows // 2]


def host_ms(torch, fn, calls=40, windows=11):
    """Host time of one call: the wrapper's enqueue, ``calls`` calls with
    one synchronise after them; the median of ``windows`` such windows."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e3 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return sorted(times)[windows // 2]


def sass_per_pair(sass: str):
    """Per kernel function of a ``cuobjdump -sass`` dump: its per-pair loop,
    the loop (a backward branch) with the most FP multiplies per
    instruction, as (function, instructions, pairs, counts by opcode); a
    pair's d2 takes 3 multiplies."""
    import collections
    import re

    out = []
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        ins = [(int(m.group(1), 16), m.group(2).strip())
               for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
        at = {a: k for k, (a, _) in enumerate(ins)}
        best = None
        for k, (a, op) in enumerate(ins):
            t = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if t is None or int(t.group(1), 16) >= a or int(t.group(1), 16) not in at:
                continue
            body = [re.sub(r"^@!?U?P\w+\s+", "", o).split()[0].split(".")[0]
                    for _, o in ins[at[int(t.group(1), 16)]:k + 1]]
            muls = sum(o in ("FMUL", "DMUL") for o in body)
            if muls >= 3 and (best is None or muls / len(body) > best[0]):
                best = (muls / len(body), body)
        if best is not None:
            body = best[1]
            pairs = sum(o in ("FMUL", "DMUL") for o in body) // 3
            out.append((name, len(body), pairs, collections.Counter(body)))
    return out


def report_sass(tag):
    """Instructions per pair of the count and pick kernels' inner loops,
    from this run's libraries (``cuobjdump`` beside ``nvcc``)."""
    import subprocess

    from multimodars_torch.ops import _cuda_build, morph_sweep, nearest, radius_count

    for name, (_, log) in sorted(_cuda_build.reports.items()):
        for line in log.splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"[bench-ccta] {tag}: ptxas {name}: {line.strip()}", flush=True)
    cuobjdump = Path(_cuda_build._nvcc("cuobjdump")).with_name("cuobjdump")
    for mod in (radius_count, nearest, morph_sweep):
        lib = _cuda_build.library_path(mod.SOURCE)
        if not lib.exists():  # not built by the shapes this run timed
            continue
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                              capture_output=True, text=True).stdout
        for name, n, pairs, ops in sass_per_pair(sass):
            top = ", ".join(f"{o} {c}" for o, c in ops.most_common(8))
            print(f"[bench-ccta] {tag}: sass {name}: inner loop {n} instructions for {pairs} "
                  f"pairs, {n / pairs:.2f} a pair ({top})", flush=True)


def bench_ccta(torch, np, tag):
    from chip_smoke import card_state, ccta_bound

    from multimodars_torch.ops import nearest, radius_count

    dev = torch.device("cuda", 0)
    for k, (name, kernel, n, m, dtype, r2, flags) in enumerate(CCTA_SHAPES):
        dt = getattr(torch, dtype)
        a = torch.tensor(tube_cloud(np, n, 2 * k + 1), dtype=dt, device=dev)
        b = torch.tensor(tube_cloud(np, m, 2 * k + 2), dtype=dt, device=dev)
        if kernel == "nearest":
            args, kw = (a, b), {}

            def fn():
                return nearest.nearest(a, b)
        else:
            args, kw = (a, b, r2 * (1 - 1e-6), r2 * (1 + 1e-6)), {"flags": flags}

            def fn():
                return radius_count.radius_count(*args, **kw)
        ms = events_ms(torch, fn)
        per_call, launches = device_ms(torch, fn, f"{kernel}_kernel")
        dms = per_call / launches if launches else float("nan")
        hms = host_ms(torch, fn)
        bound, by = ccta_bound(torch, kernel, args, kw)
        print(f"[bench-ccta] {tag}: {name}: events {ms:.4f} ms, device {dms:.4f} ms a launch, "
              f"host {hms:.4f} ms a call, bound {bound:.5f} ms ({by}), "
              f"{100.0 * bound / ms:.1f}% of bound by events, {100.0 * bound / dms:.1f}% by "
              f"device time (card after: {card_state()})", flush=True)


# the scale stage's sweeps at 57,606 vertices: (name, [(n, m), ...]), 41
# offsets each
MORPH_SHAPES = [
    ("distal sweep [1009] x [576] x 41", [(1009, 576)]),
    ("proximal sweep [1009] x [384] x 41", [(1009, 384)]),
    ("aortic sweep [1709] x [96] x 41", [(1709, 96)]),
    ("the stage's three sweeps", [(1009, 576), (1009, 384), (1709, 96)]),
]


def sweep_sets(np, n, m, seed):
    """Points on a 1.3 mm tube around a 20 mm centerline, their radial
    directions, and reference points on a 1.9 mm tube: a sweep's geometry."""
    rng = np.random.default_rng(seed)
    th, t = rng.uniform(0.0, 2.0 * math.pi, n), rng.uniform(0.0, 20.0, n)
    unit = np.stack([np.cos(th), np.sin(th), np.zeros(n)], 1)
    pts = unit * 1.3 + np.stack([np.zeros(n), np.zeros(n), t], 1)
    th2, t2 = rng.uniform(0.0, 2.0 * math.pi, m), rng.uniform(2.0, 18.0, m)
    ref = np.stack([1.9 * np.cos(th2), 1.9 * np.sin(th2), t2], 1)
    return pts - [0, 0, 10.0], unit, ref - [0, 0, 10.0]


def bench_morph(torch, np, tag):
    from chip_smoke import card_state, ccta_bound

    from multimodars_torch.ops import morph_sweep

    dev = torch.device("cuda", 0)
    batched = hasattr(morph_sweep, "morph_sweep_batch")
    for dtype in ("float32", "float64"):
        dt = getattr(torch, dtype)
        xs = torch.tensor(-2.0 + 0.1 * np.arange(41), dtype=dt, device=dev)
        for k, (name, sizes) in enumerate(MORPH_SHAPES):
            sets = [[torch.tensor(a, dtype=dt, device=dev) for a in sweep_sets(np, n, m, 3 * k + q)]
                    for q, (n, m) in enumerate(sizes)]
            pts, unit, ref = (torch.cat([s[i] for s in sets]) for i in range(3))
            sweeps, po, ro = [], 0, 0
            for n, m in sizes:
                sweeps.append((po, n, ro, m, 41))
                po, ro = po + n, ro + m
            if len(sizes) > 1 and batched:
                how = "one batched call"

                def fn():
                    return morph_sweep.morph_sweep_batch(pts, unit, ref, xs, sweeps)
            else:
                how = f"{len(sizes)} call(s)"

                def fn():
                    return [morph_sweep.morph_sweep(*s, xs) for s in sets]
            ms = events_ms(torch, fn)
            dms, per_call = device_ms(torch, fn, "morph_sweep", also=("fill", "memset"))
            hms = host_ms(torch, fn)
            bound, by = ccta_bound(torch, "morph_sweep_batch", (pts, unit, ref, xs, sweeps), {})
            print(f"[bench-ccta] {tag}: {dtype[:1]}{dtype[-2:]} {name} ({how}): events {ms:.4f} ms, "
                  f"device {dms:.4f} ms a call over {per_call:g} launch(es), host {hms:.4f} ms "
                  f"a call, bound {bound:.5f} ms ({by}), {100.0 * bound / ms:.1f}% of bound by "
                  f"events, {100.0 * bound / dms:.1f}% by device time (card after: "
                  f"{card_state()})", flush=True)


def bench_ccta_wall(torch, tag, runs=11):
    import contextlib
    import io

    import numpy as np

    from chip_smoke import CCTA_RCA_P0, CCTA_SCALE, ccta_case

    import multimodars_torch as mt
    from multimodars_torch.utils import trace

    case = ccta_case(mt)
    mesh, cl_ao, cl_rca, cl_lca, geom = case

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            results, (rca_cl, _lca_cl, ao_cl) = mt.label(
                mesh.copy(), cl_ao, cl_rca, cl_lca, aligned_frames=geom.frames,
                anomalous_rca=True, control_plot=False)
            if not results["rca_removed_points"]:
                ao = np.asarray(results["aorta_points"])
                near = np.linalg.norm(ao - np.asarray(CCTA_RCA_P0), axis=1) < 5.0
                results["rca_removed_points"] = [tuple(p) for p in ao[near][:100]]
            scaled = mt.scale(results, rca_cl, ao_cl, geom.frames)
            mt.stitch(scaled, geom, region_remove=("anomalous_points",),
                      prox_start_mode="nearest_iv", dist_start_mode="nearest_iv",
                      n_points_iv_cont=64 * CCTA_SCALE)
        torch.cuda.synchronize()

    for _ in range(2):
        run()
    trace.reset()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    spans = {k: v[0] / runs for k, v in trace.summary().items()
             if k in ("ccta.label", "ccta.scale", "ccta.stitch", "ccta.morph_sweep")}
    print(f"[bench-ccta-wall] {tag}: label -> scale -> stitch f32, median of {runs} after 2 "
          f"warm-ups: {sorted(times)[runs // 2]:.4f} s (min {min(times):.4f}, max "
          f"{max(times):.4f}); mean spans " + ", ".join(f"{k} {v:.4f} s" for k, v in
                                                       sorted(spans.items())), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose multimodars_torch is timed")
    ap.add_argument("--tag", default="", help="label printed on every line")
    ap.add_argument("--family", choices=["sweep", "ccta", "ccta-wall"], default="sweep",
                    help="the sweep kernel, or the CCTA count, pick and morph-sweep kernels")
    ap.add_argument("--only-morph", action="store_true",
                    help="with --family ccta: the morph-sweep shapes alone")
    ap.add_argument("--sass", action="store_true",
                    help="with --family ccta: instructions per pair of the kernels' inner "
                         "loops (cuobjdump -sass)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: no GPU to run on")
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(HERE))
    # this checkout's timing, bound and card reading
    from chip_smoke import card_state, cuda_ms, sweep_bound

    sys.path.insert(0, str(root))
    from multimodars_torch.ops import sweep

    check = Path(sweep.__file__).resolve()
    if root not in check.parents:
        print(f"FAIL: imported {check}, not from {root}")
        return 1
    tag = args.tag or root.name
    if args.family == "ccta-wall":
        bench_ccta_wall(torch, tag)
        return 0
    if args.family == "ccta":
        if not args.only_morph:
            bench_ccta(torch, np, tag)
        bench_morph(torch, np, tag)
        if args.sass:
            report_sass(tag)
        return 0
    for name, F, N, M, K, stride, dtype, masked in SHAPES:
        targs, kw = table_args(torch, np, F, N, M, K, stride, dtype, masked)
        ms = cuda_ms(torch, lambda: sweep.cost_table(*targs, **kw), 5)
        bound, by = sweep_bound(torch, targs, kw)
        print(f"[bench] {tag}: {name}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}), {100.0 * bound / ms:.1f}% of bound (card after: "
              f"{card_state()})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
