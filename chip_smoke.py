#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``multimodars_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

It builds the hand-written kernels from ``multimodars_torch/csrc`` (the
rotation sweep's cost table, the centerline refine's Hausdorff table, and
the CCTA toolkit's radius count, nearest pick and morph sweep; one ``nvcc``
each, started together), holds each against its plain PyTorch version at
the shapes the main paths give it, drives the port's single-pullback path
(``from_array_single`` on a 280-frame, 500-point pullback at step 0.01 deg /
range 6 deg, the reference's headline protocol) and its four-phase path
(``from_array_full`` on four such pullbacks at the canonical step 0.5 deg /
range 90 deg), its centerline registration, its cohort entry and its CCTA
mesh fusion, and checks what comes out.
Phases:

1. environment: card name and power limit, torch/CUDA versions, kernel builds
2. kernel against plain on the card: masked/dense, outer strides 1 and 6,
   f32 and f64; f64 within rtol 1e-12 with equal argmins, f32 within the
   certification band; the f32 divergence from f64 in band units; times
3. the main path on the card: f32 and f64 runs, launches counted, rot logs
   on the same grid angles, coordinates within 1e-4 mm, repair counters,
   exact host-f64 ladder spot checks, wall clock (median of 5 after 2
   warm-ups)
4. the port against itself across devices: ``from_file_single`` on the
   vendored ivus_rest fixture on CUDA and on the CPU plain path
5. the four-phase path on the card: the kernel against plain at the
   between tables' masked shapes (and one f64 width above 600 points, past
   the default shared-memory limit) and at the full path's dense lower
   bound; ``from_array_full`` on four OCT-280 pullbacks (rest/stress x
   diastole/systole) in f32 and f64, dense and masked launches counted, every
   within pair and the four between winners on the same grid index,
   coordinates within 1e-4 mm, the between winners against the exact host
   f64 ladder, wall clock (median of 5 after 2 warm-ups) and mean spans;
   ``from_file_full`` on ivus_rest + ivus_stress on CUDA and on the CPU
   plain path, identical in f64
6. centerline registration on the card: the north-star chain
   (``from_array_full`` -> ``read_centerline_vtp`` -> ``align_three_point``
   of phase 5's rest pair onto branch 0 of the vendored RCA centerline) and
   ``align_combined`` of its diastolic pullback against a ~57k-point tube
   cloud around branch 0 at the wrapper defaults (1 deg, +-15 deg, index
   range 2), in f32 and f64: refine kernel launches counted, the same
   (shift, angle) winner, coordinates within 1e-4 mm, the f64 kernel table
   of the winner's shift equal bit for bit to numpy's, ``align_three_point``
   equal on CUDA and the CPU, the refine kernel against plain at its real
   shapes, wall clock (median of 5 after 2 warm-ups) and spans
7. the cohort entry on the card: ``from_array_cohort`` on 16 OCT-280
   pullbacks (4464 pairs in one batch) at step 0.5 deg / range 90 deg in
   f32: the same grid angle in every pair as ``from_array_single`` per
   case, launches counted, pullbacks/s (median of 5 after 2 warm-ups)
8. CCTA mesh fusion on the card: ``label`` -> ``scale`` -> ``stitch`` with
   the CCTA fusion benchmark's arguments on its synthetic anomalous-RCA
   case at scale 3 (57,606 vertices, 115,200 faces), in f32 (launches of
   the radius count, nearest pick and morph sweep kernels counted, the
   scale stage's three sweeps in one batched call and launch, the
   certification counts of ``ccta.kernels.stats``), in f64 on the card and
   in f64 on the CPU: the same region index sets and scalings and the same
   stitched mesh (0.0 mm) in all three; each kernel against its plain
   version on the run's recorded inputs, f32 and f64, with ms, bound, share
   and calls per run; wall clock (median of 5 after 2 warm-ups) and spans

Every phase prints its lines; any failure exits non-zero.  The line before
the last is the kernel summary JSON, the last line is
``{"ok": true, "device": {...}}``.  ``--only kernel`` stops after phase 2
and holds the refine kernel and the three CCTA kernels against plain on
inputs of their main-path shapes from a seed;
``--profile`` adds a torch.profiler breakdown of one steady run of each
main path.
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
# the four-phase path at the reference's canonical defaults
# (functions.rs:144-167), OBJ export off as in the reference's benchmark
FULL_STEP, FULL_RANGE = 0.5, 90.0
FULL_ARGS = dict(
    step_rotation_deg=FULL_STEP, range_rotation_deg=FULL_RANGE,
    sample_size=500, smooth=True, postprocessing=True, write_obj=False,
)
FULL_PHASES = (("rest_dia", 7), ("rest_sys", 8), ("stress_dia", 9),
               ("stress_sys", 10))
# the f32 exact tables' divergence from f64 within 2 bands of the winner, in
# units eps32*(sqrt(scale2*m)+m), that the certification band was calibrated
# on (ROADMAP C; the first kernel measured 2.07)
DIVERGENCE_NEAR_MAX = 2.3


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
    """Milliseconds of one call of ``fn``: CUDA events around ``reps``
    calls in a row, divided by ``reps``; the median of 3 such windows after
    a warm-up call."""
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[1]


def card_state():
    """The card's SM clock, power draw and temperature now, as nvidia-smi
    reads them: printed beside kernel times taken just before."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return smi.stdout.strip() if smi.returncode == 0 else "not read"


# The bound of a kernel: the larger of its operations over the card's peak
# rate for their type and its bytes (each input read once, each output
# written once) over the card's memory rate.  Peaks of one H100 SXM at its
# 700 W limit (NVIDIA's data sheet):
# 3.35 TB/s of HBM; 128 FP32 and 64 FP64 lanes per SM at up to 1980 MHz,
# i.e. the 67 TFLOP/s FP32 (an FMA counted as 2) and its FP64 half.
HBM_BYTES_PER_S = 3.35e12
MAX_SM_CLOCK_HZ = 1.98e9
FP_LANES_PER_SM = {4: 128, 8: 64}
# one directed point pair: dx, dy (2 sub), dy*dy (1 mul), dx*dx + that
# (1 FMA), the running min (1)
OPS_PER_PAIR = 5


def bound_ms(torch, pairs, elem_size, nbytes):
    """(bound in ms, "operations" or "bytes") of ``pairs`` directed point
    pairs in points of ``elem_size`` bytes, moving ``nbytes``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops_s = OPS_PER_PAIR * pairs / (sms * FP_LANES_PER_SM[elem_size] * MAX_SM_CLOCK_HZ)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s else "bytes")


def sweep_bound(torch, args, kw):
    """The bound of one cost table on these inputs: per frame pair, its
    valid angles x (valid strided test rows x valid ref points + valid
    strided ref rows x valid test points), none for an empty set."""
    test, ref, tm, rm, angles, valid = args
    F, N, _ = test.shape
    M, K = ref.shape[1], angles.shape[1]
    dense = kw["dense"]
    if dense:
        tm = torch.ones((F, N), dtype=torch.bool, device=test.device)
        rm = torch.ones((F, M), dtype=torch.bool, device=test.device)
    st, sr = kw["outer_stride_test"], kw["outer_stride_ref"]
    nt, nr = tm.sum(1), rm.sum(1)
    pairs = (valid.sum(1) * (tm[:, ::st].sum(1) * nr + rm[:, ::sr].sum(1) * nt)).sum()
    e = test.element_size()
    nbytes = F * (N + M) * 2 * e + (0 if dense else F * (N + M)) + F * K * (2 * e + 1)
    return bound_ms(torch, int(pairs), e, nbytes)


def refine_bound(torch, p, pmask, q, qmask, K):
    """The bound of one refine table: both directions over every valid
    (candidate point, cloud point) pair, none for an empty set."""
    nv = pmask.sum(1)
    mv = qmask.sum(1).repeat_interleave(K)
    pairs = int((2 * nv * mv).sum())
    e = p.element_size()
    nbytes = (p.numel() + q.numel()) * e + pmask.numel() + qmask.numel() + p.shape[0] * e
    return bound_ms(torch, pairs, e, nbytes)


def table_name(torch, args, kw):
    test, ref, _, _, angles, _ = args
    st, sr = kw["outer_stride_test"], kw["outer_stride_ref"]
    return (f"{'f64' if test.dtype == torch.float64 else 'f32'} "
            f"{'dense' if kw['dense'] else 'masked'} "
            f"{'exact' if st == sr == 1 else f'stride {st}/{sr}'} "
            f"[{test.shape[0]}, {test.shape[1]}, {ref.shape[1]}] x K {angles.shape[1]}")


@contextlib.contextmanager
def recorded_tables(sweep):
    """Record the arguments of every cost table a run asks for."""
    seen = []
    table = sweep.cost_table

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return table(*args, **kwargs)

    sweep.cost_table = spy
    try:
        yield seen
    finally:
        sweep.cost_table = table


def report_tables(torch, sweep, path, seen):
    """Time each distinct cost table of one counted run on the kernel and
    print its ms, bound, share of the bound and launches per run."""
    groups = {}
    for args, kw in seen:
        kw = dict(dict(dense=False, outer_stride_test=1, outer_stride_ref=1), **kw)
        key = table_name(torch, args, kw)
        if key in groups:
            groups[key][2] += 1
        else:
            groups[key] = [args, kw, 1]
    rows = []
    for key, (args, kw, n) in groups.items():
        ms = cuda_ms(torch, lambda: sweep.cost_table(*args, **kw), 5)
        bound, by = sweep_bound(torch, args, kw)
        rows.append(dict(path=path, table=key, launches=n, ms=ms, bound_ms=bound))
        say("tables", f"{path}: {key}: {n} launch(es) per run, kernel {ms:.4f} ms, "
                      f"bound {bound:.4f} ms ({by}), {100.0 * bound / ms:.1f}% of bound "
                      f"(card after: {card_state()})")
    busy = sum(r["ms"] * r["launches"] for r in rows)
    least = sum(r["bound_ms"] * r["launches"] for r in rows)
    say("tables", f"{path}: sweep kernel per run {busy:.4f} ms over "
                  f"{sum(r['launches'] for r in rows)} launches, bound {least:.4f} ms, "
                  f"{100.0 * least / busy:.1f}% of bound")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_environment(torch, sweep, hb, ccta_ops):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip(), flush=True)
    say("env", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
               f"device {torch.cuda.get_device_name(0)}, "
               f"count {torch.cuda.device_count()}")
    from multimodars_torch.ops import _cuda_build

    t0 = time.perf_counter()
    mods = [sweep, hb, *ccta_ops]
    _cuda_build.compile_sources([(m.SOURCE, m.SOURCE.stem) for m in mods])
    for m in mods:
        m._library()
    say("env", f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for name, (built, log) in sorted(_cuda_build.reports.items()):
        say("env", f"{name}: nvcc build {built:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say("env", "ptxas: " + line.strip())
    # the host I/O, finish and ray steps use the port's build of
    # native/mmio.cpp when it builds, else their pure-Python versions: say
    # which path runs
    from multimodars_torch.io import native

    t0 = time.perf_counter()
    lib = quiet(native.get_library)
    say("env", f"native I/O library ({native.library_path().name}): "
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
                    torch, lambda: sweep.cost_table_plain(*args, **kw), 1
                )
                results[(dtype, dense, stride)] = dict(
                    k=k_out.double().cpu().numpy(),
                    p=p_out.double().cpu().numpy(),
                    ms=ms, plain_ms=plain_ms,
                    bound=sweep_bound(torch, args, kw),
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
        bound, by = r["bound"]
        line = (f"{name} [{F}, 520, 520] x K 102: kernel {r['ms']:.4f} ms, "
                f"bound {bound:.4f} ms ({by}), {100.0 * bound / r['ms']:.1f}% of bound, "
                f"plain {r['plain_ms']:.3f} ms, "
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
                     f"plain f32 {float(divp.max()):.3f} units at m over all, "
                     f"{float(divp[near].max()):.3f} within 2 bands of m")
            near_max = float(div[near].max())
        say("kernel", line)
        if dtype == torch.float32 and stride == 1:
            # the band's calibration (ROADMAP C) holds near the winner of an
            # exact table, the one whose argmin the band certifies
            check(near_max <= DIVERGENCE_NEAR_MAX,
                  f"{name}: f32 diverges from f64 by {near_max:.3f} units within "
                  f"2 bands of the winner, more than {DIVERGENCE_NEAR_MAX}")
    headline = results[(torch.float32, True, 1)]
    bound, by = headline["bound"]
    return dict(max_abs_err=max_err, ms=headline["ms"],
                plain_ms=headline["plain_ms"], bound_ms=bound, bound_by=by)


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
    reset_counters(sweep, argmin_repair, trace)
    with recorded_tables(sweep) as tables:
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
    report_tables(torch, sweep, "single", tables)

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
        profile_main_path(torch, run, "oct280_profile.json")
    return launches, med


def reset_counters(sweep, argmin_repair, trace):
    """Set every launch and repair count to 0 and clear the spans: done just
    before a main path's counted run."""
    from multimodars_torch.ops import hausdorff_batch

    for k in argmin_repair.stats:
        argmin_repair.stats[k] = 0
    sweep.launches = 0
    sweep.masked_launches = 0
    hausdorff_batch.launches = 0
    trace.reset()


def profile_main_path(torch, run, trace_name):
    """One steady f32 run under torch.profiler: device time by kernel and
    the device's busy share of the wall clock, from the device-side events
    of the trace (kernels, copies, fills; a CPU operator's device time
    would count its kernels twice).  A first, warm-up run lets the tracer
    start: it drops the first events of a window otherwise.  The trace is
    written under ``trace_name`` in the git-ignored output directory."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # leaving the block ends the recorded step; another step() would clear it
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        run()
        prof.step()
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / trace_name))
    events = json.loads((out / trace_name).read_text())["traceEvents"]
    by_name = {}
    for evt in events:
        if evt.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            row = by_name.setdefault(evt["name"], [0.0, 0])
            row[0] += evt["dur"]
            row[1] += 1
    busy_us = sum(us for us, _ in by_name.values())
    say("profile", f"wall {wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
                   f"({100.0 * busy_us / 1e6 / wall:.2f}% busy, "
                   f"{100.0 - 100.0 * busy_us / 1e6 / wall:.2f}% idle)")
    for key, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        say("profile", f"{us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    check(busy_us > 0, f"the profile of {trace_name} holds no device event")
    return by_name


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
# phase 5
# ---------------------------------------------------------------------------

def full_inputs(mt):
    """Four OCT-280 pullbacks from seeds: rest and stress, diastole and
    systole."""
    from bench import synthetic_oct_pullback

    out = []
    for label, seed in FULL_PHASES:
        lumen, ref = synthetic_oct_pullback(OCT_FRAMES, OCT_POINTS, seed)
        out.append(mt.numpy_to_inputdata(lumen, ref, label.endswith("dia"),
                                         label=label))
    return out


@contextlib.contextmanager
def recorded_between(align_between):
    """Record what each between stage of a run returns: its pairs, the
    winning angle per slot and the clouds it searched."""
    seen = []
    stage = align_between.between_stage

    def spy(*args, **kwargs):
        out = stage(*args, **kwargs)
        seen.append(out)
        return out

    align_between.between_stage = spy
    try:
        yield seen
    finally:
        align_between.between_stage = stage


def pair_coords(pairs):
    import numpy as np

    rows = []
    for pair in pairs:
        for geom in (pair.geom_a, pair.geom_b):
            for frame in geom.frames:
                rows.append(frame.lumen.xyz_view())
                for kind in sorted(frame.extras):
                    rows.append(frame.extras[kind].xyz_view())
    return np.concatenate(rows)


def between_tables(torch, rs, clouds, dtype, stride):
    """The between search's cost-table arguments for ``clouds``, packed by
    the main path's own align_between.pack_between, over the full-path
    grid."""
    from multimodars_torch.pipelines.align_between import pack_between

    dev = torch.device("cuda", 0)
    test, ref, tmask, rmask = pack_between(clouds)
    centers = torch.zeros(len(clouds), dtype=dtype, device=dev)
    angles, valid = rs.candidate_angles(centers, FULL_STEP, FULL_RANGE, FULL_RANGE)
    args = (torch.as_tensor(test, dtype=dtype, device=dev),
            torch.as_tensor(ref, dtype=dtype, device=dev),
            torch.as_tensor(tmask, device=dev), torch.as_tensor(rmask, device=dev),
            angles, valid)
    return args, dict(dense=False, outer_stride_test=stride, outer_stride_ref=stride)


def check_table(torch, sweep, rs, name, args, kw, plain_reps):
    """Kernel against plain on the same CUDA tensors, and lower bound
    against exact where the table is strided; returns (max abs err, kernel
    ms, plain ms)."""
    import numpy as np

    k_out = sweep.cost_table(*args, **kw).double().cpu().numpy()
    p_out = sweep.cost_table_plain(*args, **kw).double().cpu().numpy()
    if kw["outer_stride_test"] > 1 or kw["outer_stride_ref"] > 1:
        exact = sweep.cost_table(*args, **dict(kw, outer_stride_test=1,
                                               outer_stride_ref=1))
        check((k_out <= exact.double().cpu().numpy()).all(),
              f"{name}: a lower-bound entry exceeds the exact one")
    ms = cuda_ms(torch, lambda: sweep.cost_table(*args, **kw), 10)
    plain_ms = cuda_ms(torch, lambda: sweep.cost_table_plain(*args, **kw), plain_reps)
    check((np.isinf(k_out) == np.isinf(p_out)).all(), f"{name}: inf slots differ")
    fin = np.isfinite(p_out)
    diff = np.abs(k_out[fin] - p_out[fin])
    err = float(diff.max())
    rel = float((diff / np.maximum(np.abs(p_out[fin]), 1e-300)).max())
    argmin_eq = bool((k_out.argmin(axis=1) == p_out.argmin(axis=1)).all())
    test = args[0]
    if test.dtype == torch.float64:
        check(rel <= 1e-12 and argmin_eq,
              f"{name}: rel err {rel:.3e}, argmin equal {argmin_eq}")
    else:
        s2 = rs._point_scale2(args[0], args[1]).double().cpu().numpy()
        c = np.maximum(p_out[fin], 0.0)
        band = rs._TIE_C * rs._eps_eff(torch.float32) * (
            np.sqrt(np.broadcast_to(s2[:, None], p_out.shape)[fin] * c) + c)
        check((diff <= band).all(), f"{name}: kernel differs from plain by more than the band")
    F, N, M, K = sweep.check_inputs(*args, kw["dense"], kw["outer_stride_test"],
                                    kw["outer_stride_ref"])
    bound, by = sweep_bound(torch, args, kw)
    say("full", f"{name} [F {F}, N {N}, M {M}, K {K}]: kernel {ms:.4f} ms, "
                f"bound {bound:.4f} ms ({by}), {100.0 * bound / ms:.1f}% of bound "
                f"(card after: {card_state()}), "
                f"plain {plain_ms:.3f} ms, max |kernel-plain| {err:.3e} "
                f"(rel {rel:.3e}), argmin equal {argmin_eq}")
    return err, ms, plain_ms


# points a side of the f64 table whose launch needs more than the 48 KB of
# shared memory a block gets without opting in (angle tile 2: 3 x 1200
# points x 16 bytes)
WIDE_POINTS = 1200


def phase_full_kernel(torch, sweep, rs, mt, clouds):
    """The kernel against plain at the four-phase path's shapes: the masked
    between tables on the recorded stage-1 clouds, the same with the slots'
    widths made unequal, one f64 table of 1200 points (past the 48 KB
    default shared-memory limit), and the dense within lower bound over
    the 4 x 279 pairs."""
    import numpy as np

    from multimodars_torch._processing import _to_inputdata
    from multimodars_torch.io.build import build_any_from_inputdata
    from multimodars_torch.pipelines.align_within import _validate_and_pack

    uneven = [(clouds[0][0], clouds[0][1][:530]), (clouds[1][0][:520], clouds[1][1])]
    rng = np.random.default_rng(5)
    ring = np.linspace(0.0, 2 * math.pi, WIDE_POINTS, endpoint=False)
    wide = [(np.stack([2.0 * np.cos(ring), 1.4 * np.sin(ring)], -1)
             + rng.normal(0.0, 0.01, (WIDE_POINTS, 2)),
             np.stack([2.0 * np.cos(ring + 0.3), 1.4 * np.sin(ring + 0.3)], -1))
            for _ in range(2)]
    err = 0.0
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        for stride in (6, 1):
            for name, cl in (("between", clouds), ("between uneven", uneven)):
                args, kw = between_tables(torch, rs, cl, dtype, stride)
                e, _, _ = check_table(torch, sweep, rs,
                                      f"{tag} masked {name} stride {stride}",
                                      args, kw, 5)
                err = max(err, e)
    smem = sweep.plan_launch(2, WIDE_POINTS, WIDE_POINTS, 362, 1, 1, 8,
                             torch.cuda.get_device_properties(0).multi_processor_count).smem
    check(smem > 48 * 1024,
          f"the {WIDE_POINTS}-point f64 masked table needs only {smem} B")
    args, kw = between_tables(torch, rs, wide, torch.float64, 1)
    e, _, _ = check_table(torch, sweep, rs,
                          f"f64 masked {WIDE_POINTS} points ({smem} B shared)", args, kw, 1)
    err = max(err, e)

    # the dense within lower bound of the full path
    sets = []
    for data in full_inputs(mt):
        tg = build_any_from_inputdata(_to_inputdata(data), None, data.label,
                                      data.diastole, (4.5, 4.5), 0.5, 20,
                                      verbose=False)
        _obj, _tg, pts, mask = _validate_and_pack(tg, 500)
        check(mask is None, "OCT-280 sample sets are not dense")
        sets.append(pts)
    dev = torch.device("cuda", 0)
    test = torch.as_tensor(np.concatenate([p[1:] for p in sets]),
                           dtype=torch.float32, device=dev).contiguous()
    ref = torch.as_tensor(np.concatenate([p[:-1] for p in sets]),
                          dtype=torch.float32, device=dev).contiguous()
    centers = torch.zeros(test.shape[0], dtype=torch.float32, device=dev)
    angles, valid = rs.candidate_angles(centers, FULL_STEP, FULL_RANGE, FULL_RANGE)
    e, _, _ = check_table(torch, sweep, rs, "f32 dense within stride 6",
                          (test, ref, None, None, angles, valid),
                          dict(dense=True, outer_stride_test=6, outer_stride_ref=6), 1)
    return max(err, e)


def phase_full_path(torch, sweep, mt, profile=False):
    import numpy as np

    from multimodars_torch.ops import argmin_repair
    from multimodars_torch.ops.argmin_repair import exact_ladder
    from multimodars_torch.pipelines import align_between
    from multimodars_torch.utils import trace

    datas = full_inputs(mt)
    check(mt.config.compute_dtype == torch.float32,
          f"compute dtype {mt.config.compute_dtype}")

    def run():
        out = quiet(mt.from_array_full, *datas, **FULL_ARGS)
        torch.cuda.synchronize()
        return out

    def counters():
        return {k: argmin_repair.stats.get(k, 0)
                for k in ("flagged", "repaired", "changed", "host_exact")}

    # the counted run: every launch count set to 0 just before it
    reset_counters(sweep, argmin_repair, trace)
    with recorded_between(align_between) as stages32, recorded_tables(sweep) as tables:
        t0 = time.perf_counter()
        out32 = run()
        first_s = time.perf_counter() - t0
    launches, masked = sweep.launches, sweep.masked_launches
    stats32 = counters()
    say("full", f"from_array_full 4 x OCT-280 f32: {first_s:.3f} s (first run), "
                f"sweep launches {launches} ({launches - masked} dense, "
                f"{masked} masked), repair counters {stats32}")
    check(launches - masked > 0, "the full path launched no dense table")
    check(masked > 0, "the full path launched no masked table")

    pairs32, logs32 = out32[:4], out32[4]
    check([p.label for p in pairs32] == [
        "rest_dia - rest_sys", "stress_dia - stress_sys",
        "rest_dia - stress_dia", "rest_sys - stress_sys"],
        f"pair labels {[p.label for p in pairs32]}")
    check([len(l) for l in logs32] == [OCT_FRAMES - 1] * 4,
          f"log lengths {[len(l) for l in logs32]}")
    for pair in pairs32:
        n_a, n_b = len(pair.geom_a.frames), len(pair.geom_b.frames)
        check(n_a == n_b and 0 < n_a <= OCT_FRAMES,
              f"{pair.label}: {n_a} and {n_b} frames after postprocessing")
    c32 = pair_coords(pairs32)
    check(np.isfinite(c32).all(), "output coordinates not finite")
    check(len(stages32) == 2, f"{len(stages32)} between stages")
    win32 = np.concatenate([st[1] for st in stages32])
    clouds32 = [c for st in stages32 for c in st[2]]

    for k in argmin_repair.stats:
        argmin_repair.stats[k] = 0
    with mt.config.use(dtype=torch.float64), recorded_between(align_between) as stages64:
        out64 = run()
    stats64 = counters()
    win64 = np.concatenate([st[1] for st in stages64])

    def grid_index(rad):
        return np.rint((np.degrees(rad) + FULL_RANGE) / FULL_STEP).astype(np.int64)

    same_within = all(
        np.array_equal(np.rint(np.array([l[2] for l in a]) / FULL_STEP),
                       np.rint(np.array([l[2] for l in b]) / FULL_STEP))
        for a, b in zip(logs32, out64[4]))
    d_rot = max(float(np.abs(np.array([l[2] for l in a]) - np.array([l[2] for l in b])).max())
                for a, b in zip(logs32, out64[4]))
    same_between = bool(np.array_equal(grid_index(win32), grid_index(win64)))
    frames_equal = [len(p.geom_a.frames) for p in pairs32] == [
        len(p.geom_a.frames) for p in out64[:4]]
    say("full", f"f64 run: repair counters {stats64}; f32 vs f64: same grid angle "
                f"in every within pair {same_within} (max |rot diff| {d_rot:.3e} deg); "
                f"between winners (deg) f32 {np.degrees(win32).round(6).tolist()}, "
                f"f64 {np.degrees(win64).round(6).tolist()}, grid indices "
                f"{grid_index(win32).tolist()} vs {grid_index(win64).tolist()}, "
                f"same {same_between}; frame counts equal {frames_equal}")
    check(same_within, "f32 and f64 within logs land on different grid angles")
    check(same_between, "f32 and f64 between winners land on different grid indices")
    check(frames_equal, "f32 and f64 runs kept different frame counts")
    d_xyz = float(np.abs(c32 - pair_coords(out64[:4])).max())
    say("full", f"f32 vs f64 max |coord diff| over the four pairs {d_xyz:.3e} mm")
    check(d_xyz <= 1e-4, f"f32 vs f64 coordinates differ by {d_xyz} mm")

    # the four between winners against the exact host f64 ladder on the
    # clouds the f32 run searched
    t0 = time.perf_counter()
    for k, ((ref_xy, tgt_xy), w) in enumerate(zip(clouds32, win32)):
        pivot = ref_xy.mean(axis=0)
        want = exact_ladder(tgt_xy - pivot, ref_xy - pivot, FULL_STEP, FULL_RANGE, False)
        check(abs(math.degrees(want - w)) < 1e-4,
              f"between slot {k}: port {math.degrees(w)} deg, exact host ladder "
              f"{math.degrees(want)} deg")
    say("full", f"exact host f64 ladder agrees on the four between winners "
                f"(clouds {[len(c[0]) for c in clouds32]} x {[len(c[1]) for c in clouds32]} "
                f"points, {time.perf_counter() - t0:.1f} s)")
    report_tables(torch, sweep, "full", tables)

    for _ in range(2):
        run()
    trace.reset()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[2]
    say("full", f"wall clock f32, median of 5 after 2 warm-ups: {med:.4f} s "
                f"(runs {', '.join(f'{t:.4f}' for t in times)})")
    say("full", "spans per run, mean of those runs (s, calls): " + ", ".join(
        f"{k} {v[0] / 5:.4f} (x{v[1] // 5})"
        for k, v in sorted(trace.summary().items(), key=lambda kv: -kv[1][0])))
    if profile:
        profile_main_path(torch, run, "full_profile.json")
    return launches, clouds32, pairs32[0]


def phase_full_cross_device(torch, mt):
    import numpy as np

    fixtures = REPO / "tests" / "data" / "fixtures"
    paths = [str(fixtures / "ivus_rest"), str(fixtures / "ivus_stress")]
    for p in paths:
        check(Path(p).is_dir(), f"fixture {p} missing")

    def run(device):
        with mt.config.use(device=device, dtype=torch.float64):
            return quiet(mt.from_file_full, *paths, write_obj=False)

    t0 = time.perf_counter()
    cuda = run("cuda")
    cpu = run("cpu")
    d_rot = max(float(np.abs(np.array(a)[:, 2] - np.array(b)[:, 2]).max())
                for a, b in zip(cuda[4], cpu[4]))
    d_xyz = float(np.abs(pair_coords(cuda[:4]) - pair_coords(cpu[:4])).max())
    say("cross", f"ivus_rest + ivus_stress from_file_full: CUDA f64 vs CPU f64 max "
                 f"|diff| rot {d_rot:.3e} deg, coords {d_xyz:.3e} mm "
                 f"({time.perf_counter() - t0:.1f} s)")
    check(d_rot < 1e-12 and d_xyz < 1e-9, "CUDA f64 and CPU f64 full runs disagree")


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------

CL_VTP = REPO / "tests" / "data" / "centerlines" / "rca_cl.vtp"
# the landmarks sit on branch 0 at this arc length from its start, past the
# aortic root (radius 12-15 mm over the first ~35 mm)
CL_ARC_MM = 60.0
# the CCTA cloud: a tube of points this far apart around branch 0, at the
# centerline's own inscribed radii; the bounding-box filter of a 56 mm
# segment keeps this many of them
TUBE_SPACING_MM = 0.3
FILTERED_POINTS = (7000, 16000)


def centerline_inputs(mt):
    """Landmarks on branch 0 of the vendored RCA centerline and the tube
    cloud around it."""
    import numpy as np

    cl = mt.read_centerline_vtp(str(CL_VTP))
    branch0 = np.array([p.branch_id for p in cl.points]) == 0
    pos, rad = cl.positions()[branch0], cl.radii()[branch0]
    cum = np.concatenate([[0.0], np.cumsum(np.sqrt(((pos[1:] - pos[:-1]) ** 2).sum(-1)))])
    i = int(np.searchsorted(cum, CL_ARC_MM))
    side = np.cross(pos[i + 1] - pos[i - 1], [0.0, 0.0, 1.0])
    side *= rad[i] / np.linalg.norm(side)
    landmarks = (tuple(pos[i]), tuple(pos[i] + side), tuple(pos[i] - side))

    s = np.arange(0.0, cum[-1], TUBE_SPACING_MM)
    centre = np.stack([np.interp(s, cum, pos[:, k]) for k in range(3)], -1)
    radius = np.interp(s, cum, rad)
    t = np.gradient(centre, axis=0)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    a = np.cross(t, [0.0, 0.0, 1.0])
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = np.cross(t, a)
    rings = []
    for k in range(len(s)):
        n = max(3, int(round(2.0 * math.pi * radius[k] / TUBE_SPACING_MM)))
        ph = np.arange(n) * (2.0 * math.pi / n)
        rings.append(centre[k] + radius[k] * (np.cos(ph)[:, None] * a[k]
                                              + np.sin(ph)[:, None] * b[k]))
    return landmarks, np.concatenate(rings)


@contextlib.contextmanager
def recorded_refine(ca):
    """Record the packed inputs of each refine table a run evaluates."""
    seen = []
    table = ca.refine_table

    def spy(packed, K, dtype):
        seen.append((packed, K))
        return table(packed, K, dtype)

    ca.refine_table = spy
    try:
        yield seen
    finally:
        ca.refine_table = table


def nearest_exact_sq(a, b, k=8):
    """numpy's float64 squared Hausdorff of point sets a and b, its
    ``dx*dx + dy*dy`` taken over each point's k nearest neighbours
    (scipy's KD-tree picks them; the minimum is among them unless more than
    k points lie within rounding of it)."""
    import numpy as np
    from scipy.spatial import cKDTree

    def directed(x, y):
        _, idx = cKDTree(y).query(x, k=min(k, len(y)))
        idx = idx.reshape(len(x), -1)
        dx = x[:, None, 0] - y[idx, 0]
        dy = x[:, None, 1] - y[idx, 1]
        return (dx * dx + dy * dy).min(axis=1).max()

    return max(directed(a, b), directed(b, a))


def check_refine_table(torch, hb, dtype, packed, K):
    """The refine kernel against its plain version on the same CUDA tensors
    (equal bit for bit: both round every operation of d2, and min and max
    are exact); returns (max abs err, kernel ms, plain ms, (bound ms,
    bound by))."""
    import numpy as np

    dev = torch.device("cuda", 0)
    p, pmask, q, qmask = packed
    args = (torch.as_tensor(p, dtype=dtype, device=dev), torch.as_tensor(pmask, device=dev),
            torch.as_tensor(q, dtype=dtype, device=dev), torch.as_tensor(qmask, device=dev))
    k_out = hb.hausdorff_sq_shared_ref(*args, K).double().cpu().numpy()
    p_out = hb.hausdorff_sq_shared_ref_plain(*args, K).double().cpu().numpy()
    ms = cuda_ms(torch, lambda: hb.hausdorff_sq_shared_ref(*args, K), 5)
    plain_ms = cuda_ms(torch, lambda: hb.hausdorff_sq_shared_ref_plain(*args, K), 1)
    err = float(np.abs(k_out - p_out).max())
    pairs = 2.0 * p.shape[0] * p.shape[1] * q.shape[1]
    bound, by = refine_bound(torch, *args, K)
    tag = "f32" if dtype == torch.float32 else "f64"
    say("refine", f"{tag} table [S*K {p.shape[0]}, n {p.shape[1]}, m {q.shape[1]}]: "
                  f"kernel {ms:.3f} ms ({pairs / ms / 1e9:.2f} T point pairs/s), bound "
                  f"{bound:.3f} ms ({by}), {100.0 * bound / ms:.1f}% of bound, plain "
                  f"{plain_ms:.3f} ms, max |kernel-plain| {err:.3e}, "
                  f"{int((k_out == 0).sum())} zero entries")
    check(err == 0.0, f"{tag} refine kernel differs from plain")
    return err, ms, plain_ms, (bound, by)


def synthetic_refine_tables(S=5, K=31, n=11200, m=11100, seed=13):
    """Refine-shaped inputs from a seed (for ``--only kernel``): candidate
    sets and clouds around (200, -200) mm with ragged masks, one empty
    candidate."""
    import numpy as np

    rng = np.random.default_rng(seed)
    p = rng.normal(0.0, 6.0, (S * K, n, 2)) + [200.0, -200.0]
    q = rng.normal(0.0, 6.0, (S, m, 2)) + [200.0, -200.0]
    pmask = np.arange(n)[None, :] < rng.integers(n // 2, n + 1, S * K)[:, None]
    qmask = np.arange(m)[None, :] < rng.integers(m // 2, m + 1, S)[:, None]
    pmask[1] = False
    return (p, pmask, q, qmask), K


def phase_centerline(torch, hb, mt, pair_ab, profile=False):
    import numpy as np

    from multimodars_torch.ops import argmin_repair, sweep
    from multimodars_torch.ops.hausdorff_batch import hausdorff_sq_shared_ref
    from multimodars_torch.pipelines import centerline_align as ca
    from multimodars_torch.pipelines.centerline_align import exact_candidate_sq
    from multimodars_torch.utils import trace

    landmarks, cloud = centerline_inputs(mt)
    datas = full_inputs(mt)
    n_frames = len(pair_ab.geom_a.frames)
    resampled = ca.preprocess_centerline(mt.read_centerline_vtp(str(CL_VTP)),
                                         pair_ab.geom_a)
    ref_idx = resampled.find_reference_cl_point_idx(landmarks[0])
    check(ref_idx + n_frames + 2 < len(resampled.points),
          f"landmark index {ref_idx} + {n_frames} frames + 2 leaves the "
          f"{len(resampled.points)}-point centerline")

    def chain():
        out = quiet(mt.from_array_full, *datas, **FULL_ARGS)
        cl = mt.read_centerline_vtp(str(CL_VTP))
        aligned, _ = quiet(mt.align_three_point, cl, out[0], *landmarks)
        torch.cuda.synchronize()
        return out[0], aligned

    def combined():
        cl = mt.read_centerline_vtp(str(CL_VTP))
        out, _ = quiet(mt.align_combined, cl, pair_ab.geom_a, *landmarks, cloud)
        torch.cuda.synchronize()
        return out

    def counters():
        return {k: argmin_repair.stats.get(k, 0)
                for k in ("flagged", "repaired", "changed", "host_exact")}

    # the counted run: every launch count set to 0 just before it
    reset_counters(sweep, argmin_repair, trace)
    t0 = time.perf_counter()
    rest32, chain32 = chain()
    chain_s = time.perf_counter() - t0
    with recorded_refine(ca) as tables32:
        t0 = time.perf_counter()
        comb32 = combined()
        comb_s = time.perf_counter() - t0
    launches, sweep_launches = hb.launches, sweep.launches
    report32, stats32 = dict(ca.refine_report), counters()
    say("centerline", f"branch-0 landmark at {CL_ARC_MM} mm: resampled index {ref_idx} "
                      f"of {len(resampled.points)}; tube cloud {len(cloud)} points; "
                      f"refine grid {report32}")
    say("centerline", f"f32 first runs: north-star chain {chain_s:.3f} s, align_combined "
                      f"{comb_s:.3f} s; refine kernel launches {launches}, sweep "
                      f"launches {sweep_launches}, repair counters {stats32}")
    check(launches > 0, "the centerline path launched no refine kernel")
    check(FILTERED_POINTS[0] <= report32["m"] <= FILTERED_POINTS[1],
          f"the filtered cloud holds {report32['m']} points, not {FILTERED_POINTS}")

    for k in argmin_repair.stats:
        argmin_repair.stats[k] = 0
    with mt.config.use(dtype=torch.float64):
        rest64, chain64 = chain()
        with recorded_refine(ca) as tables64:
            comb64 = combined()
    report64, stats64 = dict(ca.refine_report), counters()
    d_rest = float(np.abs(pair_coords([rest32]) - pair_coords([rest64])).max())
    d_chain = float(np.abs(pair_coords([chain32]) - pair_coords([chain64])).max())
    d_comb = float(np.abs(lumen_coords(comb32) - lumen_coords(comb64)).max())
    say("centerline", f"f64 run: refine grid {report64}, repair counters {stats64}; "
                      f"f32 vs f64: winner (shift slot, angle slot) "
                      f"{report32['winner']} vs {report64['winner']}, max |coord diff| "
                      f"align_combined {d_comb:.3e} mm, north-star chain {d_chain:.3e} mm "
                      f"(its rest pair before align_three_point {d_rest:.3e} mm)")
    check(report32["winner"] == report64["winner"],
          "f32 and f64 refines chose different (shift, angle) winners")
    check(d_comb <= 1e-4 and d_chain <= 1e-4, "f32 and f64 centerline outputs differ")
    check(np.isfinite(lumen_coords(comb32)).all(), "align_combined output not finite")

    # align_three_point on the card and on the CPU (its search is host f64)
    with mt.config.use(device="cpu", dtype=torch.float64):
        cpu = quiet(mt.align_three_point, mt.read_centerline_vtp(str(CL_VTP)),
                    pair_ab, *landmarks)[0]
    gpu = quiet(mt.align_three_point, mt.read_centerline_vtp(str(CL_VTP)),
                pair_ab, *landmarks)[0]
    d_tp = float(np.abs(pair_coords([gpu]) - pair_coords([cpu])).max())
    say("centerline", f"align_three_point CUDA vs CPU max |coord diff| {d_tp:.3e} mm")
    check(d_tp <= 1e-9, "align_three_point differs between CUDA and the CPU")

    # the f64 kernel table of the winner's shift against numpy's
    (p, pmask, q, qmask), K = tables64[0]
    si = report64["winner"][0]
    dev = torch.device("cuda", 0)
    sl = slice(si * K, (si + 1) * K)
    table = hausdorff_sq_shared_ref(
        torch.as_tensor(p[sl], device=dev), torch.as_tensor(pmask[sl], device=dev),
        torch.as_tensor(q[si:si + 1], device=dev),
        torch.as_tensor(qmask[si:si + 1], device=dev), K,
    ).cpu().numpy()
    t0 = time.perf_counter()
    cloud_s = q[si][qmask[si]]
    near = np.array([nearest_exact_sq(p[c][pmask[c]], cloud_s)
                     for c in range(sl.start, sl.stop)])
    # two candidates (the winner and its neighbour) over every point pair
    ks = sorted({report64["winner"][1], (report64["winner"][1] + 1) % K})
    full = np.array([exact_candidate_sq(p[sl][k][pmask[sl][k]], cloud_s) for k in ks])
    same_near = bool(np.array_equal(table, near))
    same_full = bool(np.array_equal(table[ks], full))
    say("centerline", f"f64 kernel table of shift slot {si} vs numpy: equal bit for "
                      f"bit over its {K} candidates (8 nearest neighbours) {same_near}, "
                      f"over every pair of candidates {ks} {same_full} "
                      f"({time.perf_counter() - t0:.1f} s)")
    check(same_near and same_full, "f64 kernel table differs from numpy's")

    # the kernel against its plain version at the refine's real shapes
    res = [check_refine_table(torch, hb, dtype, *tables[0]) for dtype, tables in
           ((torch.float32, tables32), (torch.float64, tables64))]

    for name, fn in (("north-star chain", chain), ("align_combined", combined)):
        for _ in range(2):
            fn()
        trace.reset()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        say("centerline", f"{name} wall clock f32, median of 5 after 2 warm-ups: "
                          f"{sorted(times)[2]:.4f} s (runs {', '.join(f'{t:.4f}' for t in times)})")
        say("centerline", f"{name} spans per run, mean of those runs (s, calls): " + ", ".join(
            f"{k} {v[0] / 5:.4f} (x{v[1] // 5})"
            for k, v in sorted(trace.summary().items(), key=lambda kv: -kv[1][0])))
    if profile:
        profile_main_path(torch, chain, "north_star_profile.json")
        profile_main_path(torch, combined, "align_combined_profile.json")
    return launches, sweep_launches, dict(
        max_abs_err=max(r[0] for r in res), ms=res[0][1], plain_ms=res[0][2],
        bound_ms=res[0][3][0], bound_by=res[0][3][1])


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

COHORT_SEEDS = tuple(range(7, 23))


def phase_cohort(torch, sweep, rs, mt, profile=False):
    import numpy as np

    from bench import synthetic_oct_pullback
    from multimodars_torch.ops import argmin_repair
    from multimodars_torch.utils import trace

    datas = []
    for seed in COHORT_SEEDS:
        lumen, ref = synthetic_oct_pullback(OCT_FRAMES, OCT_POINTS, seed)
        datas.append(mt.numpy_to_inputdata(lumen, ref, True, label=f"case{seed}"))
    kw = dict(step_rotation_deg=FULL_STEP, range_rotation_deg=FULL_RANGE,
              sample_size=500, smooth=True)

    def run():
        out = quiet(mt.from_array_cohort, datas, **kw)
        torch.cuda.synchronize()
        return out

    # the counted run: every launch count set to 0 just before it
    reset_counters(sweep, argmin_repair, trace)
    with recorded_tables(sweep) as tables:
        t0 = time.perf_counter()
        cohort = run()
        first_s = time.perf_counter() - t0
    launches, masked = sweep.launches, sweep.masked_launches
    stats = {k: argmin_repair.stats.get(k, 0)
             for k in ("flagged", "repaired", "changed", "host_exact")}
    n_pairs = sum(len(logs) for _, logs, _ in cohort)
    say("cohort", f"from_array_cohort 16 x OCT-280 f32: {first_s:.3f} s (first run), "
                  f"{n_pairs} pairs, sweep launches {launches} ({masked} masked), "
                  f"repair counters {stats}")
    check(n_pairs == len(COHORT_SEEDS) * (OCT_FRAMES - 1), f"{n_pairs} pairs")
    check(launches > 0, "the cohort launched no sweep kernel")

    mismatched = 0
    for data, (geom, logs, _) in zip(datas, cohort):
        _, slogs = quiet(mt.from_array_single, data, write_obj=False, **kw)
        got = np.rint(np.array([l.rot_deg for l in logs]) / FULL_STEP)
        want = np.rint(np.array([l[2] for l in slogs]) / FULL_STEP)
        mismatched += int((got != want).sum())
        check(np.isfinite(lumen_coords(geom)).all(), "cohort output not finite")
    say("cohort", f"grid angles against from_array_single per case: "
                  f"{mismatched} of {n_pairs} pairs differ")
    check(mismatched == 0, "cohort and per-case singles land on different grid angles")
    report_tables(torch, sweep, "cohort", tables)
    # the cohort's dense lower bound against plain (the full path's table,
    # four times the pairs)
    lb = [(a, k) for a, k in tables if k.get("outer_stride_test", 1) > 1]
    check(len(lb) >= 1, "the cohort swept no lower-bound table")
    err, _, _ = check_table(torch, sweep, rs, "f32 dense cohort within stride 6",
                            lb[0][0], dict(dict(dense=False), **lb[0][1]), 1)

    for _ in range(2):
        run()
    trace.reset()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[2]
    say("cohort", f"wall clock f32, median of 5 after 2 warm-ups: {med:.4f} s = "
                  f"{len(COHORT_SEEDS) / med:.2f} pullbacks/s "
                  f"(runs {', '.join(f'{t:.4f}' for t in times)})")
    say("cohort", "spans per run, mean of those runs (s, calls): " + ", ".join(
        f"{k} {v[0] / 5:.4f} (x{v[1] // 5})"
        for k, v in sorted(trace.summary().items(), key=lambda kv: -kv[1][0])))
    if profile:
        profile_main_path(torch, run, "cohort_profile.json")
    return launches, err


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------

# the CCTA fusion benchmark's synthetic anomalous-RCA case at scale 3: the
# 57,606-vertex, 115,200-face clinical size of the reference's fullworkflow
# (CHANGELOG.md:30-38); built here from copies of the benchmark's helpers
CCTA_SCALE = 3
CCTA_VERTICES, CCTA_FACES = 57606, 115200
CCTA_RCA_P0 = (30.0, 0.0, 14.0)
CCTA_RCA_P1 = (22.0, -2.0, -8.0)
# FP operations per point pair: the count's d2 (3 sub, 3 mul, 2 add) and 2
# compare-accumulates; the nearest pick's d2, a min, a select and a
# runner-up update; the sweep's one d2 per (offset, pair) serving both
# directions and its two minima
CCTA_OPS_PER_PAIR = {"radius_count": 10, "nearest": 11, "morph_sweep": 10}
CCTA_REPLACES = {
    "radius_count": "multimodars_tpu/ccta/kernels.py:95",
    "nearest": "multimodars_tpu/ccta/kernels.py:73",
    "morph_sweep": "multimodars_tpu/ccta/kernels.py:2183",
}
# the wrappers a run calls, each with its kernel: one pair, or a batch of
# pairs in one launch
CCTA_WRAPPERS = {
    "radius_count": "radius_count", "radius_count_batch": "radius_count",
    "nearest": "nearest", "nearest_batch": "nearest", "morph_sweep": "morph_sweep",
    "morph_sweep_batch": "morph_sweep",
}
# the case's certification work, (rows, flagged, changed) per primitive of
# ccta.kernels.stats: what every run of this case has shown, in float32 and,
# where the float64 run's rows may differ (fewer sweep offsets re-evaluated),
# (flagged, changed) in float64
CCTA_CERTIFICATION_F32 = {"radius_count": (198050, 86, 48), "nearest": (70322, 567, 246),
                          "morph_sweep": (123, 3, 0)}
CCTA_CERTIFICATION_F64 = {"radius_count": (0, 0), "nearest": (432, 2)}
# count launches of one run: 3 count calls of 2 pairs, 3 flags calls
CCTA_COUNT_LAUNCHES_MAX = 6
# morph-sweep launches of one run: the scale stage's three sweeps in one
CCTA_SWEEP_LAUNCHES_MAX = 1


def _basis_from_tangent(t):
    import numpy as np

    t = t / np.linalg.norm(t)
    helper = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(t, helper)) > 0.9:
        helper = np.array([0.0, 1.0, 0.0])
    u = np.cross(t, helper)
    u /= np.linalg.norm(u)
    v = np.cross(t, u)
    return u, v


def _tube_mesh(mesh_cls, centers, radius, n_ring):
    """Closed triangulated tube along a polyline of ring centers."""
    import numpy as np

    centers = np.asarray(centers, dtype=np.float64)
    n_slices = len(centers)
    verts = []
    for i, c in enumerate(centers):
        if i == 0:
            t = centers[1] - centers[0]
        elif i == n_slices - 1:
            t = centers[-1] - centers[-2]
        else:
            t = centers[i + 1] - centers[i - 1]
        u, v = _basis_from_tangent(t)
        for k in range(n_ring):
            th = 2.0 * math.pi * k / n_ring
            verts.append(c + radius * (math.cos(th) * u + math.sin(th) * v))
    faces = []
    for i in range(n_slices - 1):
        a0, b0 = i * n_ring, (i + 1) * n_ring
        for k in range(n_ring):
            k1 = (k + 1) % n_ring
            faces.append([a0 + k, b0 + k, b0 + k1])
            faces.append([a0 + k, b0 + k1, a0 + k1])
    verts = np.asarray(verts)
    faces = np.asarray(faces, dtype=np.int64)
    start_c = len(verts)
    verts = np.vstack([verts, centers[0], centers[-1]])
    last0 = (n_slices - 1) * n_ring
    cap = []
    for k in range(n_ring):
        k1 = (k + 1) % n_ring
        cap.append([start_c, k1, k])
        cap.append([start_c + 1, last0 + k, last0 + k1])
    return mesh_cls(verts, np.vstack([faces, np.asarray(cap, dtype=np.int64)]))


def _line(p0, p1, n):
    import numpy as np

    return np.linspace(np.asarray(p0, float), np.asarray(p1, float), n)


def ccta_case(mt):
    """(mesh, aorta / RCA / LCA centerline arrays, IV geometry) of the
    benchmark's build_case(CCTA_SCALE)."""
    import numpy as np

    scale = CCTA_SCALE
    from multimodars_torch.ccta.mesh import Mesh, concatenate

    mesh = concatenate([
        _tube_mesh(Mesh, _line((36, 0, 0), (36, 0, 20), 40 * scale), 6.0, 64 * scale),
        _tube_mesh(Mesh, _line(CCTA_RCA_P0, CCTA_RCA_P1, 60 * scale), 1.4, 32 * scale),
        _tube_mesh(Mesh, _line((42, 0, 14), (50, 2, -8), 60 * scale), 1.4, 32 * scale),
    ])
    mesh.fix_normals()  # what read_geometrical.read_mesh does on load
    cl_ao = _line((36, 0, 20), (36, 0, 0), 50)
    cl_rca = _line(CCTA_RCA_P0, CCTA_RCA_P1, 60)
    cl_lca = _line((42, 0, 14), (50, 2, -8), 60)
    p0, p1 = np.asarray(CCTA_RCA_P0), np.asarray(CCTA_RCA_P1)
    axis = p1 - p0
    u, v = _basis_from_tangent(axis)
    lumen_rows, wall_rows = [], []
    n_pts = 64 * scale
    for f, t in enumerate(np.linspace(0.42, 0.62, 12)):
        c = p0 + t * axis
        for k in range(n_pts):
            th = 2.0 * math.pi * k / n_pts
            d = math.cos(th) * u + math.sin(th) * v
            lumen_rows.append([f, *(c + 1.2 * d)])
            wall_rows.append([f, *(c + 1.7 * d)])
    geom = mt.numpy_to_geometry(np.asarray(lumen_rows), wall_arr=np.asarray(wall_rows),
                                label="iv")
    geom.frames[0].lumen.aortic_thickness = 1.0
    return mesh, cl_ao, cl_rca, cl_lca, geom


@contextlib.contextmanager
def recorded_scalings(manipulating):
    """Record the scalings the scale stage finds (proximal, distal, aortic)
    as its finishes resolve them."""
    seen = []
    dp = manipulating.find_distal_and_proximal_scaling_finish
    ao = manipulating.find_aorta_scaling_finish

    def spy_dp(*args, **kwargs):
        out = dp(*args, **kwargs)
        seen.extend(out)
        return out

    def spy_ao(*args, **kwargs):
        out = ao(*args, **kwargs)
        seen.append(out)
        return out

    manipulating.find_distal_and_proximal_scaling_finish = spy_dp
    manipulating.find_aorta_scaling_finish = spy_ao
    try:
        yield seen
    finally:
        manipulating.find_distal_and_proximal_scaling_finish = dp
        manipulating.find_aorta_scaling_finish = ao


@contextlib.contextmanager
def recorded_ccta_calls():
    """Record the arguments of every call of the CCTA kernel wrappers, the
    batched entries included."""
    from multimodars_torch.ops import morph_sweep, nearest, radius_count

    seen = []
    mods = {"radius_count": radius_count, "nearest": nearest, "morph_sweep": morph_sweep}
    saved = [(mods[kernel], name, getattr(mods[kernel], name))
             for name, kernel in CCTA_WRAPPERS.items()]
    for mod, name, fn in saved:
        def spy(*args, _fn=fn, _name=name, **kwargs):
            seen.append((_name, args, kwargs))
            return _fn(*args, **kwargs)
        setattr(mod, name, spy)
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def recorded_rays():
    """Record (rays, faces) of every call of the occlusion pass's ray test
    (``io.native.ray_occlusion_native``, which the pass calls first)."""
    from multimodars_torch.io import native

    seen = []
    fn = native.ray_occlusion_native

    def spy(origins, directions, tris, *args, **kwargs):
        seen.append((len(origins), len(tris)))
        return fn(origins, directions, tris, *args, **kwargs)

    native.ray_occlusion_native = spy
    try:
        yield seen
    finally:
        native.ray_occlusion_native = fn


def ccta_run(torch, mt, case):
    """label -> scale -> stitch with the benchmark's arguments (and its
    fix-up of an empty rca_removed_points); returns (region index arrays of
    the labelled and scaled results, scalings, stitched mesh)."""
    import numpy as np

    from multimodars_torch.ccta import manipulating, regions

    mesh, cl_ao, cl_rca, cl_lca, geom = case
    with recorded_scalings(manipulating) as scalings:
        results, (rca_cl, _lca_cl, ao_cl) = quiet(
            mt.label, mesh.copy(), cl_ao, cl_rca, cl_lca, aligned_frames=geom.frames,
            anomalous_rca=True, control_plot=False,
        )
        if not results["rca_removed_points"]:
            ao = np.asarray(results["aorta_points"])
            near = np.linalg.norm(ao - np.asarray(CCTA_RCA_P0), axis=1) < 5.0
            results["rca_removed_points"] = [tuple(p) for p in ao[near][:100]]
        labelled = {k: regions.get_idx(results, k) for k in regions.REGION_KEYS if k in results}
        scaled = quiet(mt.scale, results, rca_cl, ao_cl, geom.frames)
        scaled_idx = {k: regions.get_idx(scaled, k) for k in regions.REGION_KEYS if k in scaled}
        stitched = quiet(mt.stitch, scaled, geom, region_remove=("anomalous_points",),
                         prox_start_mode="nearest_iv", dist_start_mode="nearest_iv",
                         n_points_iv_cont=64 * CCTA_SCALE)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return labelled, scaled_idx, list(scalings), stitched["mesh"]


def morph_sets(name, args):
    """(points, reference, K) of every sweep one morph-sweep call evaluates."""
    if name == "morph_sweep_batch":
        points, _unit, ref, _xs, sweeps = args
        return [(points[p:p + n], ref[r:r + m], K) for p, n, r, m, K in sweeps]
    points, _unit, ref, xs = args
    return [(points, ref, xs.shape[0])]


def ccta_sets(name, args):
    """The (a, b) point sets of every pair one call evaluates: its own two,
    or each pair of a batch."""
    if name.endswith("_batch"):
        a, b, pairs = args[:3]
        return [(a[p[0]:p[0] + p[1]], b[p[2]:p[2] + p[3]]) for p in pairs]
    return [(args[0], args[1])]


def ccta_flags(name, args, kwargs):
    if name == "radius_count":
        return bool(kwargs.get("flags", len(args) > 4 and args[4]))
    if name == "radius_count_batch":
        return bool(kwargs.get("flags", len(args) > 3 and args[3]))
    return False


def ccta_pairs(name, args, kwargs):
    """Point pairs one kernel call evaluates (offsets x pairs for the sweep)."""
    if CCTA_WRAPPERS[name] == "morph_sweep":
        return sum(p.shape[0] * r.shape[0] * K for p, r, K in morph_sets(name, args))
    return sum(a.shape[0] * b.shape[0] for a, b in ccta_sets(name, args))


def ccta_bound(torch, name, args, kwargs):
    """(bound ms, "operations" or "bytes") of one kernel call: its FP
    operations over the card's lanes, or its bytes (inputs once, outputs
    once) over the memory rate."""
    kernel = CCTA_WRAPPERS[name]
    e = args[0].element_size()
    if kernel == "morph_sweep":
        # points and units, references and the offsets read once; fwd and
        # bwd written once
        sets = morph_sets(name, args)
        nbytes = (sum((2 * p.shape[0] + r.shape[0]) * 3 * e + 2 * K * e for p, r, K in sets)
                  + max(K for _, _, K in sets) * e)
    else:
        flag_bytes = 4 if name.endswith("_batch") else 1  # int32 words, or uint8
        out_row = (2 * e + 8 if kernel == "nearest"
                   else flag_bytes if ccta_flags(name, args, kwargs) else 8)
        nbytes = sum((a.shape[0] + b.shape[0]) * 3 * e + a.shape[0] * out_row
                     for a, b in ccta_sets(name, args))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops_s = (CCTA_OPS_PER_PAIR[kernel] * ccta_pairs(name, args, kwargs)
             / (sms * FP_LANES_PER_SM[e] * MAX_SM_CLOCK_HZ))
    bytes_s = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s else "bytes")


def ccta_key(torch, name, args, kwargs):
    dt = "f64" if args[0].dtype == torch.float64 else "f32"
    if CCTA_WRAPPERS[name] == "morph_sweep":
        shapes = " + ".join(f"[{p.shape[0]}] x [{r.shape[0]}] x {K}"
                            for p, r, K in morph_sets(name, args))
    else:
        shapes = " + ".join(f"[{a.shape[0]}] x [{b.shape[0]}]" for a, b in ccta_sets(name, args))
    flags = " flags" if ccta_flags(name, args, kwargs) else ""
    return f"{name} {dt} {shapes}{flags}"


def check_ccta_call(torch, name, args, kwargs, plain_reps=1):
    """One kernel call against its plain version on the same inputs:
    counts, flags and nearest picks equal exactly (minima are exact in both
    dtypes; a batch's whole output buffer bit for bit), sweep sums equal to
    the kernel-ordered plain sums exactly and to plain's own order within
    rel 1e-12 (f64) / 1e-4 (f32).  Returns (max abs error against plain,
    kernel ms, plain ms)."""
    import numpy as np

    from multimodars_torch.ops import morph_sweep, nearest, radius_count

    mod = {"radius_count": radius_count, "nearest": nearest,
           "morph_sweep": morph_sweep}[CCTA_WRAPPERS[name]]
    plain = {"radius_count": radius_count.radius_count_plain,
             "radius_count_batch": radius_count.radius_count_batch_plain,
             "nearest": nearest.nearest_plain,
             "nearest_batch": nearest.nearest_batch_plain,
             "morph_sweep": morph_sweep.morph_sweep_plain,
             "morph_sweep_batch": morph_sweep.morph_sweep_batch_plain}[name]
    kernel = getattr(mod, name)
    if name == "radius_count" and args[0].dtype == torch.float32:
        # the wrapper rounds the band edges to float32; plain gets the same
        r2lo, r2hi = (float(torch.tensor(v, dtype=torch.float32)) for v in args[2:4])
        plain_args = (args[0], args[1], r2lo, r2hi, *args[4:])
    else:
        plain_args = args
    saved = mod.launches
    got = kernel(*args, **kwargs)
    want = plain(*plain_args, **kwargs)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    if CCTA_WRAPPERS[name] == "morph_sweep":
        if name == "morph_sweep_batch":
            f64 = args[0].dtype == torch.float64
            plans = morph_sweep.launch_plan(args[4], args[0].device, f64)
            ordered = (morph_sweep.morph_sweep_batch_ordered(*args, plans),)
        else:
            ordered = morph_sweep.morph_sweep_ordered(*args)
        rtol = 1e-12 if args[0].dtype == torch.float64 else 1e-4
        for g, o, w in zip(got, ordered, want):
            check(torch.equal(g, o), f"{name}: kernel sums differ from its order's plain sums")
            g, w = g.double().cpu().numpy(), w.double().cpu().numpy()
            err = max(err, float(np.abs(g - w).max()))
            check(np.allclose(g, w, rtol=rtol, atol=0.0), f"{name}: sums beyond rel {rtol}")
    else:
        for g, w in zip(got, want):
            check(torch.equal(g.cpu(), w.cpu()), f"{name}: kernel differs from plain")
    ms = cuda_ms(torch, lambda: kernel(*args, **kwargs), 5)
    mod.launches = saved  # launches made to compare with plain do not count
    pms = cuda_ms(torch, lambda: plain(*plain_args, **kwargs), plain_reps)
    return err, ms, pms


def report_ccta_calls(torch, calls, launches):
    """Check and time each distinct wrapper call of the counted run; print
    each one's ms, bound, share and calls per run.  Returns per kernel the
    numbers of its largest call (by bound) and its max abs error."""
    groups = {}
    for name, args, kwargs in calls:
        key = ccta_key(torch, name, args, kwargs)
        groups.setdefault(key, [name, args, kwargs, 0])[3] += 1
    out = {}
    per_run = {}
    for key, (name, args, kwargs, n) in sorted(groups.items()):
        kernel = CCTA_WRAPPERS[name]
        pairs = ccta_pairs(name, args, kwargs)
        err, ms, pms = check_ccta_call(torch, name, args, kwargs,
                                       plain_reps=1 if pairs > 5e7 else 3)
        bound, by = ccta_bound(torch, name, args, kwargs)
        say("ccta-tables", f"{key}: {n} call(s) per run, kernel {ms:.4f} ms, plain "
                           f"{pms:.3f} ms, bound {bound:.5f} ms ({by}), "
                           f"{100.0 * bound / ms:.1f}% of bound, {pairs:.3e} pairs")
        row = per_run.setdefault(kernel, [0.0, 0.0, 0])
        row[0] += ms * n
        row[1] += bound * n
        row[2] += n
        best = out.get(kernel)
        if best is None or bound > best["bound_ms"]:
            out[kernel] = dict(ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by, name=name,
                               args=args, shape=key, max_abs_err=0.0)
        out[kernel]["max_abs_err"] = max(out[kernel]["max_abs_err"], err)
    for kernel, (ms, bound, n) in sorted(per_run.items()):
        say("ccta-tables", f"{kernel}: {n} calls ({launches.get(kernel, 0)} launches) per run, "
                           f"kernel {ms:.4f} ms, bound {bound:.5f} ms, "
                           f"{100.0 * bound / ms:.1f}% of bound (card after: {card_state()})")
    # the nearest pick's yardstick: one PyTorch call on the largest pair of
    # its largest call
    a, b = max(ccta_sets(out["nearest"]["name"], out["nearest"]["args"]),
               key=lambda ab: ab[0].shape[0] * ab[1].shape[0])
    a, b = a.contiguous(), b.contiguous()
    out["nearest"]["library_ms"] = cuda_ms(
        torch, lambda: torch.cdist(a, b).pow(2).min(1), 5)
    say("ccta-tables", f"nearest yardstick torch.cdist(a, b).pow(2).min(1) on "
                       f"[{a.shape[0]}] x [{b.shape[0]}] of {out['nearest']['shape']}: "
                       f"{out['nearest']['library_ms']:.4f} ms")
    # and on a morph's pick: the most rows against a centerline-sized set
    picks = [ab for name, args, _ in calls if CCTA_WRAPPERS[name] == "nearest"
             for ab in ccta_sets(name, args) if ab[1].shape[0] <= 64]
    if picks:
        a, b = (x.contiguous() for x in max(picks, key=lambda ab: ab[0].shape[0]))
        ms = cuda_ms(torch, lambda: torch.cdist(a, b).pow(2).min(1), 5)
        say("ccta-tables", f"morph pick yardstick torch.cdist(a, b).pow(2).min(1) on "
                           f"[{a.shape[0]}] x [{b.shape[0]}]: {ms:.4f} ms")
    return out


def synthetic_ccta_calls(torch):
    """Kernel calls at phase 8's shapes on seeded inputs, f32 and f64: the
    island count (18,864 x 21,587 within 2 mm) and a seeded larger one
    (17,000 x 40,000), the bounded flags (57,606 x 60), the region pick
    (4,036 x 576) and a morph's pick (26,449 x 50), a sweep (750 x 576 x
    41), and the batched entries: the island count with its self-count in
    one launch, a symmetric pair of picks in one launch, and the scale
    stage's three sweeps (1,009 x 576, 1,009 x 384, 1,709 x 96, x 41) in
    one launch."""
    import numpy as np

    rng = np.random.default_rng(5)
    dev = torch.device("cuda", 0)
    calls = []
    for dtype in (torch.float32, torch.float64):
        def t(shape, scale=12.0):
            return torch.tensor(rng.standard_normal(shape) * scale, dtype=dtype, device=dev)
        unit = torch.nn.functional.normalize(t((750, 3)), dim=1)
        xs = torch.tensor(-2.0 + 0.1 * np.arange(41), dtype=dtype, device=dev)
        stage = [(1009, 576), (1009, 384), (1709, 96)]
        s_pts, s_ref = t((3727, 3)), t((1056, 3))
        s_unit = torch.nn.functional.normalize(t((3727, 3)), dim=1)
        sweeps, po, ro = [], 0, 0
        for n, m in stage:
            sweeps.append((po, n, ro, m, 41))
            po, ro = po + n, ro + m
        island = t((18864 + 21587, 3))
        picks = t((4036 + 576, 3))
        calls += [
            ("radius_count", (island[:18864], island[18864:], 3.999, 4.001), {}),
            ("radius_count", (t((17000, 3)), t((40000, 3)), 3.999, 4.001), {}),
            ("radius_count", (t((57606, 3)), t((60, 3)), 8.999, 9.001), {"flags": True}),
            ("radius_count_batch", (island, island, [(0, 18864, 18864, 21587, 3.999, 4.001),
                                                     (0, 18864, 0, 18864, 3.999, 4.001)]), {}),
            ("nearest", (picks[:4036], picks[4036:]), {}),
            ("nearest", (t((26449, 3)), t((50, 3))), {}),
            ("nearest_batch", (picks, picks, [(0, 4036, 4036, 576), (4036, 576, 0, 4036)]), {}),
            ("morph_sweep", (t((750, 3)), unit, t((576, 3)), xs), {}),
            ("morph_sweep_batch", (s_pts, s_unit, s_ref, xs, sweeps), {}),
        ]
    return calls


def phase_ccta(torch, mt, profile=False):
    import numpy as np

    from multimodars_torch.ccta import kernels as ck
    from multimodars_torch.ops import morph_sweep, nearest, radius_count
    from multimodars_torch.utils import trace

    t0 = time.perf_counter()
    case = ccta_case(mt)
    mesh = case[0]
    say("ccta", f"case built in {time.perf_counter() - t0:.2f} s: "
                f"{len(mesh.vertices)} vertices, {len(mesh.faces)} faces, "
                f"{len(case[4].frames)} IV frames x {len(case[4].frames[0].lumen.points)} points")
    check((len(mesh.vertices), len(mesh.faces)) == (CCTA_VERTICES, CCTA_FACES),
          "the case is not the 57,606-vertex benchmark mesh")
    mods = {"radius_count": radius_count, "nearest": nearest, "morph_sweep": morph_sweep}

    # the counted run: every launch count set to 0 just before it
    for mod in mods.values():
        mod.launches = 0
    ck.reset_stats()
    trace.reset()
    with recorded_ccta_calls() as calls, recorded_rays() as rays:
        t0 = time.perf_counter()
        run32 = ccta_run(torch, mt, case)
        first_s = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in mods.items()}
    stats32 = {k: dict(v) for k, v in ck.stats.items()}
    say("ccta", f"f32 first run {first_s:.3f} s; launches {launches}; "
                f"certification {stats32}")
    for name, n in launches.items():
        check(n > 0, f"the CCTA path launched no {name} kernel")
    check(launches["radius_count"] <= CCTA_COUNT_LAUNCHES_MAX,
          f"{launches['radius_count']} count launches in one run, more than "
          f"{CCTA_COUNT_LAUNCHES_MAX}")
    check(launches["morph_sweep"] <= CCTA_SWEEP_LAUNCHES_MAX,
          f"{launches['morph_sweep']} morph-sweep launches in one run, more than "
          f"{CCTA_SWEEP_LAUNCHES_MAX}")
    sweep_calls = [args[4] if name == "morph_sweep_batch" else [args]
                   for name, args, _ in calls if CCTA_WRAPPERS[name] == "morph_sweep"]
    check(len(sweep_calls) == 1 and len(sweep_calls[0]) == 3,
          f"the scale stage's sweeps went in {len(sweep_calls)} call(s), not one call of three")
    say("ccta", "occlusion ray tests (rays x faces = pairs; ROADMAP B6's kernel is due above "
                "1e9): " + ", ".join(f"{r} x {f} = {r * f:.4e}" for r, f in rays))
    got32 = {k: (v["rows"], v["flagged"], v["changed"]) for k, v in stats32.items()}
    check(got32 == CCTA_CERTIFICATION_F32,
          f"f32 certification {got32}, expected {CCTA_CERTIFICATION_F32}")
    sizes = {k: len(v) for k, v in run32[1].items()}
    say("ccta", f"regions after scale: {sizes}; scalings (proximal, distal, aortic) "
                f"{run32[2]}; stitched {len(run32[3].vertices)} vertices, "
                f"{len(run32[3].faces)} faces")
    check(np.isfinite(run32[3].vertices).all() and len(run32[3].faces) > 0,
          "the stitched mesh is empty or not finite")
    check(all(np.isfinite(x) for x in run32[2]) and len(run32[2]) == 3,
          f"scalings {run32[2]}")

    ck.reset_stats()
    with mt.config.use(dtype=torch.float64):
        run64 = ccta_run(torch, mt, case)
    stats64 = {k: dict(v) for k, v in ck.stats.items()}
    t0 = time.perf_counter()
    with mt.config.use(device="cpu", dtype=torch.float64):
        run_cpu = ccta_run(torch, mt, case)
    cpu_s = time.perf_counter() - t0
    for other, label in ((run64, "f64 card"), (run_cpu, "f64 CPU")):
        same_regions = all(
            a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
            for a, b in ((run32[0], other[0]), (run32[1], other[1])))
        d = (float(np.abs(run32[3].vertices - other[3].vertices).max())
             if run32[3].vertices.shape == other[3].vertices.shape else float("inf"))
        same_faces = np.array_equal(run32[3].faces, other[3].faces)
        say("ccta", f"f32 card vs {label}: same region index sets {same_regions}, "
                    f"scalings {run32[2]} vs {other[2]}, same stitched faces {same_faces}, "
                    f"max |stitched vertex diff| {d:.3e} mm")
        check(same_regions, f"f32 card and {label} label different regions")
        check(run32[2] == other[2], f"f32 card and {label} find different scalings")
        check(same_faces and d == 0.0, f"f32 card and {label} stitch different meshes")
    say("ccta", f"f64 card certification {stats64}; f64 CPU run {cpu_s:.3f} s")
    got64 = {k: (stats64[k]["flagged"], stats64[k]["changed"]) for k in CCTA_CERTIFICATION_F64}
    check(got64 == CCTA_CERTIFICATION_F64,
          f"f64 certification {got64}, expected {CCTA_CERTIFICATION_F64}")

    kres = report_ccta_calls(torch, calls, launches)
    # the f64 kernels against plain on the f64 run's own inputs
    with mt.config.use(dtype=torch.float64), recorded_ccta_calls() as calls64:
        saved = {name: mod.launches for name, mod in mods.items()}
        ccta_run(torch, mt, case)
        for name, mod in mods.items():
            mod.launches = saved[name]
    seen = set()
    for name, args, kwargs in calls64:
        key = ccta_key(torch, name, args, kwargs)
        if key in seen:
            continue
        seen.add(key)
        err, _, _ = check_ccta_call(torch, name, args, kwargs, plain_reps=1)
        kernel = CCTA_WRAPPERS[name]
        kres[kernel]["max_abs_err"] = max(kres[kernel]["max_abs_err"], err)
    say("ccta", f"f64 kernels against plain on {len(seen)} distinct f64 calls: equal "
                f"(counts and picks exactly, sums to rel 1e-12)")

    def run():
        return ccta_run(torch, mt, case)

    for _ in range(2):
        run()
    trace.reset()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[2]
    say("ccta", f"label -> scale -> stitch wall clock f32, median of 5 after 2 warm-ups: "
                f"{med:.4f} s (runs {', '.join(f'{t:.4f}' for t in times)})")
    say("ccta", "spans per run, mean of those runs (s, calls): " + ", ".join(
        f"{k} {v[0] / 5:.4f} (x{v[1] // 5})"
        for k, v in sorted(trace.summary().items(), key=lambda kv: -kv[1][0])))
    if profile:
        by_name = profile_main_path(torch, run, "ccta_profile.json")
        for kernel in mods:
            us = sum(v[0] for k, v in by_name.items() if f"{kernel}_kernel" in k)
            count = sum(v[1] for k, v in by_name.items() if f"{kernel}_kernel" in k)
            say("profile", f"{kernel}: {count} launches in the profiled run, device "
                           f"{us / 1e3:.4f} ms, {us / 1e3 / max(count, 1):.4f} ms a launch")
        for key, (us, count) in sorted(by_name.items()):
            if key.startswith("Memcpy"):
                say("profile", f"{key}: {count} copies in the profiled run, {us / 1e3:.4f} ms")
    return launches, kres


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["kernel"], default=None,
                    help="stop after the kernel phase")
    ap.add_argument("--profile", action="store_true",
                    help="profile one steady run of each main path (torch.profiler)")
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
    from multimodars_torch.ops import hausdorff_batch as hb
    from multimodars_torch.ops import morph_sweep, nearest, radius_count
    from multimodars_torch.ops import rotation_search as rs
    from multimodars_torch.ops import sweep

    # a failed check raises SmokeFailure out of main(): the traceback names
    # the phase and the process exits non-zero
    phase_environment(torch, sweep, hb, (radius_count, nearest, morph_sweep))
    kres = phase_kernel(torch, sweep, rs)
    launches = hb_launches = None
    if args.only == "kernel":
        res = [check_refine_table(torch, hb, dtype, *synthetic_refine_tables())
               for dtype in (torch.float32, torch.float64)]
        hres = dict(max_abs_err=max(r[0] for r in res), ms=res[0][1],
                    plain_ms=res[0][2], bound_ms=res[0][3][0], bound_by=res[0][3][1])
        ccta_launches = {}
        cres = report_ccta_calls(torch, synthetic_ccta_calls(torch), ccta_launches)
    else:
        launches, _ = phase_main_path(torch, sweep, mt, args.profile)
        phase_cross_device(torch, mt)
        full_launches, clouds, pair_ab = phase_full_path(torch, sweep, mt, args.profile)
        launches += full_launches
        kres["max_abs_err"] = max(
            kres["max_abs_err"], phase_full_kernel(torch, sweep, rs, mt, clouds[:2])
        )
        phase_full_cross_device(torch, mt)
        hb_launches, chain_launches, hres = phase_centerline(
            torch, hb, mt, pair_ab, args.profile)
        launches += chain_launches
        cohort_launches, err = phase_cohort(torch, sweep, rs, mt, args.profile)
        launches += cohort_launches
        kres["max_abs_err"] = max(kres["max_abs_err"], err)
        ccta_launches, cres = phase_ccta(torch, mt, args.profile)
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
        "bound_ms": kres["bound_ms"],
        "bound_by": kres["bound_by"],
        # no single PyTorch call computes this table
        "library_ms": None,
    }, {
        "name": "hausdorff_batch",
        "route": "cuda",
        "source": "multimodars_torch/csrc/hausdorff_batch.cu",
        "replaces": "multimodars_tpu/pipelines/centerline_align.py:515",
        "launches": hb_launches,
        "max_abs_err": hres["max_abs_err"],
        "ms": hres["ms"],
        "plain_ms": hres["plain_ms"],
        "bound_ms": hres["bound_ms"],
        "bound_by": hres["bound_by"],
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"multimodars_torch/csrc/{name}.cu",
        "replaces": CCTA_REPLACES[name],
        "launches": ccta_launches.get(name),
        "max_abs_err": cres[name]["max_abs_err"],
        "ms": cres[name]["ms"],
        "plain_ms": cres[name]["plain_ms"],
        "bound_ms": cres[name]["bound_ms"],
        "bound_by": cres[name]["bound_by"],
        # no single PyTorch call computes the counts or the sweep;
        # torch.cdist(a, b).pow(2).min(1) is the nearest pick's yardstick
        "library_ms": cres[name].get("library_ms"),
    } for name in ("radius_count", "nearest", "morph_sweep")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
