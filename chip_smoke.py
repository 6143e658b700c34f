#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``multimodars_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

It builds the hand-written kernels from ``multimodars_torch/csrc`` (the
rotation sweep's cost table, the centerline refine's Hausdorff table, and
the CCTA toolkit's radius count, nearest pick, morph sweep and ray-triangle
hits; one ``nvcc`` each, started together), holds each against its plain
PyTorch version at the shapes the main paths give it, drives the port's
single-pullback path
(``from_array_single`` on a 280-frame, 500-point pullback at step 0.01 deg /
range 6 deg, the reference's headline protocol) and its four-phase path
(``from_array_full`` on four such pullbacks at the canonical step 0.5 deg /
range 90 deg), its centerline registration, its cohort entry, its CCTA
mesh fusion and its multi-device execution, and checks what comes out.
Phases:

1. environment: card name and power limit, torch/CUDA versions, kernel builds
2. kernel against plain on the card: masked/dense, outer strides 1 and 6,
   f32 and f64; f64 within rtol 1e-12 with equal argmins, f32 within
   ``KERNEL_PLAIN_F32_UNITS``; the f32 divergence from f64 in those units;
   times
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
   shapes (with its device time, launch plan and both bounds: 7 operations
   a valid unordered pair, and the 5 a directed pair of earlier checkouts),
   wall clock (median of 5 after 2 warm-ups) and spans
7. the cohort entry on the card: ``from_array_cohort`` on 16 OCT-280
   pullbacks (4464 pairs in one batch) at step 0.5 deg / range 90 deg in
   f32: the same grid angle in every pair as ``from_array_single`` per
   case, launches counted, pullbacks/s (median of 5 after 2 warm-ups)
8. CCTA mesh fusion on the card: ``label`` -> ``scale`` -> ``stitch`` with
   the CCTA fusion benchmark's arguments on its synthetic anomalous-RCA
   case at scale 3 (57,606 vertices, 115,200 faces), in f32 (launches of
   the radius count, nearest pick, morph sweep and ray kernels counted, the
   scale stage's three sweeps in one batched call and launch, the
   certification counts of ``ccta.kernels.stats``), in f64 on the card and
   in f64 on the CPU: the same region index sets and scalings and the same
   stitched mesh (0.0 mm) in all three; each kernel against its plain
   version on the run's recorded inputs, f32 and f64, with ms, bound, share
   and calls per run; wall clock (median of 5 after 2 warm-ups) and spans;
   then the vessel-tree discretization on the same case: ``label`` ->
   ``prepare_centerlines`` -> ``discretize_vessel_tree`` at the defaults
   without and with the B-spline refit, the launches of each step counted
   (one bounded-flags count launch per branch, one nearest launch per tree
   for up to 8 walks), region sizes, anchors per walk, contour counts and
   reference triplets printed, f32 card = f64 card = f64 CPU exactly, the
   recorded calls against plain, wall clock and spans; then the same path
   on the benchmark's scale-5 case (160,006 vertices, 320,000 faces) in
   f32 and f64 on the card and f64 on the CPU (the same regions, scalings
   and stitched mesh), launches and certification counted, each kernel
   against plain on the run's calls, the ray pass's two routes timed whole
   on its rays and the route ``_RAY_NATIVE_THRESHOLD`` picks, wall clock
   (median of 3 after 1 warm-up); and a vessel tree with six side branches
   (9 walks, past the 8 of one nearest launch): nearest launches a tree
   equal to ceil(walks / 8), the batched pick equal to each walk picked
   alone on the card, f32 card = f64 card = f64 CPU exactly
9. multi-device execution on meshes naming the card 1, 2 and 4 times (one
   CUDA stream a shard; every card too where there are several):
   ``from_array_cohort(devices=...)`` on phase 7's cohort (the same angles
   and coordinates as ``devices=None``, sweep launches per shard,
   pullbacks/s per mesh); ``sharded_multires_search`` on OCT-280's 279
   within pairs at step 0.01 deg / range 6 deg, the ladder and the brute
   force (K 1202), f32 and f64 (the same bits on every mesh and in both
   dtypes, equal to the repaired unsharded search, flags and repairs), and
   the brute-force table's ms; ``sharded_count_within_radius`` at phase
   8's island count shapes (equal to the unsharded count); phase 8's
   ``label`` -> ``scale`` -> ``stitch`` under ``shard_rows_over`` with the
   ray kernel's route forced at every size (``_RAY_NATIVE_THRESHOLD``
   0): the same regions, scalings and stitched mesh (0.0 mm) as phase 8's
   unsharded f32 run and its f64 CPU run (the native grid DDA), count,
   pick and ray launches per shard; the ray kernel against plain on the
   run's rays (bit for bit) and against the native grid DDA
   (disagreements counted), with ms, bound and share, the kernel's
   registers and resident blocks, its plan (blocks, waves), the share of
   pairs that took its exact path and its launches a call, and the
   occlusion pass's two routes on those rays timed whole; then the ray
   kernel on seeded adversarial rays (``adversarial_ray_case``), bit for
   bit against plain
10. the ``ops`` surface on the card: ``ops.hausdorff_sq_masked`` on
    OCT-280's 279 consecutive pairs in f32 and f64, with all-valid masks and
    with a seeded mask that empties whole sets (bit for bit the plain version
    on the same tensors, f64 also the CPU run), and at the refine's grid
    (``p [5, 31, 11200, 2]`` against ``q [5, 1, 11178, 2]`` from phase 6:
    bit for bit phase 6's table), one refine kernel launch a call counted;
    ``ops.multires_rotation_search``, ``ops.search_range_batched`` and
    ``ops.rotation_cost_table`` in f64 at step 0.01 deg / range 6 deg (the
    last two on the ladder's last window), sweep launches counted, the same
    grid angles and tie flags as the CPU run on every 14th pair; kernel
    ms by events and device ms a launch (torch.profiler), plain and
    ``torch.cdist`` composition ms, bound and share, and the refine
    kernel's launch plan (blocks, waves, registers, spills)
11. the f32 certification band (``[band]`` lines): every cost table of
    the f64 runs of ``from_array_single`` on OCT-280, ``from_array_full``
    on 4 x OCT-280, ``from_array_cohort`` on phase 7's 16 pullbacks,
    ``from_file_full`` on ivus_rest + ivus_stress and
    ``from_file_single`` on ivus_full's diastole, and the seeded adversarial
    family of tests/test_torch_band.py, on the kernel in f32 (inputs cast
    as the f32 search casts them) and f64: the largest |f32 - f64| in units
    of the derived per-entry bound (must be <= 1, also for the plain
    version on the family), and the rows whose f32 argmin differs from the
    f64 one, unflagged by the derived band (must be 0) and by the old one;
    then each of those paths in f32 under the derived and the old band:
    flags, f64 re-searches, host-exact repairs, pruned-stage fallbacks,
    the host time of the repair spans and the events time of the f64
    re-search tables, and the coordinates within 1e-4 mm of the f64 run;
    the real-fixture case of phase 12 among the paths; on every exact table
    and the family, the card kernel's f64 argmin against the plain
    version's f64 argmin on the CPU (rows that differ must be flagged by
    the f64 band in force, the JAX package's; the derived f64 band's flags
    printed beside)
12. the real-fixture pullback (run before phase 11): 280 frames built from
    94 twisted copies of the vendored ivus_rest diastolic contours (3
    frames x 501 points, bench.py's construction), ``from_array_single``
    at phase 3's arguments in f32 and f64 on the card and f64 on the CPU:
    the same grid index in every within pair (a searched f32 angle on
    another index flagged and settled), coordinates within 1e-4 mm, repair
    and pruning counters, the exact host ladder on every flagged and every
    14th pair, the kernel against plain at the case's tables, wall clock
    and spans; then ``from_array_full`` on four such pullbacks (ivus_rest
    and ivus_stress, diastole and systole) with phase 5's checks

Every phase prints its lines and its peak device memory (``[mem]``); every
line after phase 1's names the card and its power limit; any failure exits
non-zero.  The line before
the last is the kernel summary JSON, the last line is
``{"ok": true, "device": {...}}``.  ``--only kernel`` stops after phase 2
and holds the refine kernel and the four CCTA kernels against plain on
inputs of their main-path shapes from a seed (the ray kernel also on the
adversarial rays);
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
# the f32 exact tables' divergence from f64 within NEAR_WINDOW_UNITS of the
# winner, in units eps32*(sqrt(scale2*m)+m), as the first kernel measured
# it (2.07; ROADMAP C)
DIVERGENCE_NEAR_MAX = 2.3
NEAR_WINDOW_UNITS = 16.0
# the f32 kernel against its plain version, in units eps32*(sqrt(scale2*c)+c)
# of each cost c: the value of the certification band of earlier checkouts,
# kept as the tolerance when the band was derived anew (ops/rotation_search.py)
KERNEL_PLAIN_F32_UNITS = 8.0


class SmokeFailure(Exception):
    pass


def synthetic_oct_pullback(n_frames=OCT_FRAMES, n_points=OCT_POINTS, seed=7):
    """OCT-like pullback: smooth elliptic lumens with per-frame rotation and
    drift, frame 0 carrying the reference point (bench.py's builder,
    copied: bench.py loads the JAX package's shim).  Returns (lumen rows
    [frame, x, y, z], reference point)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, 2.0 * math.pi, n_points, endpoint=False)
    rows = []
    rot = 0.0
    cx, cy = 4.5, 4.5
    for f in range(n_frames):
        rot += rng.uniform(-0.08, 0.08)
        cx += rng.uniform(-0.02, 0.02)
        cy += rng.uniform(-0.02, 0.02)
        a = 2.0 + 0.2 * math.sin(f / 17.0)
        b = 1.4 + 0.2 * math.cos(f / 23.0)
        wobble = 0.08 * np.sin(5 * theta + f / 5.0)
        r_x = (a + wobble) * np.cos(theta)
        r_y = (b + wobble) * np.sin(theta)
        x = cx + r_x * math.cos(rot) - r_y * math.sin(rot)
        y = cy + r_x * math.sin(rot) + r_y * math.cos(rot)
        z = np.full(n_points, f * 0.2)
        frame_col = np.full(n_points, f)
        rows.append(np.stack([frame_col, x, y, z], axis=-1))
    lumen = np.concatenate(rows)
    ref = np.array([0, cx + 3.0, 4.5, 0.0])
    return lumen, ref


FIXTURES = REPO / "tests" / "data" / "fixtures"
REAL_CASE = "real-fixture-280 (94 twisted copies of ivus_rest's 3 diastolic frames)"
# phase 12's four pullbacks: (label, fixture, contour file, diastole)
REAL_PHASES = (("rest_dia", "ivus_rest", "diastolic_contours.csv", True),
               ("rest_sys", "ivus_rest", "systolic_contours.csv", False),
               ("stress_dia", "ivus_stress", "diastolic_contours.csv", True),
               ("stress_sys", "ivus_stress", "systolic_contours.csv", False))


def real_fixture_pullback(csv, n_frames=OCT_FRAMES, ref_frame=0):
    """An ``n_frames``-frame pullback built from real clinical contours: the
    construction of bench.py's ``real_data_pullback_280``, copied, on a
    vendored contour file (3 frames x 501 points).  Z-shifted copies of its
    frames, each copy c turned by 0.04 c rad about each frame's centroid,
    so that every frame boundary, the seams included, carries alignment
    work; cut to ``n_frames``.  The reference point is bench.py's, taken
    from frame ``ref_frame`` (bench.py: frame 0).  Returns (lumen rows
    [frame, x, y, z], reference point)."""
    import numpy as np

    raw = np.genfromtxt(csv, delimiter=",")
    if raw.ndim != 2 or raw.shape[1] != 4:
        raw = np.genfromtxt(csv, delimiter="\t")
    frames = np.unique(raw[:, 0])
    n_src = len(frames)
    z_span = raw[:, 3].max() - raw[:, 3].min()
    spacing = z_span / max(n_src - 1, 1)
    copies = int(np.ceil(n_frames / n_src))
    rows = []
    fid = 0
    for c in range(copies):
        rot = 0.04 * c  # radians; deterministic per-copy twist
        cr, sr = math.cos(rot), math.sin(rot)
        for f in frames:
            if fid >= n_frames:
                break
            sel = raw[raw[:, 0] == f]
            x, y = sel[:, 1], sel[:, 2]
            cx, cy = x.mean(), y.mean()
            xr = cx + (x - cx) * cr - (y - cy) * sr
            yr = cy + (x - cx) * sr + (y - cy) * cr
            z = sel[:, 3] + c * (z_span + spacing)
            rows.append(np.column_stack([np.full(len(sel), fid), xr, yr, z]))
            fid += 1
    lumen = np.concatenate(rows)
    first = rows[ref_frame]
    ref = np.array([ref_frame, first[:, 1].max() + 1.0, first[:, 2].mean(), first[0, 3]])
    return lumen, ref


def real_fixture_arrays(n_frames=OCT_FRAMES):
    """The four pullbacks of phase 12's four-phase path (rest and stress,
    diastole and systole), each built by :func:`real_fixture_pullback` from
    its fixture's contours: (label, lumen rows, reference point, diastole)
    each.  Each takes its reference point on the last frame that copies the
    fixture's last frame, where the fixture's own reference points lie:
    with frame 0's, the postprocessing of both packages finds no reference
    frame after resampling these irregular z gaps, and on an earlier frame
    it indexes past the pair's frames."""
    out = []
    for label, fixture, name, diastole in REAL_PHASES:
        n_src = 3  # frames of each vendored contour file
        ref_frame = n_src * (n_frames // n_src) - 1
        lumen, ref = real_fixture_pullback(FIXTURES / fixture / name, n_frames, ref_frame)
        out.append((label, lumen, ref, diastole))
    return out


def real_fixture_datas(mt, n_frames=OCT_FRAMES):
    """:func:`real_fixture_arrays` as the package ``mt``'s input data."""
    return [mt.numpy_to_inputdata(lumen, ref, diastole, label=label)
            for label, lumen, ref, diastole in real_fixture_arrays(n_frames)]


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# the card's name and power limit as nvidia-smi reads them (phase 1), named
# on every line after it
CARD = None


def say(phase, msg):
    print(f"[{phase}] {msg}" + (f" ({CARD})" if CARD else ""), flush=True)


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


# profiler windows device_ms opens before it gives up: the tracer has
# returned a window with none of its kernels (one smoke run of PR 14 on an
# H100, in phase 10, where every other run saw them)
PROFILE_WINDOWS = 3


def device_ms(torch, fn, name, calls=20):
    """Device ms a launch of the kernels whose name holds ``name``: the
    mean of torch.profiler's device-side events over ``calls`` calls after
    a warm-up call (the kernel's own time, without the host's; the tracer
    may drop a window's first events, so it averages the launches seen, and
    opens another window, up to PROFILE_WINDOWS, where it saw none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total, count = 0.0, 0
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if name in evt.key:
                got = getattr(evt, "device_time_total", None)
                total += evt.cuda_time_total if got is None else got
                count += evt.count
        if count:
            break
    check(count > 0, f"the profiler saw no {name} kernel in {PROFILE_WINDOWS} windows")
    return total / 1e3 / count


def refine_plan_line(torch, hb, p, q):
    """The refine kernel's launch plan for candidates ``p`` against
    reference sets ``q`` on the card, with the variant's registers, spills
    and resident blocks as the card reports them."""
    dev = p.device
    plan = hb.launch_plan(p.shape[0], p.shape[1], q.shape[1], p.element_size(), dev)
    info = hb.kernel_info(dev, p.element_size())[plan.rows_per_thread]
    return (f"plan {plan.blocks} blocks of {plan.warps} warps in {plan.waves} wave(s) of "
            f"{plan.slots}: {plan.tiles} row tile(s) x {plan.splits} column split(s), R "
            f"{plan.rows_per_thread}, rows from {'q' if plan.swap else 'p'}; "
            f"{info['registers']} registers, {info['local_bytes']} spilled bytes a thread, "
            f"{info['blocks_per_sm'][plan.warps - 1]} resident blocks an SM")


@contextlib.contextmanager
def peak_memory(torch, phase):
    """Print the peak device memory the block allocated, in MiB (its peak
    reset just before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    yield
    torch.cuda.synchronize()
    say("mem", f"phase {phase}: peak device memory "
               f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB allocated")


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
# one unordered pair of the refine table, whose d2 serves both directions:
# dx, dy (2 sub), dx*dx, dy*dy (2 mul), their sum (1 add; unfused, so that
# d2 equals numpy's), the row's min and the column's min (2)
OPS_PER_REFINE_PAIR = 7
# the same pair as the benchmark's refine_roofline counts its least work
# (portbench/harness/refinework.py): 4 for its d2 (a fused multiply-add
# counted once) and 1 for each directed use
OPS_PER_REFINE_PAIR_LEAST = 6


def bound_ms(torch, pairs, elem_size, nbytes, ops=OPS_PER_PAIR):
    """(bound in ms, "operations" or "bytes") of ``pairs`` point pairs of
    ``ops`` operations each in points of ``elem_size`` bytes, moving
    ``nbytes``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops_s = ops * pairs / (sms * FP_LANES_PER_SM[elem_size] * MAX_SM_CLOCK_HZ)
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


def _refine_pairs_bytes(p, pmask, q, qmask, K):
    nv = pmask.sum(1)
    mv = qmask.sum(1).repeat_interleave(K)
    e = p.element_size()
    nbytes = (p.numel() + q.numel()) * e + pmask.numel() + qmask.numel() + p.shape[0] * e
    return int((nv * mv).sum()), nbytes


def refine_bound(torch, p, pmask, q, qmask, K):
    """The bound of one refine table: every valid (candidate point, cloud
    point) pair once, at 7 operations (its d2 serves both directions), none
    for an empty set."""
    pairs, nbytes = _refine_pairs_bytes(p, pmask, q, qmask, K)
    return bound_ms(torch, pairs, p.element_size(), nbytes, OPS_PER_REFINE_PAIR)


def refine_bound_least(torch, p, pmask, q, qmask, K):
    """The bound of one refine table as the benchmark's ``refine_roofline``
    counts it: every valid pair once at 6 operations."""
    pairs, nbytes = _refine_pairs_bytes(p, pmask, q, qmask, K)
    return bound_ms(torch, pairs, p.element_size(), nbytes, OPS_PER_REFINE_PAIR_LEAST)


def refine_bound_directed(torch, p, pmask, q, qmask, K):
    """The bound as earlier checkouts stated it: both directions of every
    valid pair, 5 operations each (10 a pair, where the function needs 7)."""
    pairs, nbytes = _refine_pairs_bytes(p, pmask, q, qmask, K)
    return bound_ms(torch, 2 * pairs, p.element_size(), nbytes, OPS_PER_PAIR)


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
    global CARD
    CARD = smi.stdout.strip()
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

def sample_sets(lumen, ref, label):
    """The centered sample sets [frames, 500 + 20, 2] (or with a mask) the
    single path sweeps for a pullback (lumen rows and reference point) at
    MAIN_ARGS: 500 lumen points and the 20-point catheter ring.  Returns
    (sets, mask or None)."""
    from multimodars_torch import numpy_to_inputdata
    from multimodars_torch._processing import _to_inputdata
    from multimodars_torch.io.build import build_any_from_inputdata
    from multimodars_torch.pipelines.align_within import _validate_and_pack

    data = numpy_to_inputdata(lumen, ref, True, label=label)
    tg = build_any_from_inputdata(
        _to_inputdata(data), None, label, True, (4.5, 4.5), 0.5, 20,
        verbose=False,
    )
    _obj, _tg, pts, mask = _validate_and_pack(tg, 500)
    return pts, mask


def oct_sample_sets():
    """The [280, 520, 2] centered sample sets the main path sweeps for the
    OCT-280 pullback (500 lumen points + the 20-point catheter ring)."""
    pts, mask = sample_sets(*synthetic_oct_pullback(OCT_FRAMES, OCT_POINTS), "oct280")
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
            check((np.abs(kf - pf) <= KERNEL_PLAIN_F32_UNITS * unit_c).all(),
                  f"{name}: kernel differs from plain by more than "
                  f"{KERNEL_PLAIN_F32_UNITS} units")
            # divergence from the f64 table in units eps32*(sqrt(scale2*m)+m)
            # at the winning cost m: over all candidates, over those within
            # NEAR_WINDOW_UNITS of m, and in each candidate's own unit
            # eps32*(sqrt(scale2*c)+c)
            ref64 = results[(torch.float64, dense, stride)]["k"]
            m64 = np.where(np.isfinite(ref64), ref64, np.inf).min(axis=1)
            unit_m = eps * (np.sqrt(r["scale2"] * m64) + m64)
            um = np.broadcast_to(unit_m[:, None], k.shape)[fin]
            r64 = ref64[fin]
            div = np.abs(kf - r64) / um
            divp = np.abs(pf - r64) / um
            near = r64 <= np.broadcast_to(m64[:, None], k.shape)[fin] + NEAR_WINDOW_UNITS * um
            own = np.abs(kf - r64) / (eps * (np.sqrt(np.broadcast_to(s2, k.shape)[fin] * r64) + r64))
            line += (f"; |cost_f32 - cost_f64| in units at m: max {float(div.max()):.3f} "
                     f"(= {float(div.max()) / rs._TIE_C[torch.float32]:.3f} f32 "
                     f"band units) over all, "
                     f"{float(div[near].max()):.3f} within {NEAR_WINDOW_UNITS:g} units of m; "
                     f"own-cost units max {float(own.max()):.3f}; "
                     f"plain f32 {float(divp.max()):.3f} units at m over all, "
                     f"{float(divp[near].max()):.3f} within {NEAR_WINDOW_UNITS:g} units of m")
            near_max = float(div[near].max())
        say("kernel", line)
        if dtype == torch.float32 and stride == 1:
            # the divergence the first kernel showed near the winner of an
            # exact table, the one whose argmin the band certifies
            check(near_max <= DIVERGENCE_NEAR_MAX,
                  f"{name}: f32 diverges from f64 by {near_max:.3f} units within "
                  f"{NEAR_WINDOW_UNITS:g} units of the winner, more than {DIVERGENCE_NEAR_MAX}")
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


@contextlib.contextmanager
def recorded_repairs(align_within):
    """Record what each within chain of a run hands its repair and gets back:
    (searched relative angles, certification flags, repaired angles), each
    [pairs], radians."""
    import numpy as np

    seen = []
    fn = align_within.repair_chain_deltas

    def spy(delta, flags, *args, **kwargs):
        out = fn(delta, flags, *args, **kwargs)
        seen.append((np.array(delta), np.array(flags, dtype=bool), np.array(out)))
        return out

    align_within.repair_chain_deltas = spy
    try:
        yield seen
    finally:
        align_within.repair_chain_deltas = fn


def grid_steps(rad, step_deg):
    """Angles (radians) as whole grid steps of ``step_deg``."""
    import numpy as np

    return np.rint(np.degrees(rad) / step_deg).astype(np.int64)


def unsettled_swaps(raw, flags, want, step_deg):
    """Pairs whose searched angle lands on another grid index than ``want``
    (the float64 run's answers) without a certification flag; and the
    count of flagged ones that did."""
    differ = grid_steps(raw, step_deg) != grid_steps(want, step_deg)
    return int((differ & ~flags).sum()), int((differ & flags).sum())


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


def check_table(torch, sweep, rs, name, args, kw, plain_reps, phase="full"):
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
        band = KERNEL_PLAIN_F32_UNITS * rs._eps_eff(torch.float32) * (
            np.sqrt(np.broadcast_to(s2[:, None], p_out.shape)[fin] * c) + c)
        check((diff <= band).all(), f"{name}: kernel differs from plain by more than "
                                    f"{KERNEL_PLAIN_F32_UNITS} units")
    F, N, M, K = sweep.check_inputs(*args, kw["dense"], kw["outer_stride_test"],
                                    kw["outer_stride_ref"])
    bound, by = sweep_bound(torch, args, kw)
    say(phase, f"{name} [F {F}, N {N}, M {M}, K {K}]: kernel {ms:.4f} ms, "
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


def phase_full_path(torch, sweep, mt, profile=False, datas=None, tag="full", warm=2, reps=5):
    """``from_array_full`` on four pullbacks (default: 4 x OCT-280), f32
    and f64 on the card, wall clock the median of ``reps`` runs after
    ``warm`` warm-ups; lines tagged ``tag``."""
    import numpy as np

    from multimodars_torch.ops import argmin_repair
    from multimodars_torch.ops import rotation_search as rs
    from multimodars_torch.ops.argmin_repair import exact_ladder
    from multimodars_torch.pipelines import align_between
    from multimodars_torch.utils import trace

    if datas is None:
        datas = full_inputs(mt)
    check(mt.config.compute_dtype == torch.float32,
          f"compute dtype {mt.config.compute_dtype}")

    def run():
        out = quiet(mt.from_array_full, *datas, **FULL_ARGS)
        torch.cuda.synchronize()
        return out

    def counters():
        return dict({k: argmin_repair.stats.get(k, 0)
                     for k in ("flagged", "repaired", "changed", "host_exact")},
                    pruned=rs.prune_stats["stages"], fallbacks=rs.prune_stats["fallbacks"])

    def reset():
        reset_counters(sweep, argmin_repair, trace)
        for k in rs.prune_stats:
            rs.prune_stats[k] = 0

    # the counted run: every launch count set to 0 just before it
    reset()
    with recorded_between(align_between) as stages32, recorded_tables(sweep) as tables:
        t0 = time.perf_counter()
        out32 = run()
        first_s = time.perf_counter() - t0
    launches, masked = sweep.launches, sweep.masked_launches
    stats32 = counters()
    n_frames = len(datas[0].lumen)
    say(tag, f"from_array_full 4 x {n_frames} frames f32: {first_s:.3f} s (first run), "
             f"sweep launches {launches} ({launches - masked} dense, "
             f"{masked} masked), repair counters {stats32}")
    check(launches - masked > 0, "the full path launched no dense table")
    check(masked > 0, "the full path launched no masked table")

    pairs32, logs32 = out32[:4], out32[4]
    check([p.label for p in pairs32] == [
        "rest_dia - rest_sys", "stress_dia - stress_sys",
        "rest_dia - stress_dia", "rest_sys - stress_sys"],
        f"pair labels {[p.label for p in pairs32]}")
    check([len(l) for l in logs32] == [n_frames - 1] * 4,
          f"log lengths {[len(l) for l in logs32]}")
    for pair in pairs32:
        n_a, n_b = len(pair.geom_a.frames), len(pair.geom_b.frames)
        check(n_a == n_b and 0 < n_a <= n_frames,
              f"{pair.label}: {n_a} and {n_b} frames after postprocessing")
    c32 = pair_coords(pairs32)
    check(np.isfinite(c32).all(), "output coordinates not finite")
    check(len(stages32) == 2, f"{len(stages32)} between stages")
    win32 = np.concatenate([st[1] for st in stages32])
    clouds32 = [c for st in stages32 for c in st[2]]

    reset()
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
    say(tag, f"f64 run: repair counters {stats64}; f32 vs f64: same grid angle "
             f"in every within pair {same_within} (max |rot diff| {d_rot:.3e} deg); "
             f"between winners (deg) f32 {np.degrees(win32).round(6).tolist()}, "
             f"f64 {np.degrees(win64).round(6).tolist()}, grid indices "
             f"{grid_index(win32).tolist()} vs {grid_index(win64).tolist()}, "
             f"same {same_between}; frame counts equal {frames_equal}")
    check(same_within, "f32 and f64 within logs land on different grid angles")
    check(same_between, "f32 and f64 between winners land on different grid indices")
    check(frames_equal, "f32 and f64 runs kept different frame counts")
    d_xyz = float(np.abs(c32 - pair_coords(out64[:4])).max())
    say(tag, f"f32 vs f64 max |coord diff| over the four pairs {d_xyz:.3e} mm")
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
    say(tag, f"exact host f64 ladder agrees on the four between winners "
             f"(clouds {[len(c[0]) for c in clouds32]} x {[len(c[1]) for c in clouds32]} "
             f"points, {time.perf_counter() - t0:.1f} s)")
    report_tables(torch, sweep, tag, tables)

    for _ in range(warm):
        run()
    trace.reset()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[reps // 2]
    say(tag, f"wall clock f32, median of {reps} after {warm} warm-ups: {med:.4f} s "
             f"(runs {', '.join(f'{t:.4f}' for t in times)})")
    say(tag, "spans per run, mean of those runs (s, calls): " + ", ".join(
        f"{k} {v[0] / reps:.4f} (x{v[1] // reps})"
        for k, v in sorted(trace.summary().items(), key=lambda kv: -kv[1][0])))
    if profile:
        profile_main_path(torch, run, f"{tag}_profile.json")
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
    """Record the packed inputs ``(p, pmask, q, qmask)`` of each refine
    table a run evaluates: the grid's tensors on the card."""
    seen = []
    table = ca.refine_table

    def spy(grid, K, dtype):
        seen.append((tuple(grid[:4]), K))
        return table(grid, K, dtype)

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
    are exact), ``packed`` host arrays or tensors; returns (max abs err,
    kernel ms, plain ms, (bound ms, bound by))."""
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
    pairs = 1.0 * p.shape[0] * p.shape[1] * q.shape[1]
    bound, by = refine_bound(torch, *args, K)
    old, _ = refine_bound_directed(torch, *args, K)
    least, _ = refine_bound_least(torch, *args, K)
    dms = device_ms(torch, lambda: hb.hausdorff_sq_shared_ref(*args, K), "hausdorff_batch", 5)
    tag = "f32" if dtype == torch.float32 else "f64"
    say("refine", f"{tag} table [S*K {p.shape[0]}, n {p.shape[1]}, m {q.shape[1]}]: "
                  f"kernel {ms:.3f} ms ({pairs / ms / 1e9:.2f} T point pairs/s), device "
                  f"{dms:.3f} ms a launch, bound {bound:.3f} ms "
                  f"({by}; 7 ops a valid pair, the kernel's count), {100.0 * bound / ms:.1f}% "
                  f"of bound; at 6 ops a valid pair, the benchmark's refine_roofline count, "
                  f"{least:.3f} ms, {100.0 * least / dms:.1f}% of device time (the "
                  f"5-op directed bound of earlier checkouts {old:.3f} ms, "
                  f"{100.0 * old / ms:.1f}%), plain {plain_ms:.3f} ms, max |kernel-plain| "
                  f"{err:.3e}, {int((k_out == 0).sum())} zero entries "
                  f"(card after: {card_state()})")
    say("refine", f"{tag} table: {refine_plan_line(torch, hb, args[0], args[2])}")
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
    packed, K = tables64[0]
    p, pmask, q, qmask = (t.cpu().numpy() for t in packed)
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
        bound_ms=res[0][3][0], bound_by=res[0][3][1]), {
            torch.float32: tables32[0], torch.float64: tables64[0]}


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

COHORT_SEEDS = tuple(range(7, 23))


def cohort_datas(mt):
    """The cohort's 16 OCT-280 pullbacks, seeds COHORT_SEEDS."""

    datas = []
    for seed in COHORT_SEEDS:
        lumen, ref = synthetic_oct_pullback(OCT_FRAMES, OCT_POINTS, seed)
        datas.append(mt.numpy_to_inputdata(lumen, ref, True, label=f"case{seed}"))
    return datas


def phase_cohort(torch, sweep, rs, mt, profile=False):
    import numpy as np

    from multimodars_torch.ops import argmin_repair
    from multimodars_torch.utils import trace

    datas = cohort_datas(mt)
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
# the vessel-tree discretization of the labelled case at the wrapper
# defaults (step 1.0 mm, 100 points a contour): without and with the
# B-spline refit, one discretize_vessel_tree call each
TREE_BSPLINE = (False, True)
# the certification work of those two calls in f32, (rows, flagged,
# changed) of ccta.kernels.stats' nearest, as every chip run has shown it
TREE_CERTIFICATION_F32 = (115212, 2, 0)


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


def ccta_case(mt, scale=None):
    """(mesh, aorta / RCA / LCA centerline arrays, IV geometry) of the
    benchmark's build_case(scale) (default CCTA_SCALE)."""
    import numpy as np

    scale = CCTA_SCALE if scale is None else scale
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
    """Record (origins, directions, faces [F, 3, 3]) of every call of the
    occlusion pass's ray test (``ccta.kernels.ray_occlusion``, whichever
    route it takes)."""
    from multimodars_torch.ccta import kernels as ck

    seen = []
    fn = ck.ray_occlusion

    def spy(origins, directions, tri):
        seen.append((origins.copy(), directions.copy(), tri.copy()))
        return fn(origins, directions, tri)

    ck.ray_occlusion = spy
    try:
        yield seen
    finally:
        ck.ray_occlusion = fn


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
                         n_points_iv_cont=len(geom.frames[0].lumen.points))
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
    one launch, and a vessel tree's three walk picks (20,000 x 21, 17,000 x
    24, 17,000 x 24) in one launch."""
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
        # every set at a multiple of 4 rows, as the glue packs them
        walk = t((54000 + 72, 3))
        walks = [(0, 20000, 54000, 21), (20000, 17000, 54024, 24), (37000, 17000, 54048, 24)]
        calls += [
            ("radius_count", (island[:18864], island[18864:], 3.999, 4.001), {}),
            ("radius_count", (t((17000, 3)), t((40000, 3)), 3.999, 4.001), {}),
            ("radius_count", (t((57606, 3)), t((60, 3)), 8.999, 9.001), {"flags": True}),
            ("radius_count_batch", (island, island, [(0, 18864, 18864, 21587, 3.999, 4.001),
                                                     (0, 18864, 0, 18864, 3.999, 4.001)]), {}),
            ("nearest", (picks[:4036], picks[4036:]), {}),
            ("nearest", (t((26449, 3)), t((50, 3))), {}),
            ("nearest_batch", (picks, picks, [(0, 4036, 4036, 576), (4036, 576, 0, 4036)]), {}),
            ("nearest_batch", (walk, walk, walks), {}),
            ("morph_sweep", (t((750, 3)), unit, t((576, 3)), xs), {}),
            ("morph_sweep_batch", (s_pts, s_unit, s_ref, xs, sweeps), {}),
        ]
    return calls


def rounded(point):
    return tuple(round(float(x), 4) for x in point)


def tree_label(mt, case):
    """``label`` on the case as ccta_run labels it: (results, RCA, LCA and
    aorta centerlines).  The discretization takes a copy of the results."""
    mesh, cl_ao, cl_rca, cl_lca, geom = case
    results, (rca_cl, lca_cl, ao_cl) = quiet(
        mt.label, mesh.copy(), cl_ao, cl_rca, cl_lca, aligned_frames=geom.frames,
        anomalous_rca=True, control_plot=False,
    )
    return results, rca_cl, lca_cl, ao_cl


def tree_prepare(mt, labelled):
    """``prepare_centerlines`` on a copy of the labelled results: the
    arguments of ``discretize_vessel_tree``."""
    results, rca_cl, lca_cl, ao_cl = labelled
    rca2, lca2, prepared = quiet(mt.prepare_centerlines, rca_cl, lca_cl, dict(results))
    return ao_cl, rca2, lca2, prepared


def tree_discretize(torch, mt, prepared, modes=TREE_BSPLINE):
    """``discretize_vessel_tree`` at the defaults, once per B-spline mode."""
    trees = [mt.discretize_vessel_tree(*prepared, b_spline=b) for b in modes]
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return trees


def tree_stacks(tree):
    """(name, contours) of every stack of a tree: the three mains, then each
    side branch."""
    return ([("aorta", tree.discretized_aorta), ("rca", tree.discretized_rca_main),
             ("lca", tree.discretized_lca_main)]
            + [(f"rca side {k + 1}", s) for k, s in enumerate(tree.rca_branches)]
            + [(f"lca side {k + 1}", s) for k, s in enumerate(tree.lca_branches)])


def tree_differences(got, want):
    """What differs between two trees: contour counts per stack, ids and
    point indices, coordinates (max |diff| mm), reference points."""
    import numpy as np

    out = []
    g_stacks, w_stacks = tree_stacks(got), tree_stacks(want)
    if [(n, len(s)) for n, s in g_stacks] != [(n, len(s)) for n, s in w_stacks]:
        return [f"contour counts {[(n, len(s)) for n, s in g_stacks]} vs "
                f"{[(n, len(s)) for n, s in w_stacks]}"]
    d = 0.0
    for (name, gs), (_, ws) in zip(g_stacks, w_stacks):
        for g, w in zip(gs, ws):
            if (g.id, g.point_indices.tolist()) != (w.id, w.point_indices.tolist()):
                out.append(f"{name}: contour {g.id} vs {w.id} or its point indices differ")
            elif g.n_points:
                d = max(d, float(np.abs(g.xyz_view() - w.xyz_view()).max()))
    if d != 0.0:
        out.append(f"max |contour coordinate diff| {d:.3e} mm")
    for attr in ("ao_rca", "ao_lca", "rca_references", "lca_references"):
        if getattr(got, attr) != getattr(want, attr):
            out.append(f"{attr} differs")
    return out


def phase_ccta_tree(torch, mt, case, profile=False):
    """The vessel-tree discretization on phase 8's case: ``label`` ->
    ``prepare_centerlines`` -> ``discretize_vessel_tree`` without and with
    the B-spline refit.  Launches counted per step; f32 card = f64 card =
    f64 CPU exactly; the recorded kernel calls against plain; wall clock and
    spans.  Returns (launches, kernel report)."""
    from multimodars_torch.ccta import discretization_map
    from multimodars_torch.ccta import kernels as ck
    from multimodars_torch.ops import morph_sweep, nearest, radius_count
    from multimodars_torch.utils import trace

    mods = {"radius_count": radius_count, "nearest": nearest, "morph_sweep": morph_sweep}
    labelled = tree_label(mt, case)

    # the counted runs: every launch count set to 0 just before each step
    def counted(step):
        for mod in mods.values():
            mod.launches = 0
        ck.reset_stats()
        with recorded_ccta_calls() as calls:
            t0 = time.perf_counter()
            out = step()
            seconds = time.perf_counter() - t0
        return out, {name: mod.launches for name, mod in mods.items()}, calls, seconds

    prepared, prep_launches, prep_calls, prep_s = counted(lambda: tree_prepare(mt, labelled))
    trees, disc_launches, disc_calls, disc_s = counted(
        lambda: tree_discretize(torch, mt, prepared))
    stats = {k: dict(v) for k, v in ck.stats.items()}
    ao_cl, rca_cl, lca_cl, results = prepared
    say("ccta-tree", f"f32 first run: prepare_centerlines {prep_s:.3f} s, launches "
                     f"{prep_launches}; discretize_vessel_tree x{len(TREE_BSPLINE)} "
                     f"(b_spline {list(TREE_BSPLINE)}) {disc_s:.3f} s, launches {disc_launches}")
    say("ccta-tree", f"discretization certification {stats}")
    # label_branches: one bounded-flags launch per branch of each centerline
    n_branches = len(rca_cl.branch_start_indices) + len(lca_cl.branch_start_indices)
    check(prep_launches == {"radius_count": n_branches, "nearest": 0, "morph_sweep": 0},
          f"prepare_centerlines launched {prep_launches}, expected {n_branches} count "
          f"launches (one per branch) and nothing else")
    sides = [discretization_map._numbered_regions(results, f"{v}_points") for v in ("rca", "lca")]
    walks = 3 + len(sides[0]) + len(sides[1])
    per_tree = -(-walks // nearest.MAX_PAIRS)
    say("ccta-tree", f"{walks} walks a tree: {per_tree} nearest launch(es) a tree expected "
                     f"(up to {nearest.MAX_PAIRS} walks a launch)")
    check(disc_launches == {"radius_count": 0, "nearest": per_tree * len(TREE_BSPLINE),
                            "morph_sweep": 0},
          f"discretize_vessel_tree launched {disc_launches}, expected {per_tree} nearest "
          f"launch(es) a tree and nothing else")
    if TREE_CERTIFICATION_F32 is not None:
        got = tuple(stats["nearest"][k] for k in ("rows", "flagged", "changed"))
        check(got == TREE_CERTIFICATION_F32,
              f"f32 discretization certification {got}, expected {TREE_CERTIFICATION_F32}")

    keys = ["aorta_points", "rca_points_main", "lca_points_main"] + [
        f"{v}_points_side_{k + 1}" for v, s in zip(("rca", "lca"), sides) for k in range(len(s))]
    say("ccta-tree", "regions: " + ", ".join(f"{k} {len(results[k])}" for k in keys))
    picks = [p for name, args, _ in disc_calls if name == "nearest_batch" for p in args[2]]
    say("ccta-tree", "walk picks (points x anchors): " + ", ".join(
        f"[{n}] x [{m}]" for _, n, _, m in picks[:walks]))
    for b_spline, tree in zip(TREE_BSPLINE, trees):
        say("ccta-tree", f"b_spline {b_spline}: contours " + ", ".join(
            f"{name} {len(s)}" for name, s in tree_stacks(tree))
            + f"; ao_rca {rounded(tree.ao_rca)}, ao_lca {rounded(tree.ao_lca)}")
        for attr in ("rca_references", "lca_references"):
            say("ccta-tree", f"b_spline {b_spline}: {attr} (main, counter-clock, clock) "
                + "; ".join(str(tuple(rounded(p) for p in t)) for t in getattr(tree, attr)))
        check(tree.discretized_aorta and tree.discretized_rca_main
              and tree.discretized_lca_main, f"b_spline {b_spline}: a main vessel has no contour")
        check(all(c.n_points == 100 for _, s in tree_stacks(tree) for c in s),
              f"b_spline {b_spline}: a contour without 100 points")
        check(tree.rca_references and tree.lca_references,
              f"b_spline {b_spline}: no reference triplets")

    # f32 card = f64 card = f64 CPU, label included
    for device, label in ((None, "f64 card"), ("cpu", "f64 CPU")):
        with mt.config.use(device=device, dtype=torch.float64):
            other = tree_discretize(torch, mt, tree_prepare(mt, tree_label(mt, case)))
        diffs = [f"b_spline {b}: {d}" for b, g, w in zip(TREE_BSPLINE, trees, other)
                 for d in tree_differences(g, w)]
        say("ccta-tree", f"f32 card vs {label}: " + ("same contour counts, contours "
                                                    "(0.0 mm) and reference points"
                                                    if not diffs else "; ".join(diffs)))
        check(not diffs, f"f32 card and {label} discretize different trees")

    launches = {k: prep_launches[k] + disc_launches[k] for k in mods}
    kres = report_ccta_calls(torch, prep_calls + disc_calls, launches)

    def run():
        return tree_discretize(torch, mt, tree_prepare(mt, labelled), modes=(False,))

    for _ in range(2):
        run()
    trace.reset()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[2]
    say("ccta-tree", f"prepare_centerlines -> discretize_vessel_tree wall clock f32, median "
                     f"of 5 after 2 warm-ups: {med:.4f} s "
                     f"(runs {', '.join(f'{t:.4f}' for t in times)})")
    say("ccta-tree", "spans per run, mean of those runs (s, calls): " + ", ".join(
        f"{k} {v[0] / 5:.4f} (x{v[1] // 5})"
        for k, v in sorted(trace.summary().items(), key=lambda kv: -kv[1][0])))
    if profile:
        profile_main_path(torch, run, "ccta_tree_profile.json")
    return launches, kres


def phase_ccta(torch, mt, profile=False):
    import numpy as np

    from multimodars_torch.ccta import kernels as ck
    from multimodars_torch.ops import morph_sweep, nearest, radius_count, ray_triangle
    from multimodars_torch.utils import trace

    t0 = time.perf_counter()
    case = ccta_case(mt)
    mesh = case[0]
    say("ccta", f"case built in {time.perf_counter() - t0:.2f} s: "
                f"{len(mesh.vertices)} vertices, {len(mesh.faces)} faces, "
                f"{len(case[4].frames)} IV frames x {len(case[4].frames[0].lumen.points)} points")
    check((len(mesh.vertices), len(mesh.faces)) == (CCTA_VERTICES, CCTA_FACES),
          "the case is not the 57,606-vertex benchmark mesh")
    mods = {"radius_count": radius_count, "nearest": nearest, "morph_sweep": morph_sweep,
            "ray_triangle": ray_triangle}

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
    say("ccta", "occlusion ray tests (rays x faces = pairs; the ray kernel's route on the "
                f"card above {ck._RAY_NATIVE_THRESHOLD['cuda']:.2e}): "
                + ", ".join(f"{len(o)} x {len(t)} = {len(o) * len(t):.4e}" for o, _, t in rays))
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
            names = ("ray_hits_kernel",) if kernel == "ray_triangle" else (f"{kernel}_kernel",)
            us = sum(v[0] for k, v in by_name.items() if any(n in k for n in names))
            count = sum(v[1] for k, v in by_name.items() if any(n in k for n in names))
            say("profile", f"{kernel}: {count} launches in the profiled run, device "
                           f"{us / 1e3:.4f} ms, {us / 1e3 / max(count, 1):.4f} ms a launch")
        for key, (us, count) in sorted(by_name.items()):
            if key.startswith("Memcpy"):
                say("profile", f"{key}: {count} copies in the profiled run, {us / 1e3:.4f} ms")

    tree_launches, tree_kres = phase_ccta_tree(torch, mt, case, profile)
    for name, n in tree_launches.items():
        launches[name] += n
    for kernel, row in tree_kres.items():
        err = max(kres[kernel]["max_abs_err"], row["max_abs_err"])
        if row["bound_ms"] > kres[kernel]["bound_ms"]:
            kres[kernel] = row
        kres[kernel]["max_abs_err"] = err
    return launches, kres, dict(case=case, f32=run32, cpu=run_cpu, calls=calls)


# the CCTA fusion benchmark's build_case(scale=5): 160,006 vertices, 320,000
# faces, 12 IV frames x 320 points
CCTA_LARGE_SCALE = 5
CCTA_LARGE_VERTICES, CCTA_LARGE_FACES = 160006, 320000


def phase_ccta_large(torch, mt):
    """Phase 8 on the benchmark's scale-5 case: ``label`` -> ``scale`` ->
    ``stitch`` in f32 on the card (launches and certification counted), f64
    on the card and f64 on the CPU (the same regions, scalings and stitched
    mesh, 0.0 mm); each kernel against plain on the f32 run's recorded
    calls; the ray pass's two routes timed whole on the run's rays, and
    which of them ``_RAY_NATIVE_THRESHOLD`` picks; wall clock (median of 3
    after 1 warm-up).  Returns (launches, kernel report, ray kernel row)."""
    import numpy as np

    from multimodars_torch.ccta import kernels as ck
    from multimodars_torch.ops import morph_sweep, nearest, radius_count, ray_triangle
    from multimodars_torch.utils import trace

    t0 = time.perf_counter()
    case = ccta_case(mt, CCTA_LARGE_SCALE)
    mesh = case[0]
    say("ccta-160k", f"case built in {time.perf_counter() - t0:.2f} s: "
                     f"{len(mesh.vertices)} vertices, {len(mesh.faces)} faces, "
                     f"{len(case[4].frames)} IV frames x {len(case[4].frames[0].lumen.points)} "
                     f"points")
    check((len(mesh.vertices), len(mesh.faces)) == (CCTA_LARGE_VERTICES, CCTA_LARGE_FACES),
          "the case is not the 160,006-vertex benchmark mesh")
    mods = {"radius_count": radius_count, "nearest": nearest, "morph_sweep": morph_sweep,
            "ray_triangle": ray_triangle}

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
    say("ccta-160k", f"f32 first run {first_s:.3f} s; launches {launches}; "
                     f"certification {stats32}")
    for name, n in launches.items():
        check(n > 0, f"the 160k CCTA path launched no {name} kernel")
    sizes = {k: len(v) for k, v in run32[1].items()}
    say("ccta-160k", f"regions after scale: {sizes}; scalings (proximal, distal, aortic) "
                     f"{run32[2]}; stitched {len(run32[3].vertices)} vertices, "
                     f"{len(run32[3].faces)} faces")
    check(np.isfinite(run32[3].vertices).all() and len(run32[3].faces) > 0,
          "the stitched mesh is empty or not finite")

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
        say("ccta-160k", f"f32 card vs {label}: same region index sets {same_regions}, "
                         f"scalings {run32[2]} vs {other[2]}, same stitched faces {same_faces}, "
                         f"max |stitched vertex diff| {d:.3e} mm")
        check(same_regions, f"160k: f32 card and {label} label different regions")
        check(run32[2] == other[2], f"160k: f32 card and {label} find different scalings")
        check(same_faces and d == 0.0, f"160k: f32 card and {label} stitch different meshes")
    say("ccta-160k", f"f64 card certification {stats64}; f64 CPU run {cpu_s:.3f} s")

    kres = report_ccta_calls(torch, calls, launches)
    check(len(rays) == 1, f"{len(rays)} occlusion ray tests in one run")
    origins, directions, tris = rays[0]
    row = check_ray_call(torch, origins, directions, tris, "160k occlusion rays")
    pairs = len(origins) * len(tris)
    picked = "kernel" if pairs > ck._RAY_NATIVE_THRESHOLD["cuda"] else "native DDA"
    faster = min(row["routes"], key=row["routes"].get)
    say("ccta-160k", f"occlusion rays {len(origins)} x {len(tris)} = {pairs:.4e} pairs: "
                     f"_RAY_NATIVE_THRESHOLD ({ck._RAY_NATIVE_THRESHOLD['cuda']:.2e} pairs) "
                     f"picks the {picked} route; whole-call host ms, kernel route "
                     f"{row['routes']['kernel']:.4f}, native DDA "
                     f"{row['routes']['native DDA']:.4f}; the faster is the {faster} route, "
                     f"picked {picked == faster}")

    def run():
        return ccta_run(torch, mt, case)

    run()
    trace.reset()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    say("ccta-160k", f"label -> scale -> stitch wall clock f32, median of 3 after 1 warm-up: "
                     f"{sorted(times)[1]:.4f} s (runs {', '.join(f'{t:.4f}' for t in times)})")
    say("ccta-160k", "spans per run, mean of those runs (s, calls): " + ", ".join(
        f"{k} {v[0] / 3:.4f} (x{v[1] // 3})"
        for k, v in sorted(trace.summary().items(), key=lambda kv: -kv[1][0])))
    return launches, kres, row


# side branches of each coronary of phase 8's side-branch tree: the aorta,
# the two mains and six side branches make 9 walks, past the 8 pairs one
# nearest launch takes
SIDE_TREE_SIDES = 3


def side_tree_centerline(sides=SIDE_TREE_SIDES):
    """A raw centerline with ``sides`` side branches (the Y-shaped coronary
    of tests/test_torch_discretization.py, with more sides): a 40 mm main
    polyline at 0.5 mm spacing, then each side a 12 mm polyline starting
    0.6 mm off the main at z 10 ... 30 mm, turned about the main by whole
    parts of a circle; the spacing jumps split them.  Returns the
    polylines, the main first."""
    import numpy as np

    main = np.array([[0.0, 0.0, z] for z in np.linspace(40.0, 0.0, 81)])
    parts = [main]
    for k in range(sides):
        a = 2.0 * math.pi * k / sides
        d = np.array([math.cos(a), math.sin(a), 0.5]) / math.sqrt(1.25)
        z0 = 10.0 + 20.0 * k / max(sides - 1, 1)
        start = np.array([[0.6 * math.cos(a), 0.6 * math.sin(a), z0]])
        parts.append(start + 0.5 * np.arange(25)[:, None] * d)
    return parts


def side_tree_case(mt):
    """A right and a left coronary of :func:`side_tree_centerline` beside an
    aorta tube, labelled by construction: (aorta centerline, RCA and LCA
    centerlines, results with the mesh and the three regions), fresh on
    each call (prepare_centerlines adds to the results)."""
    import numpy as np

    from multimodars_torch.ccta.mesh import Mesh, concatenate

    raws, tubes = [], []
    for shift in (np.array([14.0, 0.0, 0.0]), np.array([-14.0, 0.0, 0.0])):
        parts = [p + shift for p in side_tree_centerline()]
        raws.append(np.vstack(parts))
        tubes.append([_tube_mesh(Mesh, parts[0], 1.2, 16)]
                     + [_tube_mesh(Mesh, p[2:], 0.8, 12) for p in parts[1:]])
    cl_ao = _line((0, 0, 45), (0, 0, -5), 51)
    parts = [_tube_mesh(Mesh, cl_ao, 6.0, 32), *tubes[0], *tubes[1]]
    mesh = concatenate(parts)
    counts = np.cumsum([0] + [len(p.vertices) for p in parts])
    verts = [tuple(v) for v in mesh.vertices.tolist()]
    n = 1 + SIDE_TREE_SIDES
    results = {"mesh": mesh, "aorta_points": verts[counts[0]:counts[1]],
               "rca_points": verts[counts[1]:counts[1 + n]],
               "lca_points": verts[counts[1 + n]:counts[1 + 2 * n]]}
    return (mt.numpy_to_centerline(cl_ao), mt.numpy_to_centerline(raws[0]),
            mt.numpy_to_centerline(raws[1]), results)


def phase_side_tree(torch, mt):
    """Phase 8's vessel tree with side branches: ``prepare_centerlines`` ->
    ``discretize_vessel_tree`` (without and with the refit) on
    :func:`side_tree_case`, 9 walks a tree: nearest launches a tree equal to
    ceil(walks / 8), f32 card = f64 card = f64 CPU exactly, and the batched
    pick equal to each walk picked on its own on the card.  Returns the
    launches of the counted runs."""
    import numpy as np

    from multimodars_torch.ccta import discretization_map
    from multimodars_torch.ccta import kernels as ck
    from multimodars_torch.ops import morph_sweep, nearest, radius_count

    mods = {"radius_count": radius_count, "nearest": nearest, "morph_sweep": morph_sweep}

    def trees():
        ao_cl, rca_raw, lca_raw, results = side_tree_case(mt)
        rca_cl, lca_cl, results = quiet(mt.prepare_centerlines, rca_raw, lca_raw, results)
        return results, tree_discretize(torch, mt, (ao_cl, rca_cl, lca_cl, results))

    # the counted run: every launch count set to 0 just before it
    for mod in mods.values():
        mod.launches = 0
    picks = []
    walk_pick = ck._walk_pick

    def spy(walks):
        out = walk_pick(walks)
        picks.append((list(walks), out))
        return out

    ck._walk_pick = spy
    try:
        t0 = time.perf_counter()
        results, got = trees()
        secs = time.perf_counter() - t0
    finally:
        ck._walk_pick = walk_pick
    launches = {name: mod.launches for name, mod in mods.items()}
    sides = [discretization_map._numbered_regions(results, f"{v}_points") for v in ("rca", "lca")]
    walks = 3 + len(sides[0]) + len(sides[1])
    per_tree = -(-walks // nearest.MAX_PAIRS)
    say("ccta-side-tree", f"{2 * SIDE_TREE_SIDES} side branches, {walks} walks a tree: f32 "
                          f"prepare + discretize x{len(TREE_BSPLINE)} {secs:.3f} s, launches "
                          f"{launches}; {per_tree} nearest launch(es) a tree expected (up to "
                          f"{nearest.MAX_PAIRS} walks a launch)")
    check(walks >= nearest.MAX_PAIRS + 1, f"{walks} walks: the tree fits one pick launch")
    check(launches["nearest"] == per_tree * len(TREE_BSPLINE),
          f"{launches['nearest']} nearest launches for {len(TREE_BSPLINE)} trees of {walks} "
          f"walks, expected {per_tree} a tree")
    for b_spline, tree in zip(TREE_BSPLINE, got):
        say("ccta-side-tree", f"b_spline {b_spline}: contours " + ", ".join(
            f"{name} {len(s)}" for name, s in tree_stacks(tree)))
        check(len(tree.rca_branches) == len(tree.lca_branches) == SIDE_TREE_SIDES
              and all(tree.rca_branches) and all(tree.lca_branches),
              f"b_spline {b_spline}: side-branch stacks {len(tree.rca_branches)}, "
              f"{len(tree.lca_branches)}, or an empty one")

    # the batched pick against each walk picked on its own on the card
    check(len(picks) == len(TREE_BSPLINE) and all(len(w) == walks for w, _ in picks),
          f"walk picks {[len(w) for w, _ in picks]}")
    differ = 0
    for walk_list, batched in picks:
        for walk, (anchors, _pts, assignment) in zip(walk_list, batched):
            (one,) = ck._walk_pick([walk])
            same = (np.array_equal(anchors[0], one[0][0]) and np.array_equal(anchors[1], one[0][1])
                    and (assignment is None) == (one[2] is None)
                    and (assignment is None or np.array_equal(assignment, one[2])))
            differ += not same
    nearest.launches = launches["nearest"]  # the single picks do not count
    say("ccta-side-tree", f"batched walk picks vs each walk picked alone on the card: "
                          f"{differ} of {len(picks) * walks} differ")
    check(differ == 0, f"{differ} batched walk picks differ from single picks")

    for device, label in ((None, "f64 card"), ("cpu", "f64 CPU")):
        with mt.config.use(device=device, dtype=torch.float64):
            _, other = trees()
        diffs = [f"b_spline {b}: {d}" for b, g, w in zip(TREE_BSPLINE, got, other)
                 for d in tree_differences(g, w)]
        say("ccta-side-tree", f"f32 card vs {label}: " + ("same contour counts, contours "
                                                         "(0.0 mm) and reference points"
                                                         if not diffs else "; ".join(diffs)))
        check(not diffs, f"side-branch tree: f32 card and {label} discretize different trees")
    return launches


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------

# phase 9's meshes: MESH_DEVICE named 1, 2 and 4 times (one stream a shard),
# plus every card where the machine has more than one
MESH_DEVICE = "cuda:0"
MESH_SIZES = (1, 2, 4)
# the occlusion pass's FP64 operations per (ray, face) pair before its first
# early-out: h = d x e2 (6 mul, 3 sub), a = e1 . h (3 mul, 2 add), |a| < eps (2)
RAY_OPS_PER_PAIR = 16
RAY_REPLACES = "multimodars_tpu/ccta/kernels.py:1614"
# the island count of phase 8: [18864] x [21587] within 2 mm
ISLAND_SHAPE, ISLAND_RADIUS = (18864, 21587), 2.0


def meshes(torch):
    """(label, device list) of every mesh phase 9 runs."""
    out = [(f"{n} x {MESH_DEVICE}", [MESH_DEVICE] * n) for n in MESH_SIZES]
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count > 1:
        out.append((f"{count} cards", [f"cuda:{i}" for i in range(count)]))
    return out


def ray_bound(torch, n_rays, n_faces):
    """(bound ms, "operations" or "bytes") of one ray-kernel call: its FP64
    operations before the first early-out over the card's FP64 lanes, or
    its bytes (rays and faces read once, three 8-byte words a ray written)
    over the memory rate."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops_s = RAY_OPS_PER_PAIR * n_rays * n_faces / (sms * FP_LANES_PER_SM[8] * MAX_SM_CLOCK_HZ)
    bytes_s = (n_rays * 6 * 8 + n_faces * 9 * 8 + n_rays * 3 * 8) / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s else "bytes")


def host_ms(fn, reps):
    """Milliseconds of one call of ``fn`` by the host clock: the median of
    ``reps`` calls after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[reps // 2]


def check_ray_call(torch, origins, directions, tris, label, native_check=True):
    """The ray kernel against its plain version on the card on these rays:
    the whole output equal bit for bit (hits, closest face, t_min), also
    after the timed calls (the kernel resets its own scratch), and to the
    kernel-order emulation (``ray_triangle.ray_hits_ordered`` at the
    launch's plan, which also counts the pairs that took the exact path);
    (hits, closest) against the native grid DDA, whose disagreements are
    counted; the occlusion pass's two routes on these rays are timed whole
    (``ccta.kernels.ray_occlusion``: the kernel's upload, launch and pull,
    and the native DDA).  Prints the kernel's registers and resident blocks,
    the plan and the launches a call.  Returns the kernel's row of the
    kernels line."""
    import numpy as np

    from multimodars_torch.ccta import kernels as ck
    from multimodars_torch.io import native
    from multimodars_torch.ops import _cuda_build
    from multimodars_torch.ops import ray_triangle as rt

    dev = torch.device(MESH_DEVICE)
    args = [torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64, device=dev)
            for x in (origins, directions, tris)]
    n, m = len(origins), len(tris)
    saved = rt.launches
    got = rt.ray_hits(*args)
    per_call = rt.launches - saved
    want = rt.ray_hits_plain(*args)
    plan = rt.launch_plan(n, m, dev)
    ordered, exact = rt.ray_hits_ordered(*args, plan)
    torch.cuda.synchronize()
    check(per_call == 1, f"{label}: {per_call} ray kernel launches in one call")
    if not torch.equal(got, want):
        bad = (got != want).any(0).nonzero().flatten().tolist()
        for r in bad[:8]:  # (n_hits, closest, t_min) of the kernel, plain and the emulation
            say("ccta-tables", f"{label}: ray {r}: " + "; ".join(
                f"{name} {[v[r].item() for v in rt.views(x)]}"
                for name, x in (("kernel", got), ("plain", want), ("emulation", ordered))))
        check(False, f"{label}: the ray kernel differs from plain in {len(bad)} rays")
    check(torch.equal(ordered, want), f"{label}: the kernel-order emulation differs from plain")
    g_hits, g_closest, g_t = (v.cpu().numpy() for v in rt.views(got))
    w_t = rt.views(want)[2].cpu().numpy()
    fin = np.isfinite(w_t)
    err = float(np.abs(g_t[fin] - w_t[fin]).max()) if fin.any() else 0.0
    ms = cuda_ms(torch, lambda: rt.ray_hits(*args), 5)
    check(torch.equal(rt.ray_hits(*args), want), f"{label}: a repeated launch differs from plain")
    routes = {}
    if native_check:
        saved_threshold = ck._RAY_NATIVE_THRESHOLD
        try:
            for name, threshold in (("kernel", 0), ("native DDA", n * m)):
                ck._RAY_NATIVE_THRESHOLD = {"cuda": threshold}
                routes[name] = host_ms(lambda: ck.ray_occlusion(origins, directions, tris), 5)
        finally:
            ck._RAY_NATIVE_THRESHOLD = saved_threshold
    rt.launches = saved  # launches made to compare with plain do not count
    plain_ms = cuda_ms(torch, lambda: rt.ray_hits_plain(*args), 1)
    bound, by = ray_bound(torch, n, m)
    info = rt.kernel_info(dev)
    pairs = max(n * m, 1)
    line = (f"ray_triangle f64 [{n}] x [{m}]: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound:.5f} ms ({by}), {100.0 * bound / ms:.1f}% of "
            f"bound, {n * m:.3e} pairs, {int((g_hits > 0).sum())} rays hit, "
            f"t_min and hits bit-equal to plain and to the kernel-order emulation; "
            f"{per_call} launch a call, plan {plan.groups} ray groups x {plan.splits} splits of "
            f"{plan.per_split} faces = {plan.groups * plan.splits} blocks in {plan.waves} "
            f"wave(s) of {_cuda_build.sm_count(dev)} SMs x {info['blocks_per_sm']} resident "
            f"blocks; {info['registers']} registers a thread, {info['local_bytes']} spilled "
            f"bytes, {info['shared_bytes']} shared bytes a block; exact path {exact} pairs "
            f"({100.0 * exact / pairs:.4f}%)")
    if native_check:
        dda = quiet(native.ray_occlusion_native, origins, directions, tris.reshape(-1, 9))
        check(dda is not None, "the native library did not load: no grid DDA to compare")
        differ = int(((g_hits != dda[0]) | (g_closest != dda[1])).sum())
        line += (f"; (n_hits, closest) differ from the native grid DDA in {differ} rays; "
                 f"ray_occlusion by the host clock, median of 5: kernel route "
                 f"{routes['kernel']:.4f} ms, native DDA {routes['native DDA']:.4f} ms")
    say("ccta-tables", line + f" (card after: {card_state()})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                routes=routes)


def synthetic_ray_case(np):
    """1000 seeded rays against 37,905 seeded faces (phase 8's shape),
    through the middle of the faces' cloud so that rays hit: (origins,
    directions, faces)."""
    rng = np.random.default_rng(17)
    v0 = rng.normal(0.0, 10.0, (37905, 3))
    tris = np.stack([v0, v0 + rng.normal(0.0, 1.0, (37905, 3)),
                     v0 + rng.normal(0.0, 1.0, (37905, 3))], 1)
    origins = rng.normal(0.0, 2.0, (1000, 3))
    directions = rng.normal(0.0, 1.0, (1000, 3))
    return origins, directions, tris


def synthetic_ray_call(torch):
    import numpy as np

    return check_ray_call(torch, *synthetic_ray_case(np), "seeded", native_check=False)


def adversarial_ray_case(np, seed=23):
    """Seeded rays and faces at the edges of the ray test, (origins [R, 3],
    directions [R, 3], faces [F, 3, 3]), every ray against every face:

    - a right triangle of legs c = 2^k in z = 0 and rays along +-z through
      (c x, c y), so that a = -+c^2, u = x, v = y and t = 1 exactly: u and v
      at 0, -0.0, 1, 1 +- one ulp, u + v at 1 +- one ulp, subnormal u, and
      |a| from 2^-6 up to 2^920 (past the filter's 2^900);
    - |a| at 1e-8 and one ulp either side (the parallel test);
    - un underflowing to +-0 and u rounding to -0.0 (a hit the twin takes)
      or to a tiny negative number (a miss);
    - degenerate faces (repeated or collinear vertices);
    - a fan of faces around one vertex with rays that end on it (t = 1),
      on its outer vertices and on its spokes' middles;
    - random faces with rays aimed at their vertices and edges;
    - huge faces (coordinates near 2^460), where a passes 2^900 or
      overflows."""
    rng = np.random.default_rng(seed)
    origins, directions, tris = [], [], []
    up, down, tiny = np.nextafter(1.0, 2.0), np.nextafter(1.0, 0.0), 5e-324
    xs = (0.0, -0.0, 1.0, down, up, 0.5, 0.25, tiny, -tiny, 1e-300, -1e-300)
    ys = (0.0, -0.0, 0.5, 0.75, np.nextafter(0.75, 1.0), np.nextafter(0.75, 0.0), 1.0, tiny)
    for k in (-3, 0, 5, 200, 455, 460):
        c = 2.0 ** k
        tris.append([[0.0, 0.0, 0.0], [c, 0.0, 0.0], [0.0, c, 0.0]])
        for x in xs:
            for y in ys:
                for sign in (1.0, -1.0):
                    origins.append([c * x, c * y, -sign])
                    directions.append([0.0, 0.0, sign])
    eps = 1e-8
    for delta in (eps, np.nextafter(eps, 0.0), np.nextafter(eps, 1.0)):
        for x in (0.25, 1.0, down, up):
            origins.append([x, 0.25, -1.0])
            directions.append([0.0, 0.0, delta])
    for k, xis in ((400, (-2.0 ** -700, 2.0 ** -700, -2.0 ** -500, -tiny)),
                   (-10, (tiny, -tiny, 2.0 ** -1060))):
        c = 2.0 ** k
        tris.append([[0.0, 0.0, 0.0], [c, 0.0, 0.0], [0.0, c, 0.0]])
        for xi in xis:
            origins.append([xi, 0.25 * c, -1.0])
            directions.append([0.0, 0.0, 1.0])
    p, q = rng.normal(0.0, 2.0, (2, 3))
    tris += [[p, p, q], [p, q, q], [p, p, p], [p, q, 2.0 * q - p]]
    origins += [rng.normal(0.0, 5.0, 3) for _ in range(4)]
    directions += [p - origins[-k] for k in range(1, 5)]
    # a fan around `center`, in a random plane, its vertex in every place
    center = rng.normal(0.0, 2.0, 3)
    basis = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    ring = [center + 1.5 * (np.cos(a) * basis[0] + np.sin(a) * basis[1])
            for a in np.linspace(0.0, 2.0 * np.pi, 8, endpoint=False)]
    for i in range(8):
        a, b = ring[i], ring[(i + 1) % 8]
        tris += [[center, a, b], [a, center, b], [a, b, center]][i % 3:i % 3 + 1]
    for _ in range(16):
        o = center + rng.normal(0.0, 4.0, 3)
        for target in (center, ring[rng.integers(8)], 0.5 * (center + ring[rng.integers(8)])):
            origins.append(o)
            directions.append(target - o)
    v0 = rng.normal(0.0, 3.0, (40, 3))
    rand = np.stack([v0, v0 + rng.normal(0.0, 1.0, (40, 3)), v0 + rng.normal(0.0, 1.0, (40, 3))], 1)
    tris += list(rand)
    for f in rand:
        o = rng.normal(0.0, 5.0, 3)
        lam = rng.uniform()
        for target in (f[0], f[1], f[2], f[0] + lam * (f[1] - f[0]), f[0] + 0.5 * (f[2] - f[0]),
                       f[1] + lam * (f[2] - f[1])):
            origins.append(o)
            directions.append(target - o)
    huge = 2.0 ** 460 * (rng.normal(0.0, 1.0, (4, 3, 3)) + [[[3.0, 0.0, 0.0]]])
    tris += list(huge)
    for f in huge:
        o = rng.normal(0.0, 1.0, 3)
        for target in (f[0], f.mean(0)):
            origins.append(o)
            directions.append(target - o)
            directions.append((target - o) / np.linalg.norm(target - o))
            origins.append(o)
    return (np.asarray(origins, dtype=np.float64), np.asarray(directions, dtype=np.float64),
            np.asarray(tris, dtype=np.float64))


def adversarial_ray_call(torch):
    """The ray kernel on :func:`adversarial_ray_case`, bit for bit against
    plain."""
    import numpy as np

    with np.errstate(all="ignore"):
        case = adversarial_ray_case(np)
    return check_ray_call(torch, *case, "adversarial", native_check=False)


@contextlib.contextmanager
def launches_by_shard():
    """Count each kernel's launches by the shard (``utils.device``) they
    were made under, None outside any shard."""
    from multimodars_torch.ops import nearest, radius_count, ray_triangle, sweep
    from multimodars_torch.utils import device

    counts = {}
    wrapped = [(sweep, "cost_table", "sweep_cost"), (radius_count, "radius_count_batch",
               "radius_count"), (nearest, "nearest_batch", "nearest"),
               (ray_triangle, "ray_hits", "ray_triangle")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in wrapped]
    for mod, name, kernel in wrapped:
        def spy(*args, _fn=getattr(mod, name), _mod=mod, _kernel=kernel, **kwargs):
            before = _mod.launches
            out = _fn(*args, **kwargs)
            shard = device.current_shard()
            key = (_kernel, None if shard is None else shard.index)
            counts[key] = counts.get(key, 0) + _mod.launches - before
            return out
        setattr(mod, name, spy)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def per_shard(counts, kernel, n):
    return [counts.get((kernel, k), 0) for k in range(n)]


def phase_mesh(torch, mt, ccta_state):
    """Multi-device execution on meshes of MESH_DEVICE: the sharded cohort,
    the angle-sharded search, the row-sharded count and the CCTA fusion
    row-sharded with the ray kernel's route forced, each against its
    unsharded run.  Returns (ray kernel launches of the counted CCTA runs,
    the ray kernel's row)."""
    import numpy as np

    from multimodars_torch import parallel
    from multimodars_torch.ccta import kernels as ck
    from multimodars_torch.ops import argmin_repair, nearest, radius_count, ray_triangle, sweep

    mesh_list = meshes(torch)

    # 1. the cohort: from_array_cohort with devices= against devices=None
    datas = cohort_datas(mt)
    kw = dict(step_rotation_deg=FULL_STEP, range_rotation_deg=FULL_RANGE,
              sample_size=500, smooth=True)

    def cohort(devices):
        out = quiet(mt.from_array_cohort, datas, devices=devices, **kw)
        torch.cuda.synchronize()
        return out

    def angles(out):
        return np.concatenate([[l.rot_deg for l in logs] for _, logs, _ in out])

    def coords(out):
        return np.concatenate([lumen_coords(g) for g, _, _ in out])

    ref = cohort(None)
    for label, devs in mesh_list:
        sweep.launches = 0
        with launches_by_shard() as counts:
            got = cohort(devs)
        total = sweep.launches
        same = np.array_equal(angles(got), angles(ref)) and np.array_equal(coords(got), coords(ref))
        shards = per_shard(counts, "sweep_cost", len(devs))
        for _ in range(2):
            cohort(devs)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            cohort(devs)
            times.append(time.perf_counter() - t0)
        med = sorted(times)[2]
        say("mesh", f"cohort 16 x OCT-280 f32 on {label}: same angles and coordinates as "
                    f"devices=None {same}; sweep launches per shard {shards} "
                    f"(of {total}); median of 5 after 2 warm-ups {med:.4f} s = "
                    f"{len(datas) / med:.2f} pullbacks/s")
        check(same, f"the cohort on {label} differs from devices=None")
        check(all(n > 0 for n in shards), f"a shard of {label} launched no sweep")

    # 2. the angle-sharded search on OCT-280's 279 within pairs
    pts = oct_sample_sets()
    test, ref_sets = np.ascontiguousarray(pts[1:]), np.ascontiguousarray(pts[:-1])
    masks = np.ones(test.shape[:2], dtype=bool)
    for brute in (False, True):
        mode = "bruteforce K 1202" if brute else "ladder"
        answers = {}
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            with mt.config.use(dtype=dtype):
                want = parallel.cohort_relative_rotations(
                    test, ref_sets, masks, masks, STEP_DEG, RANGE_DEG,
                    parallel.cohort_mesh([MESH_DEVICE]), brute)
                for label, devs in mesh_list:
                    for k in argmin_repair.stats:
                        argmin_repair.stats[k] = 0
                    with launches_by_shard() as counts:
                        t0 = time.perf_counter()
                        got = parallel.sharded_multires_search(
                            test, ref_sets, masks, masks, STEP_DEG, RANGE_DEG,
                            parallel.angle_mesh(devs), brute)
                        wall = time.perf_counter() - t0
                    answers[(tag, label)] = got
                    say("mesh", f"angle shard {mode} {tag} on {label}: {wall:.4f} s, sweep "
                                f"launches per shard {per_shard(counts, 'sweep_cost', len(devs))}, "
                                f"flagged {argmin_repair.stats['flagged']}, repaired "
                                f"{argmin_repair.stats['repaired']} (changed "
                                f"{argmin_repair.stats['changed']}); equal to the repaired "
                                f"unsharded search {np.array_equal(got, want)}")
                    check(np.array_equal(got, want),
                          f"angle shard {mode} {tag} on {label} differs from the unsharded search")
        first = answers[("f64", mesh_list[0][0])]
        check(all(np.array_equal(a, first) for a in answers.values()),
              f"angle shard {mode}: meshes or dtypes differ")
    # the brute-force table of one shard, alone
    dev = torch.device(MESH_DEVICE)
    from multimodars_torch.ops import rotation_search as rs

    ang, valid = rs.candidate_angles(torch.zeros(len(test), dtype=torch.float64, device=dev),
                                     STEP_DEG, RANGE_DEG, RANGE_DEG)
    args = (torch.as_tensor(test, dtype=torch.float32, device=dev),
            torch.as_tensor(ref_sets, dtype=torch.float32, device=dev),
            torch.as_tensor(masks, device=dev), torch.as_tensor(masks, device=dev),
            ang.to(torch.float32), valid)
    kw_t = dict(dense=False, outer_stride_test=1, outer_stride_ref=1)
    saved = sweep.launches
    ms = cuda_ms(torch, lambda: sweep.cost_table(*args, **kw_t), 3)
    sweep.launches = saved
    bound, by = sweep_bound(torch, args, kw_t)
    say("mesh", f"angle shard brute-force table f32 masked [279, 520, 520] x K {ang.shape[1]}: "
                f"kernel {ms:.3f} ms, bound {bound:.3f} ms ({by}), "
                f"{100.0 * bound / ms:.1f}% of bound (card after: {card_state()})")

    # 3. the row-sharded count at phase 8's island count shapes
    island = None
    for name, args_c, kwargs in ccta_state["calls"]:
        if name == "radius_count_batch" and not kwargs.get("flags"):
            for a_off, n, b_off, m, lo, hi in args_c[2]:
                if (n, m) == ISLAND_SHAPE:
                    island = (args_c[0][a_off:a_off + n].double().cpu().numpy(),
                              args_c[1][b_off:b_off + m].double().cpu().numpy(), lo, hi)
    check(island is not None, f"phase 8 made no {ISLAND_SHAPE} count")
    a, b, lo, hi = island
    check(lo < ISLAND_RADIUS ** 2 < hi, f"the island count's band {lo}, {hi} is not at r = 2")
    want = ck.count_within_radius(a, b, ISLAND_RADIUS)
    for label, devs in mesh_list:
        radius_count.launches = 0
        with launches_by_shard() as counts:
            got = parallel.sharded_count_within_radius(a, b, ISLAND_RADIUS,
                                                       parallel.rows_mesh(devs))
        same = np.array_equal(got, want)
        say("mesh", f"row-sharded count [{len(a)}] x [{len(b)}] r = 2 on {label}: equal to "
                    f"the unsharded count {same}, count launches per shard "
                    f"{per_shard(counts, 'radius_count', len(devs))}")
        check(same, f"the row-sharded count on {label} differs")

    # 4. the CCTA fusion row-sharded, the ray kernel's route forced
    saved_threshold = ck._RAY_NATIVE_THRESHOLD
    ck._RAY_NATIVE_THRESHOLD = {"cuda": 0}
    ray_launches = 0
    try:
        for label, devs in mesh_list:
            for mod in (radius_count, nearest, ray_triangle):
                mod.launches = 0
            with launches_by_shard() as counts, recorded_rays() as rays, \
                    parallel.shard_rows_over(parallel.rows_mesh(devs)):
                t0 = time.perf_counter()
                run = ccta_run(torch, mt, ccta_state["case"])
                wall = time.perf_counter() - t0
            ray_launches += ray_triangle.launches
            for other, what in ((ccta_state["f32"], "phase 8's unsharded f32 run"),
                                (ccta_state["cpu"], "phase 8's f64 CPU run (native DDA)")):
                same_regions = all(
                    x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
                    for x, y in ((run[0], other[0]), (run[1], other[1])))
                d = (float(np.abs(run[3].vertices - other[3].vertices).max())
                     if run[3].vertices.shape == other[3].vertices.shape else float("inf"))
                same = (same_regions and run[2] == other[2] and d == 0.0
                        and np.array_equal(run[3].faces, other[3].faces))
                check(same, f"CCTA on {label} differs from {what} (max vertex diff {d})")
            n = len(devs)
            say("mesh", f"CCTA label -> scale -> stitch f32 on {label}, ray route forced: "
                        f"{wall:.4f} s; same regions, scalings and stitched mesh (0.0 mm) as "
                        f"phase 8's f32 and f64 CPU runs; launches per shard: count "
                        f"{per_shard(counts, 'radius_count', n)}, pick "
                        f"{per_shard(counts, 'nearest', n)}, ray "
                        f"{per_shard(counts, 'ray_triangle', n)}; rays "
                        f"{', '.join(f'{len(o)} x {len(t)}' for o, _, t in rays)}")
            check(all(k > 0 for k in per_shard(counts, "ray_triangle", n)),
                  f"a shard of {label} launched no ray kernel")
    finally:
        ck._RAY_NATIVE_THRESHOLD = saved_threshold
    origins, directions, tri = rays[0]
    row = check_ray_call(torch, origins, directions, tri, "phase 8's rays")
    return ray_launches, row


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------

# the seeded mask of the public Hausdorff's second run: ~5% of the slots
# invalid and this many whole sets empty
OPS_MASK_SEED = 29
OPS_EMPTY_SETS = 5
# the pairs the CPU float64 run of the public searches takes (every 14th of
# OCT-280's 279; the card takes all of them)
OPS_CPU_PAIRS = slice(0, 279, 14)


def cdist_hausdorff_sq(torch, p, q, pmask, qmask):
    """The masked squared Hausdorff as ``torch.cdist(p, q).pow(2)`` and
    masked ``amin`` / ``amax``: a yardstick of library calls (not one call,
    and not exact: cdist may take the matrix-product form)."""
    d2 = torch.cdist(p, q).pow(2)
    inf = torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device)
    fwd = torch.where(pmask, torch.where(qmask[:, None, :], d2, inf).amin(-1), -inf).amax(-1)
    bwd = torch.where(qmask, torch.where(pmask[:, :, None], d2, inf).amin(-2), -inf).amax(-1)
    h = torch.maximum(fwd, bwd)
    return torch.where(pmask.any(-1) & qmask.any(-1), h, torch.zeros_like(h))


def phase_ops(torch, refine_inputs):
    """The ``ops`` surface on the card: the public masked Hausdorff on
    OCT-280's 279 consecutive pairs (f32 and f64, all-valid and seeded
    masks) and at the refine's grid, and the three public searches in f64,
    each against its plain version or the CPU.  Returns (sweep launches,
    refine kernel launches) of the counted run."""
    import numpy as np

    from multimodars_torch import ops
    from multimodars_torch.ops import hausdorff_batch as hb
    from multimodars_torch.ops import rotation_search as rs
    from multimodars_torch.ops import sweep
    from multimodars_torch.ops.hausdorff import hausdorff_sq_masked_plain

    dev = torch.device("cuda", 0)
    pts = np.ascontiguousarray(oct_sample_sets())
    rng = np.random.default_rng(OPS_MASK_SEED)
    seeded = rng.random(pts.shape[:2]) > 0.05
    seeded[rng.choice(len(pts), OPS_EMPTY_SETS, replace=False)] = False
    pair_inputs = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        t = torch.as_tensor(pts, dtype=dtype, device=dev)
        for label, mask in (("all valid", np.ones(pts.shape[:2], bool)),
                            (f"seeded mask, {OPS_EMPTY_SETS} sets empty", seeded)):
            m = torch.as_tensor(mask, device=dev)
            pair_inputs[(tag, label)] = (t[1:], t[:-1], m[1:], m[:-1])
    # the refine's grid: p [S, K, n, 2] against q [S, 1, m, 2]
    grid_inputs = {}
    for dtype, ((p, pmask, q, qmask), K) in refine_inputs.items():
        S = q.shape[0]
        grid_inputs[dtype] = (
            torch.as_tensor(p, dtype=dtype, device=dev).reshape(S, K, *p.shape[1:]),
            torch.as_tensor(q, dtype=dtype, device=dev)[:, None],
            torch.as_tensor(pmask, device=dev).reshape(S, K, p.shape[1]),
            torch.as_tensor(qmask, device=dev)[:, None], K)
    test, ref, tm, rm = pair_inputs[("f64", "all valid")]

    # the counted run: every launch count set to 0 just before it
    hb.launches = sweep.launches = 0
    pair_out = {key: ops.hausdorff_sq_masked(*args) for key, args in pair_inputs.items()}
    grid_out = {dtype: ops.hausdorff_sq_masked(*args[:4]) for dtype, args in grid_inputs.items()}
    best, tie = ops.multires_rotation_search(test, ref, tm, rm, STEP_DEG, RANGE_DEG)
    last = (STEP_DEG, 10.0 * STEP_DEG, best, RANGE_DEG)
    s_best, s_tie = ops.search_range_batched(test, ref, tm, rm, *last)
    angles, valid = rs.candidate_angles(best, STEP_DEG, 10.0 * STEP_DEG, RANGE_DEG)
    table = ops.rotation_cost_table(test, ref, tm, rm, angles, valid)
    torch.cuda.synchronize()
    hb_launches, sweep_launches = hb.launches, sweep.launches
    calls = len(pair_out) + len(grid_out)
    say("ops", f"counted run: {calls} public hausdorff_sq_masked calls, refine kernel "
               f"launches {hb_launches}; 3 public searches f64, sweep launches "
               f"{sweep_launches}")
    check(hb_launches == calls,
          f"{calls} public Hausdorff calls on the card made {hb_launches} kernel launches")
    check(sweep_launches > 0, "the public searches launched no sweep kernel")

    # the public Hausdorff on the pairs: = plain on the card, f64 = CPU
    for (tag, label), args in pair_inputs.items():
        got = pair_out[(tag, label)].double().cpu().numpy()
        want = hausdorff_sq_masked_plain(*args).double().cpu().numpy()
        err = float(np.abs(got - want).max())
        line = (f"public hausdorff_sq_masked {tag} {list(args[0].shape)} x "
                f"{list(args[1].shape)}, {label}: max |kernel-plain| {err:.3e}, "
                f"{int((got == 0).sum())} zero entries")
        check(err == 0.0, f"public Hausdorff {tag} {label} differs from plain")
        if tag == "f64":
            cpu = ops.hausdorff_sq_masked(*(a.cpu() for a in args)).numpy()
            same = bool(np.array_equal(got, cpu))
            line += f"; equal to the f64 CPU run bit for bit {same}"
            check(same, f"public Hausdorff f64 {label}: card differs from the CPU")
        ms = cuda_ms(torch, lambda: ops.hausdorff_sq_masked(*args), 5)
        plain_ms = cuda_ms(torch, lambda: hausdorff_sq_masked_plain(*args), 1)
        lib_ms = cuda_ms(torch, lambda: cdist_hausdorff_sq(torch, *args), 5)
        dms = device_ms(torch, lambda: ops.hausdorff_sq_masked(*args), "hausdorff_batch")
        p, q, pm, qm = args
        bound, by = refine_bound(torch, p, pm, q, qm, 1)
        old, _ = refine_bound_directed(torch, p, pm, q, qm, 1)
        say("ops", f"{line}; kernel {ms:.4f} ms by events, device {dms:.4f} ms a launch "
                   f"(one a call; host share of the events "
                   f"{100.0 * max(ms - dms, 0.0) / ms:.0f}%), bound {bound:.4f} ms ({by}; 7 "
                   f"ops a valid pair), {100.0 * bound / dms:.1f}% of bound by device time, "
                   f"{100.0 * bound / ms:.1f}% by events (the 5-op directed bound of earlier "
                   f"checkouts {old:.4f} ms), plain {plain_ms:.3f} ms, cdist composition "
                   f"(not one call) {lib_ms:.3f} ms (card after: {card_state()})")
        if label == "all valid":
            say("ops", f"public hausdorff_sq_masked {tag} on the pairs: "
                       f"{refine_plan_line(torch, hb, p, q)}")

    # the refine's grid through the public name: = phase 6's table
    for dtype, (p4, q4, pm3, qm3, K) in grid_inputs.items():
        tag = "f32" if dtype == torch.float32 else "f64"
        S, n, m = p4.shape[0], p4.shape[2], q4.shape[2]
        flat = (p4.reshape(S * K, n, 2), pm3.reshape(S * K, n), q4[:, 0], qm3[:, 0])
        want = hb.hausdorff_sq_shared_ref(*flat, K)
        got = grid_out[dtype]
        same = bool(torch.equal(got.reshape(-1), want))
        ms = cuda_ms(torch, lambda: ops.hausdorff_sq_masked(p4, q4, pm3, qm3), 5)
        table_ms = cuda_ms(torch, lambda: hb.hausdorff_sq_shared_ref(*flat, K), 5)
        bound, by = refine_bound(torch, *flat, K)
        old, _ = refine_bound_directed(torch, *flat, K)
        say("ops", f"public hausdorff_sq_masked {tag} refine grid p [{S}, {K}, {n}, 2] "
                   f"x q [{S}, 1, {m}, 2] -> {tuple(got.shape)}: equal to phase 6's "
                   f"table bit for bit {same}; public {ms:.3f} ms, table {table_ms:.3f} ms, "
                   f"bound {bound:.3f} ms ({by}; 7 ops a valid pair), {100.0 * bound / ms:.1f}% "
                   f"of bound (the 5-op directed bound of earlier checkouts {old:.3f} ms) "
                   f"(card after: {card_state()})")
        check(same, f"public Hausdorff {tag} on the refine grid differs from the table")

    # the public searches: the card's grid angles and flags = the CPU's
    rows = OPS_CPU_PAIRS
    cpu = [a[rows].cpu() for a in (test, ref, tm, rm)]
    c_best, c_tie = ops.multires_rotation_search(*cpu, STEP_DEG, RANGE_DEG)
    c_sbest, c_stie = ops.search_range_batched(*cpu, STEP_DEG, 10.0 * STEP_DEG, c_best,
                                               RANGE_DEG)
    c_angles, c_valid = rs.candidate_angles(c_best, STEP_DEG, 10.0 * STEP_DEG, RANGE_DEG)
    c_table = ops.rotation_cost_table(*cpu, c_angles, c_valid).numpy()
    k_table = table[rows].cpu().numpy()
    fin = np.isfinite(c_table)
    rel = float((np.abs(k_table[fin] - c_table[fin]) / c_table[fin]).max())
    checks = {
        "multires_rotation_search angles": torch.equal(best[rows].cpu(), c_best),
        "multires_rotation_search flags": torch.equal(tie[rows].cpu(), c_tie),
        "search_range_batched angles": torch.equal(s_best[rows].cpu(), c_sbest),
        "search_range_batched flags": torch.equal(s_tie[rows].cpu(), c_stie),
        "rotation_cost_table argmins": bool(
            (k_table.argmin(1) == c_table.argmin(1)).all()
            and (np.isinf(k_table) == np.isinf(c_table)).all()),
        "rotation_cost_table rel <= 1e-12": rel <= 1e-12,
    }
    say("ops", f"public searches f64 (step {STEP_DEG} deg, range {RANGE_DEG} deg; the "
               f"last stage's window K {angles.shape[1]}) on the card against the CPU on "
               f"{len(c_best)} of {len(test)} pairs: {checks}; flagged on the card "
               f"{int(tie.sum())} / {int(s_tie.sum())}; cost table max rel {rel:.3e}")
    for name, ok in checks.items():
        check(ok, f"public searches: {name} differ between the card and the CPU")
    return sweep_launches, hb_launches


# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------

# the float32 band of earlier checkouts (_TIE_C 8, no floor): the flags,
# repairs and fallbacks it gives are printed beside the derived band's
OLD_BAND_F32 = (8.0, 0.0)


@contextlib.contextmanager
def f32_band(torch, rs, tie_c, floor):
    """The f32 certification band of ``ops.rotation_search`` set to
    ``tie_c`` units and ``floor`` for the block."""
    saved = rs._TIE_C[torch.float32], rs._TIE_FLOOR_F32
    rs._TIE_C[torch.float32], rs._TIE_FLOOR_F32 = tie_c, floor
    try:
        yield
    finally:
        rs._TIE_C[torch.float32], rs._TIE_FLOOR_F32 = saved


def band_family(np):
    """The seeded adversarial sets of tests/test_torch_band.py, f64: per
    point radius 0.5, 2 and 10 mm, 20-point catheter rings with relative
    noise 1e-6 and 1e-5 whose test ring is turned by a multiple of 18
    degrees, and the 16-point quarter-turn set against itself and its 1.01
    scaling; and the four diagonal points at (+-1.6, +-1.6), which a turn by
    the f64 grid's -90 degrees maps onto themselves exactly in f64 only.
    Each a (name, test [F, 20 or 16, 2], ref) batch."""
    out = []
    th20 = np.linspace(0, 2 * np.pi, 20, endpoint=False)
    th16 = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    for radius in (0.5, 2.0, 10.0):
        rng = np.random.default_rng(int(radius * 1000) + 5)
        ring = radius * np.stack([np.cos(th20), np.sin(th20)], -1)
        for noise in (1e-6, 1e-5):
            refs, tests = [], []
            for _ in range(6):
                r = ring + rng.normal(0, noise * radius, ring.shape)
                a = 2 * np.pi * rng.integers(0, 20) / 20
                turn = np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
                refs.append(r)
                tests.append(r @ turn + rng.normal(0, noise * radius, r.shape))
            out.append((f"rings r {radius} noise {noise:g}", np.stack(tests), np.stack(refs)))
        q = radius * (1 + 0.3 * np.cos(4 * th16)) / 1.3
        sq = np.stack([np.cos(th16) * q, np.sin(th16) * q], -1)
        out.append((f"quarter-turn r {radius}", np.stack([sq, sq * 1.01, sq]),
                    np.stack([sq, sq, sq])))
    diag = np.array([[1.6, 1.6], [-1.6, 1.6], [-1.6, -1.6], [1.6, -1.6]])
    out.append(("diagonal quarter-turn", diag[None], diag[None]))
    return out


# the family's grids: the coarse ladder stage over +-180 degrees, and a fine
# grid across +-pi (where the f32 cast of the angle errs most)
BAND_GRIDS = ((0.0, 1.0, 180.0), (math.pi - 0.01, 0.01, 3.0))


def band_tables(torch, sweep, rs, args, kw):
    """(f64 table, f32 table, f32 scale2) of one cost table's arguments on
    the card: the kernel on the f64 inputs and on the same inputs cast to
    f32, as the f32 search casts its sets and its f64 grid."""
    test, ref, tm, rm, angles, valid = args
    t64 = sweep.cost_table(test.double(), ref.double(), tm, rm, angles.double(), valid, **kw)
    t32 = sweep.cost_table(test.float(), ref.float(), tm, rm, angles.float(), valid, **kw)
    return t64, t32, rs._point_scale2(test.float(), ref.float())


def band_check(torch, rs, t64, t32, s2, valid, exact):
    """Per table: (largest |f32 - f64| in units of the derived bound,
    entries, rows, rows flagged by the new / old band, f32 argmin != f64
    argmin, of those unflagged by the new / old band, rows of the f64
    table flagged by the f64 band and by the same derivation at eps64 with
    no 1e-14 floor, by the first only and by the second only).  Argmins and
    flags count on exact tables only (a lower-bound table decides no
    argmin)."""
    import numpy as np

    a64 = t64.double().cpu().numpy()
    a32 = t32.double().cpu().numpy()
    check((np.isinf(a64) == np.isinf(a32)).all(), "f32 and f64 tables differ in inf slots")
    sc = s2.double().cpu().numpy()[:, None]
    fin = np.isfinite(a64)
    bound = np.broadcast_to(rs._f32_error_bound(np.where(fin, a64, 0.0), sc), a64.shape)
    err = np.abs(a32[fin] - a64[fin])
    units = float((err / np.maximum(bound[fin], 1e-300)).max()) if fin.any() else 0.0
    live = valid.any(dim=1)
    m = t32.amin(dim=1)
    flag_new = rs._tie_flags(t32, m, s2, live).cpu().numpy()
    with f32_band(torch, rs, *OLD_BAND_F32):
        flag_old = rs._tie_flags(t32, m, s2, live).cpu().numpy()
    m64 = t64.amin(dim=1)
    s64 = s2.double()
    flag64 = rs._tie_flags(t64, m64, s64, live).cpu().numpy()
    eps64 = float(torch.finfo(torch.float64).eps)
    native = (rs._TIE_C[torch.float32] * eps64 * (torch.sqrt(torch.clamp(s64 * m64, min=0.0)) + m64)
              + rs._TIE_FLOOR_F32 * eps64 * eps64 * s64)
    flag_native = (((t64 <= (m64 + native)[:, None]).sum(dim=1) > 1) & live).cpu().numpy()
    rows = fin.any(axis=1) & exact
    swap = rows & (a32.argmin(axis=1) != a64.argmin(axis=1))
    return np.array([units, int(fin.sum()), int(rows.sum()), int((flag_new & rows).sum()),
                     int((flag_old & rows).sum()), int(swap.sum()),
                     int((swap & ~flag_new).sum()), int((swap & ~flag_old).sum()),
                     int((flag64 & rows).sum()), int((flag_native & rows).sum()),
                     int((flag64 & ~flag_native & rows).sum()),
                     int((flag_native & ~flag64 & rows).sum())])


# rows of an exact f64 table whose argmin phase 11 also takes from the plain
# version on the CPU: every row while the table has at most this many point
# pairs; past it the rows whose runner-up lies within BAND64_NEAR times the
# derived f64 band of the minimum (two f64 tables each within the derived
# bound of the exact costs can order no other row differently) and every
# BAND64_EVERY-th row
BAND64_CPU_PAIRS = 3e8
BAND64_NEAR = 16.0
BAND64_EVERY = 64


def band64_cpu(torch, sweep, rs, args, kw, t64, s2, live):
    """The card kernel's f64 argmin against the plain version's f64 argmin
    on the CPU, on the rows of one exact table (see BAND64_CPU_PAIRS):
    [rows compared, rows, rows whose index differs, of those flagged by the
    f64 band in force (the JAX package's), by the derived f64 band]."""
    import numpy as np

    s64 = s2.double()
    m = t64.amin(dim=1)
    # the f32 band's derivation at eps64, two-sided (the comment above
    # ops.rotation_search._TIE_C)
    eps = float(torch.finfo(torch.float64).eps)
    derived = (eps * (20.84 * torch.sqrt(torch.clamp(s64 * m, min=0.0)) + 4.02 * m)
               + 485.1 * eps * eps * s64)

    def near(width):
        return ((t64 <= (m + width)[:, None]).sum(dim=1) > 1) & live

    flag_band = rs._tie_flags(t64, m, s64, live)
    flag_derived = near(derived)
    F, K = t64.shape
    rows = torch.ones(F, dtype=torch.bool, device=t64.device)
    if F * K * args[0].shape[1] * args[1].shape[1] > BAND64_CPU_PAIRS:
        every = torch.arange(F, device=t64.device) % BAND64_EVERY == 0
        rows = near(BAND64_NEAR * derived) | every
    rows &= torch.isfinite(m)
    idx = torch.nonzero(rows)[:, 0]
    cpu = [None if a is None else a[idx].cpu() for a in args]
    cpu[0], cpu[1], cpu[4] = cpu[0].double(), cpu[1].double(), cpu[4].double()
    plain = sweep.cost_table_plain(*cpu, **kw)
    differ = (t64[idx].cpu().argmin(dim=1) != plain.argmin(dim=1)).numpy()
    return np.array([len(idx), F, int(differ.sum()),
                     int((differ & flag_band[idx].cpu().numpy()).sum()),
                     int((differ & flag_derived[idx].cpu().numpy()).sum())])


def band64_cpu_line(res):
    return (f"card f64 argmin vs CPU f64 argmin: rows compared {int(res[0])} of "
            f"{int(res[1])}, index differs in {int(res[2])}, of those flagged by the f64 "
            f"band (the JAX package's) {int(res[3])}, by the derived f64 band {int(res[4])}")


def band64_line(res):
    return (f"f64 rows flagged by the f64 band (1e-14 floor) {int(res[8])}, by the "
            f"derivation at eps64 {int(res[9])}, by the first only {int(res[10])}, by the "
            f"second only {int(res[11])}")


def band_paths(mt):
    """The searches the phase drives in f32 and f64: ``(name, run,
    coordinates of its output)``: the single, full and cohort paths of
    phases 3, 5 and 7, and the vendored fixtures."""
    import numpy as np


    fixtures = REPO / "tests" / "data" / "fixtures"
    oct_single = mt.numpy_to_inputdata(*synthetic_oct_pullback(OCT_FRAMES, OCT_POINTS), True,
                                       label="oct280")
    full = full_inputs(mt)
    cohort = cohort_datas(mt)
    real_single = real_single_data(mt)[2]
    real_full = real_fixture_datas(mt, OCT_FRAMES)
    return [
        ("OCT-280 single", lambda: quiet(mt.from_array_single, oct_single, **MAIN_ARGS),
         lambda out: lumen_coords(out[0])),
        (f"{REAL_CASE} single",
         lambda: quiet(mt.from_array_single, real_single, **MAIN_ARGS),
         lambda out: lumen_coords(out[0])),
        ("4 x real-fixture-280 full", lambda: quiet(mt.from_array_full, *real_full, **FULL_ARGS),
         lambda out: pair_coords(out[:4])),
        ("4 x OCT-280 full", lambda: quiet(mt.from_array_full, *full, **FULL_ARGS),
         lambda out: pair_coords(out[:4])),
        ("16 x OCT-280 cohort",
         lambda: quiet(mt.from_array_cohort, cohort, step_rotation_deg=FULL_STEP,
                       range_rotation_deg=FULL_RANGE, sample_size=500, smooth=True),
         lambda out: np.concatenate([lumen_coords(g) for g, _, _ in out])),
        ("ivus_rest + ivus_stress full",
         lambda: quiet(mt.from_file_full, str(fixtures / "ivus_rest"),
                       str(fixtures / "ivus_stress"), write_obj=False),
         lambda out: pair_coords(out[:4])),
        # its systolic reference point names no frame of its contours
        ("ivus_full diastolic single",
         lambda: quiet(mt.from_file_single, str(fixtures / "ivus_full"), diastole=True,
                       write_obj=False),
         lambda out: lumen_coords(out[0])),
    ]


def band_search_run(torch, sweep, rs, run, coords):
    """One f32 run of a path under the band in force: its repair counters,
    pruned stages and fallbacks, the f64 re-search tables it launched, the
    host seconds of its repair spans and the events ms of re-running those
    f64 tables, and its output coordinates."""
    from multimodars_torch.ops import argmin_repair
    from multimodars_torch.utils import trace

    for k in argmin_repair.stats:
        argmin_repair.stats[k] = 0
    for k in rs.prune_stats:
        rs.prune_stats[k] = 0
    trace.reset()
    with recorded_tables(sweep) as seen:
        out = run()
        torch.cuda.synchronize()
    stats = {k: argmin_repair.stats.get(k, 0) for k in ("flagged", "repaired", "host_exact",
                                                        "changed")}
    stats.update(pruned=rs.prune_stats["stages"], fallbacks=rs.prune_stats["fallbacks"])
    re64 = [(a, k) for a, k in seen if a[0].dtype == torch.float64]
    stats["f64_tables"] = len(re64)
    # the stages' own repair spans; argmin_repair.* nest inside them
    stats["repair_s"] = sum(v[0] for k, v in trace.summary().items()
                            if "repair" in k and not k.startswith("argmin_repair."))
    stats["f64_table_ms"] = sum(cuda_ms(torch, lambda: sweep.cost_table(*a, **k), 1)
                                for a, k in re64)
    return stats, coords(out)


def phase_band(torch, sweep, rs, mt):
    """The f32 certification band against the f32 kernel's own errors: every
    cost table of the f64 runs of the band paths, and the adversarial
    family, on the kernel in f32 and f64; then each path in f32 under the
    derived band and under the old one."""
    import numpy as np

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    say("band", f"card: {smi.stdout.strip()}; f32 band {rs._TIE_C[torch.float32]} units + "
                f"{rs._TIE_FLOOR_F32} eps^2 scale2 (old {OLD_BAND_F32[0]} units, no floor); "
                f"per-entry bound eps (A r sqrt(c) + B c) + E eps^2 r^2, A {rs._F32_ERR_A}, "
                f"B {rs._F32_ERR_B}, E {rs._F32_ERR_E}")
    paths = band_paths(mt)
    dev = torch.device("cuda", 0)
    total = np.zeros(12)
    total64 = np.zeros(5)
    ref64 = {}
    for name, run, coords in paths:
        with mt.config.use(dtype=torch.float64), recorded_tables(sweep) as seen:
            ref64[name] = coords(run())
        res = np.zeros(12)
        res64 = np.zeros(5)
        for args, kw in seen:
            kw = dict(dict(dense=False, outer_stride_test=1, outer_stride_ref=1), **kw)
            t64, t32, s2 = band_tables(torch, sweep, rs, args, kw)
            exact = kw["outer_stride_test"] == kw["outer_stride_ref"] == 1
            r = band_check(torch, rs, t64, t32, s2, args[5], exact)
            res = np.concatenate([[max(res[0], r[0])], res[1:] + r[1:]])
            if exact:
                res64 += band64_cpu(torch, sweep, rs, args, kw, t64, s2, args[5].any(dim=1))
        say("band", f"{name}: {len(seen)} tables of the f64 run, {int(res[1])} entries: "
                    f"max |f32 - f64| {res[0]:.4f} units of the derived bound; exact-table rows "
                    f"{int(res[2])}, flagged new / old band {int(res[3])} / {int(res[4])}; "
                    f"f32 argmin != f64 argmin {int(res[5])}, unflagged new {int(res[6])}, "
                    f"old {int(res[7])}; {band64_line(res)}")
        say("band", f"{name}: {band64_cpu_line(res64)}")
        total = np.concatenate([[max(total[0], res[0])], total[1:] + res[1:]])
        total64 += res64
    for name, test, ref in band_family(np):
        res = np.zeros(12)
        res64 = np.zeros(5)
        plain_units = 0.0
        for g in BAND_GRIDS:
            F = test.shape[0]
            angles, valid = rs.candidate_angles(
                torch.full((F,), g[0], dtype=torch.float64, device=dev), g[1], g[2], 180.0)
            args = (torch.as_tensor(test, device=dev), torch.as_tensor(ref, device=dev),
                    None, None, angles, valid)
            kw = dict(dense=True, outer_stride_test=1, outer_stride_ref=1)
            t64, t32, s2 = band_tables(torch, sweep, rs, args, kw)
            r = band_check(torch, rs, t64, t32, s2, valid, True)
            res = np.concatenate([[max(res[0], r[0])], res[1:] + r[1:]])
            p32 = sweep.cost_table_plain(args[0].float(), args[1].float(), None, None,
                                         angles.float(), valid, dense=True)
            plain_units = max(plain_units, band_check(torch, rs, t64, p32, s2, valid, True)[0])
            res64 += band64_cpu(torch, sweep, rs, args, kw, t64, s2, valid.any(dim=1))
        say("band", f"family {name}: {int(res[1])} entries, max |f32 - f64| {res[0]:.4f} units "
                    f"(plain version on the card {plain_units:.4f}); rows {int(res[2])}, "
                    f"flagged new / old {int(res[3])} / {int(res[4])}; argmin swaps "
                    f"{int(res[5])}, unflagged new {int(res[6])}, old {int(res[7])}; "
                    f"{band64_line(res)}; {band64_cpu_line(res64)}")
        total64 += res64
        check(plain_units <= 1.0, f"family {name}: the plain f32 table exceeds the bound")
        total = np.concatenate([[max(total[0], res[0])], total[1:] + res[1:]])
    say("band", f"all tables: max |f32 - f64| {total[0]:.4f} units of the derived bound over "
                f"{int(total[1])} entries; f32 argmin != f64 argmin in {int(total[5])} rows, "
                f"unflagged under the derived band {int(total[6])}, under the old band "
                f"{int(total[7])}; {band64_line(total)}")
    say("band", f"all exact tables: {band64_cpu_line(total64)}; unflagged by the f64 band "
                f"{int(total64[2] - total64[3])}")
    check(total[0] <= 1.0, f"an f32 entry is off by {total[0]:.4f} units of the derived bound")
    check(total[6] == 0, f"{int(total[6])} f32 argmin swaps left unflagged by the band")
    check(total64[2] == total64[3],
          f"{int(total64[2] - total64[3])} rows whose card f64 argmin differs from the CPU's "
          f"are left unflagged by the f64 band")

    for name, run, coords in paths:
        got = {}
        for label, band in (("derived", (rs._TIE_C[torch.float32], rs._TIE_FLOOR_F32)),
                            ("old", OLD_BAND_F32)):
            with f32_band(torch, rs, *band):
                stats, xyz = band_search_run(torch, sweep, rs, run, coords)
            d = float(np.abs(xyz - ref64[name]).max())
            got[label] = (stats, d)
            say("band", f"{name} f32, {label} band: flagged (each re-searched in f64) "
                        f"{stats['flagged']}, settled in f64 "
                        f"{stats['repaired'] - stats['host_exact']}, host-exact "
                        f"{stats['host_exact']}, changed {stats['changed']}; pruned stages "
                        f"{stats['pruned']}, fallbacks {stats['fallbacks']}; f64 re-search "
                        f"tables {stats['f64_tables']} ({stats['f64_table_ms']:.4f} ms by "
                        f"events); repair spans {stats['repair_s']:.4f} s host; max |coord - "
                        f"f64 run| {d:.3e} mm")
        new, old = got["derived"][0], got["old"][0]
        say("band", f"{name}: the derived band's extra work: flagged "
                    f"{new['flagged'] - old['flagged']:+d}, f64 re-search tables "
                    f"{new['f64_tables'] - old['f64_tables']:+d} "
                    f"({new['f64_table_ms'] - old['f64_table_ms']:+.4f} ms), host-exact "
                    f"{new['host_exact'] - old['host_exact']:+d}, fallbacks "
                    f"{new['fallbacks'] - old['fallbacks']:+d}, repair spans "
                    f"{new['repair_s'] - old['repair_s']:+.4f} s")
        check(got["derived"][1] <= 1e-4,
              f"{name}: f32 under the derived band differs from f64 by {got['derived'][1]} mm")
# ---------------------------------------------------------------------------
# phase 12
# ---------------------------------------------------------------------------

# every this-many-th within pair of phase 12's single path also goes through
# the exact host f64 ladder (every flagged pair does)
REAL_LADDER_EVERY = 14


def real_single_data(mt):
    """Phase 12's single pullback: lumen rows, reference point, input data."""
    lumen, ref = real_fixture_pullback(FIXTURES / "ivus_rest" / "diastolic_contours.csv",
                                       OCT_FRAMES)
    return lumen, ref, mt.numpy_to_inputdata(lumen, ref, True, label="real280")


def phase_real(torch, sweep, rs, mt, profile=False):
    """Phase 12, the real-fixture pullback: ``from_array_single`` at the
    smoke's arguments in f32 and f64 on the card and f64 on the CPU (the
    same grid index in every within pair, f32 swaps flagged and settled,
    coordinates within 1e-4 mm, repair and pruning counters, the exact
    host ladder on every flagged and every 14th pair, the kernel against
    plain at the case's tables, wall clock and spans), then
    ``from_array_full`` on the four real-fixture pullbacks (phase 5's
    checks).  Returns the sweep launches of the counted card runs."""
    import numpy as np

    from multimodars_torch.ops import argmin_repair
    from multimodars_torch.ops.argmin_repair import exact_ladder
    from multimodars_torch.pipelines import align_within
    from multimodars_torch.utils import trace

    lumen, ref, data = real_single_data(mt)
    pts, mask = sample_sets(lumen, ref, "real280")
    frames = np.unique(lumen[:, 0])
    say("real", f"{REAL_CASE}: {len(frames)} frames x {int((lumen[:, 0] == 0).sum())} "
                f"points, sample sets {list(pts.shape)} "
                f"({'masked' if mask is not None else 'dense'})")

    def run(dtype=None, device=None):
        with mt.config.use(device=device, dtype=dtype):
            out = quiet(mt.from_array_single, data, **MAIN_ARGS)
        if device is None:
            torch.cuda.synchronize()
        return out

    runs = {}
    for label, dtype, device in (("f32 card", torch.float32, None),
                                 ("f64 card", torch.float64, None),
                                 ("f64 CPU", torch.float64, "cpu")):
        # the counted run: every launch count set to 0 just before it
        reset_counters(sweep, argmin_repair, trace)
        for k in rs.prune_stats:
            rs.prune_stats[k] = 0
        with recorded_repairs(align_within) as seen, recorded_tables(sweep) as tables:
            t0 = time.perf_counter()
            geom, logs = run(dtype, device)
            secs = time.perf_counter() - t0
        check(len(seen) == 1, f"{label}: {len(seen)} within chains repaired")
        stats = dict({k: argmin_repair.stats.get(k, 0)
                      for k in ("flagged", "repaired", "changed", "host_exact")},
                     f64_tables=sum(a[0].dtype == torch.float64 for a, _ in tables)
                     if dtype == torch.float32 else 0,
                     pruned=rs.prune_stats["stages"], fallbacks=rs.prune_stats["fallbacks"])
        runs[label] = dict(geom=geom, logs=logs, chain=seen[0], tables=tables, stats=stats,
                           launches=sweep.launches, seconds=secs)
        say("real", f"single {label}: {secs:.3f} s (first run), sweep kernel launches "
                    f"{sweep.launches}; repair {stats} (f64_tables: the f64 re-search "
                    f"tables; fallbacks: pruned stages that swept every candidate)")
    check(runs["f32 card"]["launches"] > 0 and runs["f64 card"]["launches"] > 0,
          "the real-fixture path launched no sweep kernel on the card")
    check(runs["f64 CPU"]["launches"] == 0, "the CPU run launched a kernel")
    c32 = lumen_coords(runs["f32 card"]["geom"])
    check(c32.shape == (OCT_FRAMES * int((lumen[:, 0] == 0).sum()), 3)
          and np.isfinite(c32).all(), "output coordinates not finite or of the wrong shape")
    want = runs["f64 CPU"]["chain"][2]
    for label in ("f32 card", "f64 card"):
        raw, flags, settled = runs[label]["chain"]
        same = bool(np.array_equal(grid_steps(settled, STEP_DEG), grid_steps(want, STEP_DEG)))
        unflagged, settled_swaps = unsettled_swaps(raw, flags, want, STEP_DEG)
        d_xyz = float(np.abs(lumen_coords(runs[label]["geom"])
                             - lumen_coords(runs["f64 CPU"]["geom"])).max())
        say("real", f"single {label} vs f64 CPU: same grid index in every within pair {same}; "
                    f"searched angles on another index {unflagged + settled_swaps} "
                    f"(flagged and settled {settled_swaps}, unflagged {unflagged}); max "
                    f"|coord diff| {d_xyz:.3e} mm")
        check(same, f"{label} and f64 CPU land on different grid indices")
        check(unflagged == 0, f"{label}: {unflagged} unflagged searched angles off the grid index")
        check(d_xyz <= 1e-4, f"{label} vs f64 CPU coordinates differ by {d_xyz} mm")

    # the exact host f64 ladder on every flagged and every 14th pair
    raw32, flags32, settled32 = runs["f32 card"]["chain"]
    idx = sorted(set(np.nonzero(flags32)[0].tolist())
                 | set(range(0, len(settled32), REAL_LADDER_EVERY)))
    t0 = time.perf_counter()
    worst = 0.0
    for i in idx:
        t = pts[i + 1] if mask is None else pts[i + 1][mask[i + 1]]
        r = pts[i] if mask is None else pts[i][mask[i]]
        exact = exact_ladder(t, r, STEP_DEG, RANGE_DEG, False)
        worst = max(worst, abs(math.degrees(exact - settled32[i])))
        check(abs(math.degrees(exact - settled32[i])) < 1e-4,
              f"pair {i}: port {math.degrees(settled32[i])} deg, exact host ladder "
              f"{math.degrees(exact)} deg")
    say("real", f"exact host f64 ladder agrees on {len(idx)} pairs ({int(flags32.sum())} "
                f"flagged, every {REAL_LADDER_EVERY}th): max |diff| {worst:.3e} deg "
                f"({time.perf_counter() - t0:.1f} s)")

    # the kernel against plain at this case's tables (f32 run, f64 run)
    err = 0.0
    seen_keys = set()
    for label in ("f32 card", "f64 card"):
        for args, kw in runs[label]["tables"]:
            kw = dict(dict(dense=False, outer_stride_test=1, outer_stride_ref=1), **kw)
            key = table_name(torch, args, kw)
            if key in seen_keys:
                continue
            seen_keys.add(key)
            saved = sweep.launches
            e, _, _ = check_table(torch, sweep, rs, f"real {key}", args, kw, 3, phase="real")
            sweep.launches = saved  # launches made to compare with plain do not count
            err = max(err, e)
    report_tables(torch, sweep, "real single", runs["f32 card"]["tables"])

    for _ in range(2):
        run()
    trace.reset()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[2]
    say("real", f"single wall clock f32, median of 5 after 2 warm-ups: {med:.4f} s "
                f"(runs {', '.join(f'{t:.4f}' for t in times)}); f64 CPU run "
                f"{runs['f64 CPU']['seconds']:.3f} s")
    say("real", "mean spans of those runs (s): " + ", ".join(
        f"{k} {v[0] / v[1]:.4f}"
        for k, v in sorted(trace.summary().items(), key=lambda kv: -kv[1][0])))
    if profile:
        profile_main_path(torch, run, "real_profile.json")

    # its wall clock takes fewer runs than phase 5's: the smoke's time more
    # than doubled with phases 8 and 12, mostly their single f64 CPU runs
    full_launches, _, _ = phase_full_path(
        torch, sweep, mt, profile, datas=real_fixture_datas(mt, OCT_FRAMES), tag="real",
        warm=1, reps=3)
    return runs["f32 card"]["launches"] + full_launches, err


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
    from multimodars_torch.ops import morph_sweep, nearest, radius_count, ray_triangle
    from multimodars_torch.ops import rotation_search as rs
    from multimodars_torch.ops import sweep

    # a failed check raises SmokeFailure out of main(): the traceback names
    # the phase and the process exits non-zero
    with peak_memory(torch, "1 (environment, kernel builds)"):
        phase_environment(torch, sweep, hb, (radius_count, nearest, morph_sweep, ray_triangle))
    with peak_memory(torch, "2 (kernel against plain)"):
        kres = phase_kernel(torch, sweep, rs)
    launches = hb_launches = ray_launches = None
    if args.only == "kernel":
        res = [check_refine_table(torch, hb, dtype, *synthetic_refine_tables())
               for dtype in (torch.float32, torch.float64)]
        hres = dict(max_abs_err=max(r[0] for r in res), ms=res[0][1],
                    plain_ms=res[0][2], bound_ms=res[0][3][0], bound_by=res[0][3][1])
        ccta_launches = {}
        cres = report_ccta_calls(torch, synthetic_ccta_calls(torch), ccta_launches)
        rres = synthetic_ray_call(torch)
    else:
        with peak_memory(torch, "3 (OCT-280 single)"):
            launches, _ = phase_main_path(torch, sweep, mt, args.profile)
        with peak_memory(torch, "4 (fixture across devices)"):
            phase_cross_device(torch, mt)
        with peak_memory(torch, "5 (4 x OCT-280 full)"):
            full_launches, clouds, pair_ab = phase_full_path(torch, sweep, mt, args.profile)
            launches += full_launches
            kres["max_abs_err"] = max(
                kres["max_abs_err"], phase_full_kernel(torch, sweep, rs, mt, clouds[:2])
            )
            phase_full_cross_device(torch, mt)
        with peak_memory(torch, "6 (centerline)"):
            hb_launches, chain_launches, hres, refine_inputs = phase_centerline(
                torch, hb, mt, pair_ab, args.profile)
            launches += chain_launches
        with peak_memory(torch, "7 (cohort)"):
            cohort_launches, err = phase_cohort(torch, sweep, rs, mt, args.profile)
            launches += cohort_launches
            kres["max_abs_err"] = max(kres["max_abs_err"], err)
        with peak_memory(torch, "8 (CCTA, 57,606 vertices, and its tree)"):
            ccta_launches, cres, ccta_state = phase_ccta(torch, mt, args.profile)
        with peak_memory(torch, "8 (CCTA, 160,006 vertices)"):
            large_launches, large_kres, large_rres = phase_ccta_large(torch, mt)
        with peak_memory(torch, "8 (side-branch tree)"):
            side_launches = phase_side_tree(torch, mt)
        for name in ccta_launches:
            ccta_launches[name] += large_launches[name] + side_launches.get(name, 0)
        for kernel, row in large_kres.items():
            err = max(cres[kernel]["max_abs_err"], row["max_abs_err"])
            if row["bound_ms"] > cres[kernel]["bound_ms"]:
                cres[kernel] = row
            cres[kernel]["max_abs_err"] = err
        with peak_memory(torch, "9 (meshes)"):
            mesh_ray_launches, rres = phase_mesh(torch, mt, ccta_state)
        rres["max_abs_err"] = max(rres["max_abs_err"], large_rres["max_abs_err"])
        # phase 8's counted runs and phase 9's three counted runs
        ray_launches = ccta_launches["ray_triangle"] + mesh_ray_launches
        with peak_memory(torch, "10 (ops surface)"):
            ops_sweep_launches, ops_hb_launches = phase_ops(torch, refine_inputs)
        launches += ops_sweep_launches
        hb_launches += ops_hb_launches
        # phase 12 runs before phase 11, whose band check takes its case
        with peak_memory(torch, "12 (real-fixture pullback)"):
            real_launches, err = phase_real(torch, sweep, rs, mt, args.profile)
        launches += real_launches
        kres["max_abs_err"] = max(kres["max_abs_err"], err)
        with peak_memory(torch, "11 (certification bands)"):
            phase_band(torch, sweep, rs, mt)
    rres["max_abs_err"] = max(rres["max_abs_err"], adversarial_ray_call(torch)["max_abs_err"])
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
    } for name in ("radius_count", "nearest", "morph_sweep")] + [{
        "name": "ray_triangle",
        "route": "cuda",
        "source": "multimodars_torch/csrc/ray_triangle.cu",
        "replaces": RAY_REPLACES,
        "launches": ray_launches,
        "max_abs_err": rres["max_abs_err"],
        "ms": rres["ms"],
        "plain_ms": rres["plain_ms"],
        "bound_ms": rres["bound_ms"],
        "bound_by": rres["bound_by"],
        # no single PyTorch call computes the hits
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
