#!/usr/bin/env python3
"""Time the sweep kernel of one checkout at the main path's table shapes.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 sweep_bench.py                    # this checkout's kernel
    python3 sweep_bench.py --root OTHER_TREE  # another checkout's kernel

It imports ``multimodars_torch.ops.sweep`` from ``--root`` (default: the
directory of this script), builds its kernel, and times
``sweep.cost_table`` on seeded ring-shaped point sets at the shapes the
single, four-phase and cohort paths give it (chip_smoke.py records them
from the runs themselves): CUDA events around 5 calls in a row, the median
of 3 such windows, the bound and its share as chip_smoke.py computes them.
To compare two versions, time them in one run on one card, in turns:
parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import math
import sys
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose multimodars_torch is timed")
    ap.add_argument("--tag", default="", help="label printed on every line")
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
