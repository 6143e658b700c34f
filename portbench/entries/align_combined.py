"""Entry ``align_combined``: one pullback a case registered onto a CCTA
centerline and the vessel's surface points, through the port's
``multimodars_torch.align_combined``, judged by
``reference/centerline_combined``.  The same six functions as
``from_array_single``'s."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import centerline_combined


def call_args(raw: dict) -> dict:
    """The configuration's ``args`` as the entry's keywords."""
    return dict(raw)


def run_case(mt, case, args, sync):
    """Convert the pullback's arrays and read the centerline file, register
    the pullback, wait for the card (``sync``)."""
    with torch.profiler.record_function("convert"):
        geom = mt.numpy_to_geometry(case["lumen"], reference_arr=case["ref"])
        cl = mt.read_centerline_vtp(case["centerline"])
    with torch.profiler.record_function("entry"):
        out = mt.align_combined(cl, geom, *case["landmarks"], case["cloud"], **args)
    with torch.profiler.record_function("pull"):
        sync()
    return out


def searches(case) -> int:
    """One refine grid a case."""
    return 1


def answer(out) -> dict:
    """The registered geometry's coordinates by contour kind [F, P, 3] and
    its frame centroids [F, 3], in float64."""
    geom, _ = out
    coords = {"Lumen": np.stack([f.lumen.xyz_view() for f in geom.frames]).astype(np.float64)}
    for kind in geom.frames[0].extras:
        coords[kind] = np.stack([f.extras[kind].xyz_view() for f in geom.frames])
    return {"coords": coords,
            "centroids": np.array([f.centroid for f in geom.frames], dtype=np.float64)}


def judge(case, ans, args, device) -> dict:
    return centerline_combined.judge(case, ans, args, device)


def control(case, args, device) -> dict:
    """The reference in the program's place, one precision below the
    program's: a bfloat16 Hausdorff table (the program's is float32) and
    float32 geometry (the program's host arithmetic is float64)."""
    return centerline_combined.register(case, args, device, torch.bfloat16, np.float32)
