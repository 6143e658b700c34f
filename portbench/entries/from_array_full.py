"""Entry ``from_array_full``: four pullbacks a case (rest and stress,
diastole and systole), through the port's
``multimodars_torch.from_array_full``, judged by ``reference/oct_full``.
The same six functions as ``from_array_single``'s."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import oct_full


def call_args(raw: dict) -> dict:
    """The configuration's ``args`` as the entry's keywords."""
    return {**raw, "image_center": tuple(raw["image_center"])}


def run_case(mt, case, args, sync):
    """Convert the four pullbacks' arrays, register them, wait for the card
    (``sync``)."""
    with torch.profiler.record_function("convert"):
        datas = [mt.numpy_to_inputdata(lumen, ref, diastole, label=label)
                 for label, lumen, ref, diastole in case]
    with torch.profiler.record_function("entry"):
        out = mt.from_array_full(*datas, **args)
    with torch.profiler.record_function("pull"):
        sync()
    return out


def searches(case) -> int:
    """Frame pairs of the four pullbacks and the four between searches."""
    return sum(len(np.unique(lumen[:, 0])) - 1 for _, lumen, _, _ in case) + 4


def _coords(geom) -> dict:
    out = {"Lumen": np.stack([f.lumen.xyz_view() for f in geom.frames])}
    for kind in ("Catheter", "Wall"):
        if all(kind in f.extras for f in geom.frames):
            out[kind] = np.stack([f.extras[kind].xyz_view() for f in geom.frames])
    return out


def answer(out) -> dict:
    """The four pullbacks' logs and the pairs AB, CD, AC, BD as coordinates
    by kind."""
    *pairs, logs = out
    return {"logs": [np.array(l, dtype=np.float64).reshape(-1, 7) for l in logs],
            "coords": [(_coords(p.geom_a), _coords(p.geom_b)) for p in pairs]}


def judge(case, ans, args, device) -> dict:
    return oct_full.judge(case, args, ans, device)


def control(case, args, device) -> dict:
    """The reference in the program's place, one precision below the
    program's: bfloat16 cost tables, float32 geometry."""
    return oct_full.register(case, args, device, torch.bfloat16, np.float32)
