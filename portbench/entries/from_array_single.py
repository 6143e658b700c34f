"""Entry ``from_array_single``: one pullback a case, through the port's
``multimodars_torch.from_array_single``, judged by ``reference/oct_single``.

An entry module gives the harness six things: :func:`call_args` (the
configuration's ``args`` turned into the call's arguments, once, in
set-up), :func:`run_case` (the timed call), :func:`searches` (rotation
searches a case makes, for the repair share), :func:`answer` (the
program's result in the reference's form, taken after the window),
:func:`judge` (the numbers compared, each by name) and :func:`control`
(the reference one precision below the program's, in its place)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import oct_single


def call_args(raw: dict) -> dict:
    """The configuration's ``args`` as the entry's keywords."""
    return {**raw, "image_center": tuple(raw["image_center"])}


def run_case(mt, case, args, sync):
    """Convert the case's arrays, register them, wait for the card
    (``sync``)."""
    (label, lumen, ref, diastole), = case
    with torch.profiler.record_function("convert"):
        data = mt.numpy_to_inputdata(lumen, ref, diastole, label=label)
    with torch.profiler.record_function("entry"):
        out = mt.from_array_single(data, **args)
    with torch.profiler.record_function("pull"):
        sync()
    return out


def searches(case) -> int:
    """Frame pairs searched: frames - 1."""
    (_, lumen, _, _), = case
    return len(np.unique(lumen[:, 0])) - 1


def answer(out) -> dict:
    """The program's logs [F - 1, 7] and final coordinates by kind."""
    geom, logs = out
    coords = {"Lumen": np.stack([f.lumen.xyz_view() for f in geom.frames])}
    for kind in ("Catheter", "Wall"):
        if all(kind in f.extras for f in geom.frames):
            coords[kind] = np.stack([f.extras[kind].xyz_view() for f in geom.frames])
    return {"logs": np.array(logs, dtype=np.float64).reshape(-1, 7), "coords": coords}


def judge(case, ans, args, device) -> dict:
    (_, lumen, ref, _), = case
    return oct_single.judge(lumen, ref, args, ans, device)


def control(case, args, device) -> dict:
    """The reference in the program's place, one precision below the
    program's: bfloat16 cost tables (the program's are float32) and float32
    geometry (the program's host arithmetic is float64)."""
    (_, lumen, ref, _), = case
    return oct_single.register(lumen, ref, args, device, torch.bfloat16, np.float32)
