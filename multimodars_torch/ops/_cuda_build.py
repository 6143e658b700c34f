"""Build and load of the hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a``
at its first use into a shared library with a plain C interface, named by a
hash of the source and the flags, in the git-ignored ``_build/`` beside this
package, and loaded with ``ctypes``.  A library that exists is reused.
:func:`compile_sources` starts one ``nvcc`` per missing library, all at
once, so several kernels build in the time of the slowest.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: builds run in this process: source file name -> (seconds, nvcc's output,
#: which lists each kernel's registers and shared memory)
reports: Dict[str, Tuple[float, str]] = {}


def _nvcc(what: str) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(f"nvcc not found: the {what} kernel cannot be built")


def library_path(source: Path) -> Path:
    """The library of ``source``, named by a hash of it, the headers beside
    it (``*.cuh``, which a source may include) and the flags."""
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(source.parent.glob("*.cuh")):
        tag.update(header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{tag.hexdigest()[:16]}.so"


def compile_sources(sources: Sequence[Tuple[Path, str]]) -> None:
    """Build the library of every ``(source, what)`` that has none yet, one
    ``nvcc`` each, all started together; raise if any fails."""
    todo = [(src, what, library_path(src)) for src, what in sources]
    todo = [t for t in todo if not t[2].exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = []
    for src, what, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(what), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        running.append((src, so, tmp, proc))
    failed = []
    for src, so, tmp, proc in running:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src.name}:\n{err}")
            continue
        os.replace(tmp, so)
        reports[src.name] = (time.perf_counter() - t0, err)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(source: Path, what: str) -> ctypes.CDLL:
    """The kernel library of ``source``, built first if it has none."""
    compile_sources([(source, what)])
    return ctypes.CDLL(str(library_path(source)))


def check_tensor(name, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device``: what a kernel wrapper checks before a launch."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def call_on(device: torch.device, fn, *args, stream: bool = True):
    """``fn(*args)`` with ``device`` current, and with the pointer of its
    current stream as the last argument unless ``stream`` is False: how a
    wrapper calls its kernel's C entry point."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index != current:
        with torch.cuda.device(index):
            return call_on(device, fn, *args, stream=stream)
    if stream:
        return fn(*args, _raw_stream(index))
    return fn(*args)


def _raw_stream(index: int) -> int:
    """The pointer of the current stream of device ``index``: torch's raw
    getter where it has one (a few microseconds less than building a
    ``torch.cuda.Stream``), else the public one."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


_SMS: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]
