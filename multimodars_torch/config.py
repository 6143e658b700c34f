"""Device and dtype policy of the PyTorch port.

Host-side geometry bookkeeping (centroids, CSV data, the object model) stays
float64 numpy.  The batched rotation search runs on ``config.device`` in
``config.compute_dtype``:

- the device is the first CUDA card.  There is no silent fallback: without
  a card the first transfer to the device raises, and a caller who wants
  the CPU asks for it with ``config.set_device("cpu")`` or
  ``config.use(device="cpu")``;
- the compute dtype is the one set with ``set_compute_dtype`` /
  ``use(dtype=...)``, else ``MMTPU_COMPUTE_DTYPE`` when set, else float32
  on CUDA and float64 on the CPU.  float32 searches are certified: flagged
  argmins are re-decided by the same kernel in float64, then in exact host
  float64 (``ops.argmin_repair``).

Importing this module changes no global state of torch or numpy.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

_SUPPORTED = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """Map a torch dtype, numpy dtype or dtype name to a supported torch
    float dtype (float32 or float64); raise on anything else."""
    if isinstance(dtype, torch.dtype):
        if dtype in _SUPPORTED.values():
            return dtype
        raise ValueError(f"unsupported compute dtype {dtype}")
    key = np.dtype(dtype)
    if key not in _SUPPORTED:
        raise ValueError(f"unsupported compute dtype {dtype}")
    return _SUPPORTED[key]


def _initial_device() -> torch.device:
    return torch.device("cuda")


def default_dtype_for(device: torch.device) -> torch.dtype:
    env = os.environ.get("MMTPU_COMPUTE_DTYPE")
    if env:
        return torch_dtype(env)
    return torch.float32 if device.type == "cuda" else torch.float64


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device`` (a CUDA device with its index), or
    raise ``RuntimeError`` when it names a CUDA card that is not present."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{device} names a CUDA card and multimodars_torch found none; to "
            "run on the CPU, ask for it with "
            'multimodars_torch.config.set_device("cpu"), '
            'multimodars_torch.config.use(device="cpu") or a mesh of "cpu" devices'
        )
    index = torch.cuda.current_device() if device.index is None else device.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"{device}: only {torch.cuda.device_count()} CUDA card(s) present")
    return torch.device("cuda", index)


class _Config:
    """Mutable runtime config: where and in which dtype the search runs."""

    def __init__(self):
        self.device = _initial_device()
        self._dtype = None  # None: the device's default

    @property
    def compute_dtype(self) -> torch.dtype:
        if self._dtype is not None:
            return self._dtype
        return default_dtype_for(self.device)

    def set_compute_dtype(self, dtype) -> None:
        self._dtype = torch_dtype(dtype)

    def set_device(self, device) -> None:
        self.device = torch.device(device)

    def check_device(self) -> torch.device:
        """``self.device`` through :func:`check_device`."""
        return check_device(self.device)

    @contextlib.contextmanager
    def use(self, device=None, dtype=None):
        """Temporarily run on ``device`` and/or in ``dtype``."""
        saved = (self.device, self._dtype)
        try:
            if device is not None:
                self.set_device(device)
            if dtype is not None:
                self.set_compute_dtype(dtype)
            yield self
        finally:
            self.device, self._dtype = saved


config = _Config()
