"""Host <-> device transfer, and the port's single-process device mesh.

A :class:`Mesh` is an ordered tuple of ``torch.device``s with one axis
name: each entry is one shard, and one card may be named several times.
On a CUDA device each shard runs on a stream of its own (cached per card
and position in the mesh), so the shards of one card overlap as far as
their kernels leave the card's SMs free; on the CPU the shards run in turn.
Work splits into contiguous, possibly uneven slices in mesh order
(:func:`row_slices`, :func:`shards`), and every sharded wave runs through
:func:`run_shards`: all shards launch before any result is pulled.  See :mod:`multimodars_torch.parallel`
for why the mesh is not ``torch.distributed``.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import check_device, config


def to_device(x, dtype=None, device=None) -> torch.Tensor:
    """``x`` as a C-contiguous tensor on ``device`` (default
    ``config.device``), cast to ``dtype`` if given; raises ``RuntimeError``
    when that is a CUDA card and none is present (see
    :mod:`multimodars_torch.config`)."""
    device = check_device(config.device if device is None else device)
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)


#: rows of 3 floats to which :func:`to_device_packed` aligns each set
PACK_ALIGN = 4


def to_device_packed(sets: Sequence[np.ndarray], dtype,
                     device=None) -> Tuple[torch.Tensor, List[int]]:
    """The ``[n_k, 3]`` float arrays ``sets`` cast to ``dtype`` and stacked
    into one ``[rows, 3]`` tensor on ``device`` (default ``config.device``),
    and the row offset of each.  Every set starts at a multiple of
    ``PACK_ALIGN`` rows (16 bytes in either dtype, what a kernel's bulk copy
    needs), after zero rows.  On the card the cast is written into a pinned
    host buffer and goes up in one copy on the current stream."""
    device = check_device(config.device if device is None else device)
    offsets, total = [], 0
    for s in sets:
        offsets.append(total)
        total += -(-len(s) // PACK_ALIGN) * PACK_ALIGN
    on_card = device.type == "cuda"
    host = torch.empty((total, 3), dtype=dtype, pin_memory=on_card)
    view = host.numpy()
    for o, end, s in zip(offsets, offsets[1:] + [total], sets):
        view[o:o + len(s)] = s
        view[o + len(s):end] = 0.0
    if not on_card:
        return host, offsets
    return host.to(device, non_blocking=True), offsets


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array: a CPU tensor's own memory, or one copy of a
    card's tensor into a pinned host buffer on the current stream, waited
    for."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

class Mesh:
    """A one-axis device mesh inside one process: ``devices`` (a tuple of
    ``torch.device``, one shard each, a card may repeat) and
    ``axis_names`` (one name), read as ``jax.sharding.Mesh`` is read.
    Entries may be ``torch.device``s or strings (``"cuda:0"``, ``"cpu"``);
    a CUDA entry raises ``RuntimeError`` when that card is not present."""

    def __init__(self, devices: Sequence, axis: str = "shards"):
        devices = tuple(check_device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = devices
        self.axis_names = (axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        names = ", ".join(str(d) for d in self.devices)
        return f"Mesh(({names}), axis_names={self.axis_names})"


def default_devices() -> Tuple[torch.device, ...]:
    """The devices of a mesh made with no argument: every CUDA card when
    ``config.device`` is CUDA (raising when there is none), else
    ``(config.device,)``."""
    device = config.check_device()
    if device.type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    return (device,)


def row_slices(n: int, parts: int) -> List[slice]:
    """``n`` rows cut into ``parts`` contiguous slices in order, the first
    ``n % parts`` one row longer; slices past ``n`` are empty."""
    base, extra = divmod(int(n), int(parts))
    out, start = [], 0
    for k in range(parts):
        stop = start + base + (1 if k < extra else 0)
        out.append(slice(start, stop))
        start = stop
    return out


_STREAMS: Dict[Tuple[int, int], "torch.cuda.Stream"] = {}
_current_shard: contextvars.ContextVar = contextvars.ContextVar(
    "mmtorch_shard", default=None
)


def _stream_of(device: torch.device, position: int):
    key = (device.index, position)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device)
    return _STREAMS[key]


@dataclass(frozen=True)
class Shard:
    """One entry of a mesh: its position ``index`` of ``count``, its
    device, its stream (None on the CPU) and its slice ``rows`` of the rows
    it was made for."""

    index: int
    count: int
    device: torch.device
    stream: Optional["torch.cuda.Stream"]
    rows: slice

    def part(self, n: int) -> slice:
        """This shard's contiguous slice of ``n`` rows."""
        return row_slices(n, self.count)[self.index]

    @contextlib.contextmanager
    def context(self):
        """Run on this shard: its device current and, on a card, its stream
        current after it waits for the work already queued on the device's
        current stream (the inputs a caller made there)."""
        token = _current_shard.set(self)
        try:
            if self.stream is None:
                yield self
                return
            with torch.cuda.device(self.device):
                self.stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(self.stream):
                    yield self
        finally:
            _current_shard.reset(token)


def shards(mesh: Mesh, n_rows: int = 0) -> List[Shard]:
    """The shards of ``mesh`` in order, each with its slice of ``n_rows``."""
    slices = row_slices(n_rows, mesh.size)
    return [
        Shard(k, mesh.size, d, _stream_of(d, k) if d.type == "cuda" else None, slices[k])
        for k, d in enumerate(mesh.devices)
    ]


def run_shards(mesh: Mesh, n_rows: int,
               launch: Callable[[Shard], Optional[torch.Tensor]]) -> List[Tuple[Shard, np.ndarray]]:
    """The mesh's scheduling rule: every shard (each with its slice of
    ``n_rows``) runs ``launch(shard)`` in its context, all before any
    result is pulled; then each output is pulled (:func:`to_host`) in its
    own shard's context, so a pull waits for its own stream only.
    ``launch`` returns a tensor, or None for a shard with nothing to do,
    which launches nothing.  Returns ``(shard, host output)`` of each shard
    that launched, in mesh order."""
    pending = []
    for shard in shards(mesh, n_rows):
        with shard.context():
            out = launch(shard)
        if out is not None:
            pending.append((shard, out))
    pulled = []
    for shard, out in pending:
        with shard.context():
            pulled.append((shard, to_host(out)))
    return pulled


def current_shard() -> Optional[Shard]:
    """The shard whose :meth:`Shard.context` is active, or None."""
    return _current_shard.get()


# Active row-sharded layout of the CCTA device waves (None = one device).
# Under a mesh each live pair's query rows split over the shards and the
# target set is replicated: every shard gets its own packed upload, launch
# and pull, and the rows are joined in order before the host certification.
# Per-row arithmetic never crosses a shard, so counts and picks equal the
# one-device results for any partition.
_rows_mesh: contextvars.ContextVar = contextvars.ContextVar(
    "mmtorch_rows_mesh", default=None
)


@contextlib.contextmanager
def shard_rows_over(mesh: Mesh):
    """Run the CCTA device waves (counts, picks and ray hits) row-sharded
    over ``mesh``: the query rows split across its shards, the target sets
    replicate, and no result depends on the split.  The morph sweep stays
    on ``config.device``."""
    token = _rows_mesh.set(mesh)
    try:
        yield mesh
    finally:
        _rows_mesh.reset(token)


def active_rows_mesh() -> Optional[Mesh]:
    return _rows_mesh.get()
