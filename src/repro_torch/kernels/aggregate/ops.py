"""Wrappers of the aggregate kernels: checks, dispatch, launch counts.

Port of ``repro.kernels.aggregate.ops``. Each wrapper takes the plain
PyTorch version (:mod:`.ref`) for tensors on the CPU. For CUDA tensors
it launches the CUDA kernel of ``csrc/aggregate.cu`` (built with nvcc
at first use, :mod:`repro_torch.kernels._build`) or raises; it never
falls back. The JAX package's VMEM block fitting (``_fit_block``) is a
TPU rule and has no counterpart here. In its place :func:`geometry`
cuts P for the card: one block a SM (fewer for a small P), each owning a
span of P in whole 16-byte units, the span streamed through a ring of shared-memory stages
of a few rows each, and each row read at its shift inside its first
16-byte unit. The kernel takes that geometry as it is given.

``launch_counts`` counts the kernel launches of each wrapper, so a run
can show that its path went through the kernels; CPU calls add nothing.
The count is taken under a lock, so it stays exact when several threads
launch at once (the serve layer's competing flushers).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import astuple, dataclass
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.aggregate.ref import (
    masked_scaled_aggregate_ref,
    masked_scaled_aggregate_update_ref,
)

SOURCE = Path(__file__).parent / "csrc" / "aggregate.cu"

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
launch_counts = {"masked_scaled_aggregate": 0,
                 "masked_scaled_aggregate_update": 0}
_count_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None

# Mirrors of csrc/aggregate.cu: the consumer threads of a block, the
# columns each sums in a chunk, the ring's most stages, the bytes of
# their mbarriers and the shared memory a block may use.
CONSUMERS, COLS_PER_THREAD, MAX_STAGES = 256, 10, 16
BAR_BYTES, MAX_SMEM = 2 * MAX_STAGES * 8, 232_448
#: The fewest 16-byte units of a row a block owns: a small P runs fewer
#: blocks than SMs, as fast as one block a SM and leaving the other SMs
#: free (the probe's "least span" lines at P = 2,049 and 20,000).
MIN_UNITS = 16
#: Shared-memory bytes of a block's ring: what it keeps in flight.
RING_BYTES = 192 * 1024
#: A stage takes rows (1, 2, 4 or 8) until it holds this many bytes:
#: fewer, larger stages pay fewer barrier round trips (the probe's rows
#: variants at the Fig-1 shape).
STAGE_BYTES = 64 * 1024


@dataclass(frozen=True)
class Geometry:
    """How the kernel cuts an (N, P) gradient buffer.

    ``blocks`` blocks (at most one a SM) each own ``span`` columns, a
    whole number of 16-byte units; block b owns [b·span, min((b+1)·span,
    P)). :func:`geometry` launches no block past P; the kernel lets a
    block that owns nothing return. A block walks its span ``chunk`` columns at a
    time; a stage of its ring holds ``rows`` rows of a chunk, each
    ``pitch`` bytes in shared memory, and the ring has ``stages``
    stages. Row n's run is copied from its aligned-down start and read
    at :meth:`shift`, from ``head`` (the byte offset of g in its 16-byte
    unit) and ``step`` (P·esize mod 16).
    """
    blocks: int
    span: int
    chunk: int
    rows: int
    stages: int
    pitch: int
    head: int
    step: int
    esize: int

    def spans(self, p):
        """The (start, end) column range of each block that owns any."""
        return [(b * self.span, min((b + 1) * self.span, p))
                for b in range(self.blocks) if b * self.span < p]

    def shift(self, n):
        """Elements between row n's aligned-down start and its first one
        (the same for every span: a span starts on a 16-byte unit)."""
        return (self.head + n * self.step) % 16 // self.esize

    @property
    def smem(self):
        """Dynamic shared memory of a block, bytes: the barriers and the
        ring."""
        return BAR_BYTES + self.stages * self.rows * self.pitch


class _CGeometry(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in
                ("blocks", "span", "chunk", "rows", "stages", "pitch", "head",
                 "step")]


def geometry(p, esize, blocks, offset=0, min_units=MIN_UNITS):
    """The kernel's geometry for rows of ``p`` elements of ``esize``
    bytes, at most ``blocks`` blocks, each owning ``min_units`` 16-byte
    units of a row or more where ``p`` allows, g at byte ``offset`` (its
    address, or its address mod 16)."""
    unit = 16 // esize
    units = -(-p // unit)
    span_units = -(-units // max(1, min(blocks, units // min_units)))
    blocks = -(-units // span_units)
    chunks = -(-span_units * unit // (CONSUMERS * COLS_PER_THREAD))
    chunk = -(-span_units // chunks) * unit
    pitch = chunk * esize + 16
    rows = 1
    while rows < 8 and rows * pitch < STAGE_BYTES:
        rows *= 2
    stages = max(2, min(MAX_STAGES, RING_BYTES // (rows * pitch)))
    return Geometry(blocks, span_units * unit, chunk, rows, stages, pitch,
                    offset % 16, p * esize % 16, esize)


@functools.lru_cache(maxsize=None)
def sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def c_geometry(geo):
    """``geo`` as the kernel's C struct."""
    return _CGeometry(*astuple(geo)[:8])


@functools.lru_cache(maxsize=None)
def _launch_geometry(p, esize, device_index, head):
    return c_geometry(geometry(p, esize, sm_count(device_index), head))


def _geometry_arg(g):
    return ctypes.byref(_launch_geometry(g.shape[1], g.element_size(),
                                         g.device.index, g.data_ptr() % 16))


def reset_launch_counts():
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _count(name):
    """One launch of ``name``'s kernel, counted under the lock."""
    with _count_lock:
        launch_counts[name] += 1


def load():
    """Build (if needed) and load the kernels' shared library."""
    global _lib
    if _lib is None:
        _lib = bind(_build.load_library(SOURCE))
    return _lib


def bind(lib):
    """Declare the C entry points' arguments on a loaded library."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    geo = ctypes.POINTER(_CGeometry)
    lib.masked_scaled_aggregate.argtypes = [
        ptr, i32, ptr, ptr, ptr, i32, i32, i64, geo, ptr]
    lib.masked_scaled_aggregate_update.argtypes = [
        ptr, i32, ptr, ptr, ptr, ptr, i32, ptr, i32, i32, i64, geo, ptr]
    lib.masked_scaled_aggregate.restype = i32
    lib.masked_scaled_aggregate_update.restype = i32
    return lib


def _on_cpu(*tensors) -> bool:
    """True when every operand is on the CPU; raises on a mix of devices."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"aggregate kernels run on cuda or cpu, not {device}")
    return False


def _check(name, t, shape, dtypes):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {sorted(map(str, dtypes))}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(g, w, mask, out_dtype):
    if g.dim() != 2:
        raise ValueError(f"g must be (N, P), got shape {tuple(g.shape)}")
    n, p = g.shape
    _check("g", g, (n, p), _DTYPE_CODES)
    _check("w", w, (n,), (torch.float32,))
    if mask is not None:
        _check("mask", mask, (n,), (torch.float32,))
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} not in {sorted(map(str, _DTYPE_CODES))}")
    if n >= 2 ** 31:
        raise ValueError(f"too many rows for the kernel: {n}")
    return n, p


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream():
    """PyTorch's current stream on the current device; the wrappers
    launch inside ``torch.cuda.device(g.device)``, so the kernel runs in
    the operands' context."""
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc, name):
    if rc > 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    if rc < 0:
        raise RuntimeError(f"{name}: unsupported dtypes" if rc == -1
                           else f"{name}: the kernel refused its geometry")


def masked_scaled_aggregate(g, w, out_dtype=None, mask=None):
    """K1: ``out[p] = Σ_n w[n]·sel(mask[n] > 0, g[n,p], 0)``.

    g (N, P) f32 or bf16; w (N,) f32; mask optional (N,) f32 0/1 row
    select (masked rows give exact zeros even when they hold inf/NaN);
    the result is (P,) in ``out_dtype`` (default ``g.dtype``), summed in
    f32.
    """
    out_dtype = g.dtype if out_dtype is None else out_dtype
    if _on_cpu(g, w, mask):
        return masked_scaled_aggregate_ref(g, w, mask, out_dtype)
    n, p = _check_common(g, w, mask, out_dtype)
    out = torch.empty((p,), dtype=out_dtype, device=g.device)
    with torch.cuda.device(g.device):
        rc = load().masked_scaled_aggregate(
            _ptr(g), _DTYPE_CODES[g.dtype], _ptr(w), _ptr(mask), _ptr(out),
            _DTYPE_CODES[out_dtype], n, p, _geometry_arg(g), _stream())
    _raise_on(rc, "masked_scaled_aggregate")
    _count("masked_scaled_aggregate")
    return out


def masked_scaled_aggregate_update(g, w, eta, params=None, mask=None, *,
                                   out_dtype=None):
    """K2, the fused reduce-and-update (DESIGN.md §9) in one launch.

    With ``params`` (P,): ``params − eta·(w_sel @ g)`` in ``params.dtype``
    (f32 or bf16; the update is computed in f32 and cast on the store).
    Without: the f32 delta ``−eta·(w_sel @ g)``. ``eta`` is a float or a
    one-element f32 tensor on the operands' device, read by the kernel
    on the card, so a scheduled learning rate never syncs the host.
    Bitwise equal to :func:`masked_scaled_aggregate` followed by
    ``params + (−eta·agg)`` in f32.
    """
    if out_dtype is None:
        out_dtype = torch.float32 if params is None else params.dtype
    eta_t = eta if isinstance(eta, torch.Tensor) else torch.full(
        (), float(eta), dtype=torch.float32, device=g.device)
    if _on_cpu(g, w, mask, params, eta_t):
        return masked_scaled_aggregate_update_ref(g, w, eta_t, params, mask,
                                                  out_dtype)
    n, p = _check_common(g, w, mask, out_dtype)
    _check("eta", eta_t.reshape(()), (), (torch.float32,))
    if params is not None:
        _check("params", params, (p,), _DTYPE_CODES)
    out = torch.empty((p,), dtype=out_dtype, device=g.device)
    with torch.cuda.device(g.device):
        rc = load().masked_scaled_aggregate_update(
            _ptr(g), _DTYPE_CODES[g.dtype], _ptr(w), _ptr(mask), _ptr(eta_t),
            _ptr(params), _DTYPE_CODES.get(getattr(params, "dtype", None), 0),
            _ptr(out), _DTYPE_CODES[out_dtype], n, p, _geometry_arg(g), _stream())
    _raise_on(rc, "masked_scaled_aggregate_update")
    _count("masked_scaled_aggregate_update")
    return out
