"""Wrappers of the aggregate kernels: checks, dispatch, launch counts.

Port of ``repro.kernels.aggregate.ops``. Each wrapper takes the plain
PyTorch version (:mod:`.ref`) for tensors on the CPU. For CUDA tensors
it launches the CUDA kernel of ``csrc/aggregate.cu`` (built with nvcc
at first use, :mod:`repro_torch.kernels._build`) or raises; it never
falls back. The JAX package's VMEM block fitting (``_fit_block``) is a
TPU rule and has no counterpart here: the kernel tiles P itself.

``launch_counts`` counts the kernel launches of each wrapper, so a run
can show that its path went through the kernels; CPU calls add nothing.
"""

from __future__ import annotations

import ctypes
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

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def load():
    """Build (if needed) and load the kernels' shared library."""
    global _lib
    if _lib is None:
        lib = _build.load_library(SOURCE)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.masked_scaled_aggregate.argtypes = [
            ptr, i32, ptr, ptr, ptr, i32, i32, i64, ptr]
        lib.masked_scaled_aggregate_update.argtypes = [
            ptr, i32, ptr, ptr, ptr, ptr, i32, ptr, i32, i32, i64, ptr]
        lib.masked_scaled_aggregate.restype = i32
        lib.masked_scaled_aggregate_update.restype = i32
        _lib = lib
    return _lib


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
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}"
                           if rc > 0 else f"{name}: unsupported dtypes")


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
            _DTYPE_CODES[out_dtype], n, p, _stream())
    _raise_on(rc, "masked_scaled_aggregate")
    launch_counts["masked_scaled_aggregate"] += 1
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
            _ptr(out), _DTYPE_CODES[out_dtype], n, p, _stream())
    _raise_on(rc, "masked_scaled_aggregate_update")
    launch_counts["masked_scaled_aggregate_update"] += 1
    return out
