"""Wrapper of the gated-linear-recurrence scan K4: checks, dispatch,
launch count.

Port of ``repro.kernels.ssm_scan.ops``. It takes the model layout
``a (B, S, H)``, ``k, q (B, S, H, dk)``, ``v (B, S, H, dv)``, as the JAX
wrapper does; the CUDA kernel reads that layout in place through its
strides and masks a ragged S itself, so nothing is transposed, padded or
upcast on the card (the JAX wrapper folds the heads into a copy and pads
S to the chunk). For CPU tensors the wrapper runs the plain PyTorch
version (:mod:`.ref`). For CUDA tensors it launches the kernel of
``csrc/gla_scan.cu`` (built with nvcc at first use,
:mod:`repro_torch.kernels._build`) or raises; it never falls back.

``launch_counts`` counts kernel launches, so a run can show that its
path went through the kernel; CPU calls add nothing.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.ref import gla_scan_ref

SOURCE = Path(__file__).parent / "csrc" / "gla_scan.cu"
#: Chunk lengths the kernel is compiled for.
CHUNKS = (16, 32, 64)
#: Largest dk: a block keeps a (dk, 32) f32 slice of the state in shared
#: memory.
MAX_DK = 1536
#: The grid's second axis counts B·H and may not exceed 65,535.
_MAX_GRID = 65535

#: Kernel launches since the last :func:`reset_launch_counts`.
launch_counts = {"gla_scan": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def load():
    """Build (if needed) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = _build.load_library(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gla_scan.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ctypes.POINTER(i32),
            ctypes.POINTER(ctypes.c_longlong), i32, i32, i32, i32, i32, i32,
            ptr]
        lib.gla_scan.restype = i32
        _lib = lib
    return _lib


def _check(a, k, v, q, chunk):
    if a.dim() != 3:
        raise ValueError(f"a must be 3-D (B, S, H), got shape {tuple(a.shape)}")
    for name, t in (("k", k), ("v", v), ("q", q)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, S, H, D), got shape "
                             f"{tuple(t.shape)}")
    devices = {a.device, k.device, v.device, q.device}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gla_scan runs on cuda or cpu, not {a.device}")
    for name, t in (("a", a), ("k", k), ("v", v), ("q", q)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be one of "
                            f"{sorted(map(str, _DTYPE_CODES))}, got {t.dtype}")
    b, s, h = a.shape
    dk, dv = k.shape[-1], v.shape[-1]
    if (tuple(k.shape) != (b, s, h, dk) or tuple(q.shape) != (b, s, h, dk)
            or tuple(v.shape[:3]) != (b, s, h)):
        raise ValueError(f"with a of shape (B, S, H) = {(b, s, h)}, k and q must "
                         f"be (B, S, H, dk) and v (B, S, H, dv); got "
                         f"{tuple(k.shape)}, {tuple(q.shape)}, {tuple(v.shape)}")
    if not isinstance(chunk, int) or chunk not in CHUNKS:
        raise ValueError(f"chunk {chunk!r} not in {CHUNKS}")
    if dk > MAX_DK:
        raise ValueError(f"dk {dk} above {MAX_DK}: the kernel keeps a (dk, 32) "
                         f"slice of the state in shared memory")
    for name, t in (("k", k), ("v", v), ("q", q)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along its last axis")
    if b * h > _MAX_GRID:
        raise ValueError(f"too large for the kernel's grid: B*H = {b * h}")


def gla_scan(a, k, v, q, chunk: int = 64):
    """Model layout: a (B, S, H) decay; k, q (B, S, H, dk); v (B, S, H, dv)
    -> y (B, S, H, dv) f32 with ``y_t = q_tᵀ H_t``,
    ``H_t = a_t H_{t−1} + k_t v_tᵀ``, ``H_0 = 0``. Each operand f32 or
    bf16; ``chunk`` is the kernel's chunk length (the result does not
    depend on it beyond rounding)."""
    _check(a, k, v, q, chunk)
    b, s, h = a.shape
    dk, dv = k.shape[-1], v.shape[-1]
    if a.device.type == "cpu":
        fold = lambda x: x.transpose(1, 2).reshape((b * h, s) + x.shape[3:])
        y = gla_scan_ref(fold(a), fold(k), fold(v), fold(q))
        return y.reshape(b, h, s, dv).transpose(1, 2).contiguous()
    y = torch.empty((b, s, h, dv), dtype=torch.float32, device=a.device)
    if y.numel() == 0:
        return y
    dtypes = (ctypes.c_int * 4)(*(_DTYPE_CODES[t.dtype] for t in (a, k, v, q)))
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (a, k, v, q) for st in t.stride()[:3]))
    with torch.cuda.device(a.device):
        rc = load().gla_scan(
            a.data_ptr(), k.data_ptr(), v.data_ptr(), q.data_ptr(),
            y.data_ptr(), dtypes, strides, b, s, h, dk, dv, chunk,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gla_scan launch failed: CUDA error {rc}"
                           if rc > 0 else "gla_scan: unsupported chunk, dtype "
                           "or size")
    launch_counts["gla_scan"] += 1
    return y
