"""Wrapper of the flash-attention kernel K3: checks, dispatch, launch count.

Port of ``repro.kernels.flash_attention.ops``. It takes the model layout
``(B, S, H, Dh)``, as the JAX wrapper does; the CUDA kernel reads that
layout in place, so nothing is transposed or copied on the card. For CPU
tensors the wrapper runs the plain PyTorch version (:mod:`.ref`). For
CUDA tensors it launches the kernel of ``csrc/flash_attention.cu``
(built with nvcc at first use, :mod:`repro_torch.kernels._build`) or
raises; it never falls back. The kernel masks ragged S and T edges
itself, so no shape is handed to the plain version, unlike the JAX
wrapper's fallback for shapes its blocks do not tile.

``launch_counts`` counts kernel launches, so a run can show that its
path went through the kernel; CPU calls add nothing.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
#: Head dims the kernel is compiled for. In bf16, Dh = 80 (zamba2-2.7b's
#: shared attention) runs in the Dh = 128 tile, the columns past 80 read
#: as zeros by TMA (nothing is padded in device memory).
HEAD_DIMS = (64, 80, 128)
#: Query rows of one work tile of the bf16 kernel (its BLOCK_M); it has
#: S / BLOCK_Q * H * B of them, fewer than 2**31, walked by one block an
#: SM. The f32 grid is (H, B, S / 16), and an axis after the first may
#: not exceed 65,535.
BLOCK_Q = 128
F32_BLOCK_Q = 16
_MAX_GRID = 65535

#: Kernel launches since the last :func:`reset_launch_counts`.
launch_counts = {"flash_attention": 0}

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
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32,
            f32, ptr]
        lib.flash_attention.restype = i32
        _lib = lib
    return _lib


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, S, H, Dh), got shape "
                             f"{tuple(t.shape)}")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{sorted(map(str, _DTYPE_CODES))}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, dh = q.shape
    _, t, hkv, _ = k.shape
    if tuple(k.shape) != (b, t, hkv, dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, T, Hkv, Dh) = (B, T, Hkv, {dh}) "
                         f"with B = {b}; got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"query heads ({h}) must be a multiple of kv heads ({hkv})")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be an int >= 0, got {window!r}")
    if q.dtype == torch.float32:
        too_large = b > _MAX_GRID or -(-s // F32_BLOCK_Q) > _MAX_GRID
    else:
        too_large = -(-s // BLOCK_Q) * h * b >= 2 ** 31
    if too_large:
        raise ValueError(f"too large for the kernel's grid: B={b}, H={h}, S={s}")


def flash_attention(q, k, v, *, causal=True, window=0):
    """Model layout: q (B, S, H, Dh); k, v (B, T, Hkv, Dh) -> (B, S, H, Dh)
    in q's dtype (f32 or bf16). Query position ``i`` sees key ``j`` when
    ``j <= i`` (``causal``) and ``j > i - window`` (``window > 0``); a
    row with no visible key is exact zeros."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window)
        return out.transpose(1, 2)
    b, s, h, dh = q.shape
    _, t, hkv, _ = k.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        rc = load().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, hkv, s, t, dh, int(bool(causal)),
            window, float(dh ** -0.5), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention launch failed: CUDA error {rc}" if rc > 0 else
            "flash_attention: no TMA tensor map (cuTensorMapEncodeTiled "
            "missing or refused the shape)" if rc == -2 else
            "flash_attention: unsupported dtype or head dim")
    launch_counts["flash_attention"] += 1
    return out
