"""Wrapper of the gated-linear-recurrence scan K4: checks, dispatch,
launch count.

Port of ``repro.kernels.ssm_scan.ops``. It takes the model layout
``a (B, S, H)``, ``k, q (B, S, H, dk)``, ``v (B, S, H, dv)``, as the JAX
wrapper does; the CUDA kernel reads that layout in place through its
strides and masks a ragged S itself, so nothing is transposed, padded or
upcast on the card (the JAX wrapper folds the heads into a copy and pads
S to the chunk). For CPU tensors the wrapper runs the plain PyTorch
version (:mod:`.ref`). For CUDA tensors it launches the kernels of
``csrc/gla_scan.cu`` (built with nvcc at first use,
:mod:`repro_torch.kernels._build`) or raises; it never falls back. A call
is two CUDA launches: the raw scores ``q kᵀ`` of each chunk, once per
batch row where k and q are both shared by the heads (head stride 0),
into a scratch buffer this wrapper allocates; then the walk over the
chunks that applies each head's decay and carries the state.

``launch_counts`` counts the calls that launched the kernels, so a run
can show that its path went through them; CPU calls add nothing.
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
#: Largest dk: a cluster of four blocks keeps a (dk, 64) f32 slice of the
#: state in their shared memory, a quarter of dk each.
MAX_DK = 1536
#: The grid's second axis counts B·H and may not exceed 65,535.
_MAX_GRID = 65535

#: Calls that launched the kernels since the last
#: :func:`reset_launch_counts` (each call is two CUDA launches).
launch_counts = {"gla_scan": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def bind(lib):
    """Declare the C interface of a library built from :data:`SOURCE`."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    i32p, i64p = ctypes.POINTER(i32), ctypes.POINTER(ctypes.c_longlong)
    lib.gla_scan.argtypes = [ptr] * 6 + [i32p, i64p] + [i32] * 6 + [ptr]
    lib.gla_scan.restype = i32
    lib.gla_scan_scratch_floats.argtypes = [i32, i32, i32, i64p, i32]
    lib.gla_scan_scratch_floats.restype = ctypes.c_longlong
    lib.gla_scan_config.argtypes = [i32, i32p, i32, i32p]
    lib.gla_scan_config.restype = i32
    return lib


def load():
    """Build (if needed) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        _lib = bind(_build.load_library(SOURCE))
    return _lib


def kernel_config(dk, dtypes, chunk):
    """The tiling the kernel picks for ``dk``, the dtypes of (a, k, v, q)
    and ``chunk``: the walk's state columns a block, its warps, the dk rows
    a step, the dynamic shared memory (bytes) of the walk and of the scores
    kernel, and the blocks of a cluster (which split dk)."""
    codes = (ctypes.c_int * 4)(*(_DTYPE_CODES[d] for d in dtypes))
    out = (ctypes.c_int * 6)()
    if load().gla_scan_config(dk, codes, chunk, out) != 0:
        raise ValueError(f"chunk {chunk!r} not in {CHUNKS}")
    return dict(zip(("columns", "warps", "dk_step", "walk_smem", "scores_smem",
                     "cluster"), out))


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
        raise ValueError(f"dk {dk} above {MAX_DK}: the kernel keeps a (dk, 64) "
                         f"slice of the state in the shared memory of four blocks")
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
    launch(load(), a, k, v, q, y, chunk)
    launch_counts["gla_scan"] += 1
    return y


def launch(lib, a, k, v, q, y, chunk):
    """Launch the kernels of ``lib`` (bound by :func:`bind`) on checked
    CUDA operands into ``y``, with a scratch buffer for the scores."""
    b, s, h = a.shape
    dk, dv = k.shape[-1], v.shape[-1]
    dtypes = (ctypes.c_int * 4)(*(_DTYPE_CODES[t.dtype] for t in (a, k, v, q)))
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (a, k, v, q) for st in t.stride()[:3]))
    scores = torch.empty(lib.gla_scan_scratch_floats(b, s, h, strides, chunk),
                         dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = lib.gla_scan(
            a.data_ptr(), k.data_ptr(), v.data_ptr(), q.data_ptr(),
            y.data_ptr(), scores.data_ptr(), dtypes, strides, b, s, h, dk, dv,
            chunk, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gla_scan launch failed: CUDA error {rc}"
                           if rc > 0 else "gla_scan: unsupported chunk, dtype "
                           "or size")
