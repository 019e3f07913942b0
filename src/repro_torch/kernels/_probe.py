"""What the kernels' probes share: a source with parts patched, its build,
timing with the L2 flushed or back to back, and the card's name and
power limit.

A probe's variant is a kernel source with a few lines replaced, each
anchor found exactly once (the probe fails when the source no longer
holds one). ``@0`` .. ``@7`` in a replacement stand for a ``clock64``
counter around a section, written as the probe's ``clock`` template with
``{i}`` for the section's number.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build


def variant_source(source: Path, name: str, patches, clock: str = "") -> str:
    """``source``'s text with the (anchor, replacement) ``patches`` of the
    variant ``name`` applied."""
    src = source.read_text()
    for anchor, replacement in patches:
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe variant {name!r}: anchor not found once in "
                               f"{source.name}: {anchor[:60]!r}")
        for i in range(8):
            replacement = replacement.replace(f"@{i}", clock.replace("{i}", str(i)))
        src = src.replace(anchor, replacement)
    return src


def build(stem: str, text: str) -> ctypes.CDLL:
    """Write ``text`` as ``{stem}.cu`` beside the kernel libraries, compile
    it with the kernels' nvcc flags and load it."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / f"{stem}.cu"
    src.write_text(text)
    lib = _build.BUILD_DIR / f"lib{stem}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def flushed_ms(fn, n: int, warmup: int, write: bool = False) -> float:
    """Mean ms a call over ``n`` calls after ``warmup`` calls, with the L2
    left holding none of ``fn``'s inputs before each timed one: a 256 MB
    buffer, written once, is read through (summed into a scalar), so the
    L2 holds only clean lines of it. ``write=True`` zeroes the buffer
    instead, the older flush: the L2 is write-back, so that leaves up to
    50 MB of dirty lines, which the timed call writes back to HBM as its
    reads evict them."""
    flush = torch.zeros(64 * 2 ** 20, device="cuda")
    sink = torch.empty((), device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(n):
        if write:
            flush.zero_()
        else:
            torch.sum(flush, dim=0, out=sink)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / n


def warm_ms(fn, n: int, warmup: int) -> float:
    """Mean ms a call over ``n`` calls run back to back."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip()
