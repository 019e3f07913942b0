"""What the kernels' probes share: a source with parts patched, its build,
timing with the L2 flushed, and the card's name and power limit.

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


def flushed_ms(fn, n: int, warmup: int) -> float:
    """Mean ms a call over ``n`` calls after ``warmup`` calls, a 256 MB
    buffer zeroed before each timed one."""
    flush = torch.empty(64 * 2 ** 20, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(n):
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / n


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip()
