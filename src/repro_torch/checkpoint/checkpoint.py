"""Tensor-tree checkpointing on npz — no external deps, structure-checked.

Port of ``repro.checkpoint.checkpoint``. Leaves are flattened with
:func:`repro_torch._tree.tree_flatten_with_path`, so the npz carries
stable, human-readable member names (``carry/params``,
``history/loss``); restore verifies that the target structure matches,
re-types leaves to the template where the cast is exact (the JAX
package's uint32 PRNG key words become the port's int64 ones, so either
package restores the other's directories) and puts tensors back on the
template leaf's device. A tensor goes to the host as numpy for the write; a
dtype npz cannot hold (bf16) is written as f32 and cast back on
restore, which is exact.

``CheckpointManager`` adds step-indexed files, atomic writes and
retention. Writes are **crash-consistent** (DESIGN.md §10): the npz is
written to a same-directory temp file, fsynced, renamed over the target
with ``os.replace`` (atomic on POSIX), and the directory entry is
fsynced — so at every instant the target path holds either the complete
previous checkpoint or the complete new one, never a torn write. A
checkpoint that *does* end up unreadable (bit-rot, a truncated copy)
fails restore with an error naming the file — and, when one npz member
is bad, the offending leaf.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch._tree import key_str, tree_flatten_with_path, tree_unflatten

#: Exceptions that mean "this npz is not a readable checkpoint" —
#: truncation (BadZipFile/EOFError), torn members (zlib.error, a bad
#: CRC), OS-level read failures, and numpy's own format complaints
#: (ValueError).
_CORRUPT_ERRORS = (OSError, EOFError, ValueError, zipfile.BadZipFile,
                   zlib.error)

#: The dtypes npz holds as they are.
_NPZ_DTYPES = frozenset(("float64", "float32", "float16", "int64", "int32",
                         "int16", "int8", "uint64", "uint32", "uint16",
                         "uint8", "bool"))


def _npz_dtype(dtype) -> np.dtype:
    """The numpy dtype a leaf of ``dtype`` (torch or numpy) is written
    as: itself where npz holds it, else float32."""
    if isinstance(dtype, torch.dtype):
        try:
            dtype = torch.empty((), dtype=dtype).numpy().dtype
        except TypeError:  # bf16, fp8: no numpy counterpart
            return np.dtype(np.float32)
    dtype = np.dtype(dtype)
    return dtype if dtype.name in _NPZ_DTYPES else np.dtype(np.float32)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        want = _npz_dtype(t.dtype)
        if t.dtype.is_floating_point and want == np.float32:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    return arr.astype(_npz_dtype(arr.dtype), copy=False)


def _fsync_dir(directory: str) -> None:
    """fsync a directory entry so a just-renamed file survives power loss."""
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _replace_atomic(tmp: str, path: str, directory: str) -> None:
    """``os.replace`` + directory fsync, removing ``tmp`` on any failure."""
    try:
        os.replace(tmp, path)
        _fsync_dir(directory)
    finally:
        # os.replace consumed tmp on success; on failure (target is a
        # directory, cross-device link, ...) remove it so an aborted save
        # leaves no stray temp file next to the intact previous file.
        try:
            os.remove(tmp)
        except FileNotFoundError:
            pass


def _write_atomic(path: str, suffix: str, mode: str, write) -> None:
    """The durable write protocol shared by :func:`save_pytree` and
    :func:`write_json_atomic`: temp file in the destination directory →
    ``write(f)`` → ``fsync`` the data → ``os.replace`` over the target →
    ``fsync`` the directory."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=suffix)
    try:
        with os.fdopen(fd, mode) as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        os.remove(tmp)
        raise
    _replace_atomic(tmp, path, directory)


def save_pytree(path: str, tree: Any) -> None:
    """Atomically write ``tree`` to ``path`` as a flat npz. A crash at
    any point leaves the previous ``path`` contents intact."""
    flat, _ = tree_flatten_with_path(tree)
    arrays = {key_str(p): _to_numpy(leaf) for p, leaf in flat}
    _write_atomic(path, ".tmp.npz", "wb", lambda f: np.savez(f, **arrays))


def write_json_atomic(path: str, obj: Any) -> None:
    """Atomic, durable JSON write — same protocol as :func:`save_pytree`.

    Backs the resumable-study manifest (DESIGN.md §10): readers see
    either the previous manifest or the new one, never a torn file.
    """

    def write(f):
        json.dump(obj, f, indent=2, sort_keys=True)
        f.write("\n")

    _write_atomic(path, ".tmp.json", "w", write)


def _exact_cast(arr: np.ndarray, want: np.dtype, path: str, key: str):
    """``arr`` as ``want`` when every value converts exactly: a safe
    cast (int32 → int64, float32 → float64), or integers into another
    integer type that holds each of them (uint32 → int64 key words).
    Anything lossy raises naming the file and the leaf."""
    if arr.dtype == want or np.can_cast(arr.dtype, want, casting="safe"):
        return arr.astype(want, copy=False)
    if arr.dtype.kind in "iu" and want.kind in "iu":
        info = np.iinfo(want)
        if arr.size == 0 or (int(arr.min()) >= info.min
                             and int(arr.max()) <= info.max):
            return arr.astype(want)
        raise ValueError(
            f"checkpoint {path}: dtype mismatch for {key!r}: ckpt "
            f"{arr.dtype} values [{int(arr.min())}, {int(arr.max())}] do "
            f"not fit {want} written for the template")
    raise ValueError(
        f"checkpoint {path}: dtype mismatch for {key!r}: ckpt {arr.dtype} "
        f"does not cast exactly to {want} written for the template")


def _restored(arr: np.ndarray, leaf):
    """``arr`` as the template leaf's type, dtype and device."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    return arr.astype(np.asarray(leaf).dtype)


def restore_pytree(path: str, template: Any) -> Any:
    """Load ``path`` into the structure, dtypes and devices of
    ``template`` (tensors, numpy arrays or Python scalars as leaves).

    A member whose dtype differs from what :func:`save_pytree` writes
    for the template is cast to it when the cast is exact
    (:func:`_exact_cast`). Raises ``ValueError`` naming the file when
    the npz is unreadable (truncated/corrupt), and naming the offending
    leaf when one member is torn, its shape disagrees, or its dtype
    does not cast exactly; ``KeyError`` when the checkpoint is missing a
    template leaf.
    """
    try:
        data = np.load(path)
    except _CORRUPT_ERRORS as e:
        raise ValueError(
            f"checkpoint {path} is unreadable (truncated or corrupt "
            f"npz): {e}") from e
    with data:
        flat, treedef = tree_flatten_with_path(template)
        leaves = []
        for p, leaf in flat:
            key = key_str(p)
            if key not in data:
                raise KeyError(f"checkpoint {path} missing leaf {key!r}")
            try:
                arr = data[key]
            except _CORRUPT_ERRORS as e:
                raise ValueError(
                    f"checkpoint {path}: leaf {key!r} is corrupt "
                    f"(truncated member?): {e}") from e
            shape = tuple(leaf.shape) if hasattr(leaf, "shape") \
                else np.shape(leaf)
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(
                    f"checkpoint {path}: shape mismatch for {key!r}: "
                    f"ckpt {tuple(arr.shape)} vs template {tuple(shape)}")
            want = _npz_dtype(leaf.dtype if isinstance(leaf, torch.Tensor)
                              else np.asarray(leaf).dtype)
            leaves.append(_restored(_exact_cast(arr, want, path, key), leaf))
    return tree_unflatten(treedef, leaves)


_STEP_RE = re.compile(r"^step_(\d+)\.npz$")


def _steps(directory: str) -> list[int]:
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := _STEP_RE.match(f)))


def latest_step(directory: str) -> int | None:
    """The newest ``step_<t>.npz`` in ``directory`` (temp files left by a
    crash before the rename do not count), or None."""
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


class CheckpointManager:
    """Step-indexed checkpoints ``step_<t>.npz`` in one directory,
    keeping the newest ``keep`` (0: all)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.npz")

    def save(self, step: int, tree: Any) -> str:
        p = self.path(step)
        save_pytree(p, tree)
        self._retain()
        return p

    def restore(self, template: Any, step: int | None = None) -> tuple[Any, int]:
        if step is None:
            step = latest_step(self.directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_pytree(self.path(step), template), step

    def _retain(self) -> None:
        steps = _steps(self.directory)
        for s in steps[:-self.keep] if self.keep else []:
            os.remove(self.path(s))

    def delete(self) -> None:
        shutil.rmtree(self.directory, ignore_errors=True)
