"""Build a kernel source with ``nvcc`` at first use and load it with ctypes.

Each kernel package keeps its CUDA C++ under ``csrc/`` with a plain C
interface (no PyTorch headers, so a build takes seconds). The shared
library is written to ``src/repro_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of every file in the
source's ``csrc/`` directory (the source and any header beside it) and
of the flags, so an edited source or header is rebuilt and an unchanged
one is loaded as it is. ptxas reports each kernel's registers, shared
memory and spills (``-Xptxas -v``); the report is kept beside the
library (:func:`build_log`). The target is Hopper, ``sm_90a``. No
library is linked: a kernel that needs a driver function (TMA's
``cuTensorMapEncodeTiled``) reaches it through the runtime's
``cudaGetDriverEntryPoint``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels are built from source at first use")
    return found


def library_path(source: Path) -> Path:
    """Where the library of ``source`` is built: its name hashes the
    flags and every file under the source's directory, by relative path
    and content."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    root = source.parent
    for path in sorted(p for p in root.rglob("*") if p.is_file()):
        name = path.relative_to(root).as_posix().encode()
        digest.update(len(name).to_bytes(8, "little") + name)
        data = path.read_bytes()
        digest.update(len(data).to_bytes(8, "little") + data)
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build_log(source: Path) -> str:
    """nvcc's report (ptxas registers, shared memory, spills and any
    warning) from the build of ``source``'s current library."""
    return library_path(source).with_suffix(".log").read_text()


def compile_library(source: Path) -> Path:
    """Compile ``source`` unless its library is already built. The build
    writes to a temporary name and renames it, so two processes building
    at once both end with a whole library."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load_library(source: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(compile_library(source)))
