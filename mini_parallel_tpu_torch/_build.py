"""Build the CUDA sources under ``csrc/`` with nvcc and load them.

Each library is compiled at first use into ``_build/`` (listed in
.gitignore), keyed by a hash of its sources and flags, into a shared
library with a plain C interface that ``ctypes`` loads. There is no
fallback: without nvcc the build raises :class:`BuildError`, and the
caller's CUDA tensor goes nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class BuildError(RuntimeError):
    """A CUDA source could not be built."""


def find_nvcc() -> str:
    """nvcc of the CUDA toolkit PyTorch finds (CUDA_HOME, CUDA_PATH, PATH,
    or the toolkit's default location), or BuildError."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "", "bin", "nvcc")
    if CUDA_HOME is None or not nvcc.is_file():
        raise BuildError(
            "nvcc not found: building the CUDA kernels needs the CUDA "
            "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(nvcc)


def library_path(name: str, sources: tuple[str, ...]) -> Path:
    """Where the build of ``sources`` lands: ``_build/<name>-<hash>.so``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: tuple[str, ...]) -> tuple[Path, float]:
    """Compile ``sources`` (file names under csrc/) unless their build
    exists. Returns the library's path and the seconds spent compiling
    (0.0 when it was already built). nvcc's report, with ptxas's register
    and spill counts, is kept beside the library as ``<name>-<hash>.log``."""
    out = library_path(name, sources)
    if out.is_file():
        return out, 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in sources)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(
                f"nvcc failed ({proc.returncode}) building {name}:\n"
                f"{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Build (if needed) and load one library; loaded once per process."""
    path, _ = build(name, sources)
    return ctypes.CDLL(str(path))
