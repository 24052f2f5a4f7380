"""The native (C++) host data plane: the FASTQ decoder, the 2-bit packer
and the k-mer store, built with g++ at first use.

The counterpart of mini_parallel_tpu/native/. Each library is compiled from
its source in this directory into ``mini_parallel_tpu_torch/_build/``,
keyed by a hash of the source, the flags and ``g++ --version``, and written
atomically (``_build.compile_library``), so concurrent processes may build
it at once. A failed build raises :class:`BuildError` with g++'s output;
nothing here returns a library that was not built from these sources.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import shutil
import subprocess
from pathlib import Path

from mini_parallel_tpu_torch import _build
from mini_parallel_tpu_torch._build import BuildError

SRC_DIR = Path(__file__).resolve().parent
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
# library name -> (source, link flags)
LIBRARIES = {
    "fastq": ("fastq_reader.cpp", ("-lz", "-lpthread")),
    "pack2bit": ("pack2bit.cpp", ()),
    "kmerstore": ("kmer_store.cpp", ()),
}

__all__ = ["BuildError", "LIBRARIES", "build", "library_path", "load"]


@functools.lru_cache(maxsize=None)
def _compiler() -> tuple[str, str]:
    """g++'s path and its ``--version`` text, or BuildError."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise BuildError("g++ not found: the native host libraries need a "
                         "C++17 compiler (and zlib's headers for the FASTQ "
                         "decoder)")
    proc = subprocess.run([gxx, "--version"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise BuildError(f"{gxx} --version failed:\n{proc.stderr}")
    return gxx, proc.stdout


def library_path(name: str) -> Path:
    """Where the build of library ``name`` lands:
    ``_build/<name>-<hash>.so``, the hash over its source, the flags and
    the compiler's version."""
    src, link = LIBRARIES[name]
    h = hashlib.sha256(" ".join((*CXX_FLAGS, *link)).encode())
    h.update(_compiler()[1].encode())
    h.update((SRC_DIR / src).read_bytes())
    return _build.BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, float]:
    """Compile library ``name`` unless its build exists. Returns its path
    and the seconds g++ took (0.0 when it was already built)."""
    out = library_path(name)
    if out.is_file():
        return out, 0.0
    src, link = LIBRARIES[name]
    cmd = [_compiler()[0], *CXX_FLAGS, str(SRC_DIR / src), *link]
    return out, _build.compile_library(cmd, out, name)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one library, once per process. A library
    that builds but does not load raises BuildError too."""
    path, _ = build(name)
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise BuildError(f"cannot load {path}: {e}") from e

