"""Builds the port's CUDA sources (``csrc/*.cu``) into shared libraries with
a plain C interface, at first use, and loads them with ctypes.

Each source compiles with ``nvcc``, one after another, into
``build/lib<name>-<hash>.so`` beside this file. The hash covers the
source and the flags, so an edited source never loads a stale library, and
a finished library is moved into place atomically, so processes that build
at the same time do not see half-written files. The compiler's report
(``-Xptxas -v``: registers, shared memory, spills) lands in ``<lib>.log``.
Only the sources in this package are compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """Kernel sources by name (the file's stem)."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are compiled "
                           "at first use and need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = sources()[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source that has no library yet; returns the library
    path of every source. Raises with the compiler's output if a build
    fails."""
    with _lock:
        BUILD.mkdir(parents=True, exist_ok=True)
        libs = {name: library_path(name) for name in sources()}
        for name, lib in libs.items():
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                check=False)
            lib.with_suffix(".log").write_text(proc.stdout)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} "
                                   f"(exit {proc.returncode}):\n{proc.stdout}")
            os.replace(tmp, lib)
        return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all()[name]
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib
