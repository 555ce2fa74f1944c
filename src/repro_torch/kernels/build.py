"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each source under ``csrc/`` compiles on first use into a shared library
with a plain C interface, under ``_build/`` next to this file, named with
a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing is built when the module is
imported.  A failing ``nvcc`` raises with its standard error.

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>_<hash>.so csrc/<name>.cu

``-Xptxas -v`` makes ptxas report each kernel's registers, shared memory
and spills; ``build`` returns that report with the build time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path          # the shared library
    log: str            # nvcc's output (-Xptxas -v report); "" if cached
    seconds: float      # wall time of the nvcc run; 0.0 if cached


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels need the CUDA toolkit")
    return path


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source
    and these flags already exists; return where it is."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return Build(out, "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builds (test
    # workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return Build(out, proc.stdout + proc.stderr, seconds)


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def kmeans_library() -> ctypes.CDLL:
    """The k-means kernels' library, built on first call, with every C
    entry point's signature declared (pointers and the stream as
    ``c_void_p``, so no pointer is cut to 32 bits)."""
    lib = ctypes.CDLL(str(build("kmeans").path))
    lib.kmeans_tile.argtypes = []
    lib.kmeans_tile.restype = _I
    lib.kmeans_error_string.argtypes = [_I]
    lib.kmeans_error_string.restype = ctypes.c_char_p
    lib.kmeans_assign.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P]
    lib.kmeans_assign.restype = _I
    lib.kmeans_lloyd_step.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                                      _P]
    lib.kmeans_lloyd_step.restype = _I
    return lib
