"""Build the port's CUDA sources with `nvcc` and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use,
for `sm_90a`, into a shared library under `graphecho_torch/_build/` (listed
in `.gitignore`). The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds each library took to build in this process (0.0 when it was cached)
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels of graphecho_torch cannot be built")


def nvcc_compile(src: Path, out: Path, *extra: str) -> str:
    """Compile `src` into the shared library `out` with NVCC_FLAGS and `extra`;
    returns nvcc's stderr (where `-Xptxas -v` reports) and raises on failure."""
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *extra, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    return proc.stderr


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` is built to, keyed by its content and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless an up-to-date library exists."""
    out = library_path(name)
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    nvcc_compile(CSRC / f"{name}.cu", tmp)
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
