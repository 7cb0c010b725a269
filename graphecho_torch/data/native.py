"""ctypes binding of the port's host C++ data kernels (`csrc/dataops.cpp`),
the counterpart of `graphecho_tpu/data/native.py`.

The library is compiled with g++ on first use into `graphecho_torch/_build/`
(listed in `.gitignore`), with the JAX package's flags, so that both
packages compute the same bytes on one host. `-march=native` makes the code
depend on the CPU it was built on (and lets GCC contract the polygon fill's
`xs[i] + t*(xs[j]-xs[i])` into an FMA), so the file name carries a hash of
the source, the flags and what `-march=native` means on this host: a library
built on one machine is never loaded on another. Nothing is built at import.

Where the library cannot be built or loaded (no g++ on the host, a read-only
`_build/`), `load()`, `available()` and the entry points here raise an error
that names the failed command. `try_load()` is what `data/transforms.py`
calls: it returns None instead, warns once (`FallbackWarning`), and
remembers the failure for the life of the process, as the JAX binding's
`_TRIED` does, so that no later item starts g++ again; the transforms then
take their numpy versions, as the JAX package's do. Arrays of a dtype the C
ABI lacks (not float32 or uint8) are refused here; `data/transforms.py`
sends them to its numpy versions too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from graphecho_torch.ops.cuda_build import BUILD_DIR, CSRC

SOURCE = CSRC / "dataops.cpp"
CXX = "g++"
# the JAX package's flags (`graphecho_tpu/data/native.py:29-30`)
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
DTYPES = {np.dtype(np.float32): 0, np.dtype(np.uint8): 1}

_LOCK = threading.Lock()
# the loaded library by compiler command, so that g++ is asked once a process
_LIBS: Dict[Tuple[str, ...], ctypes.CDLL] = {}
# why the library could not be built or loaded, by compiler command: once
# failed, `try_load` asks g++ no more in this process
_FAILED: Dict[Tuple[str, ...], str] = {}


class CompilerError(RuntimeError):
    """A compiler command that failed to start or exited non-zero."""


class FallbackWarning(RuntimeWarning):
    """The library could not be built or loaded; the numpy versions run."""


def _run(cmd, **kwargs) -> subprocess.CompletedProcess:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, **kwargs)
    except OSError as e:
        raise CompilerError(f"the data kernels of graphecho_torch cannot be built: "
                            f"{' '.join(cmd)} failed: {e}") from e
    if proc.returncode != 0:
        raise CompilerError(f"the data kernels of graphecho_torch cannot be built: "
                            f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr}")
    return proc


def _target() -> str:
    """What the flags mean on this host: the compiler's own expansion of
    `-march=native` (the cc1plus line of `g++ -v`) and its version."""
    proc = _run([CXX, *CXX_FLAGS[:3], "-E", "-v", "-x", "c++", "-"], input="")
    lines = [ln for ln in proc.stderr.splitlines() if "cc1plus" in ln or "version" in ln]
    return "\n".join([platform.machine(), *lines])


def library_path() -> Path:
    """Where `csrc/dataops.cpp` is built to, keyed by its content, the flags
    and the host's CPU."""
    key = SOURCE.read_bytes() + " ".join((CXX, *CXX_FLAGS)).encode() + _target().encode()
    return BUILD_DIR / f"libdataops-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `csrc/dataops.cpp` unless an up-to-date library exists."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        _run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)])
        os.replace(tmp, out)
    return out


def _load(key: Tuple[str, ...]) -> ctypes.CDLL:
    """`load()` with `_LOCK` held."""
    lib = _LIBS.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build()))
        i64 = ctypes.c_int64
        lib.ge_nearest_resize_batch.argtypes = [
            ctypes.c_void_p, i64, i64, i64, i64, ctypes.c_void_p, i64, i64, ctypes.c_int]
        lib.ge_polygon_mask.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            i64, i64, i64, ctypes.POINTER(ctypes.c_float)]
        lib.ge_normalize_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), i64, ctypes.POINTER(ctypes.c_float)]
        _LIBS[key] = lib
    return lib


def load() -> ctypes.CDLL:
    """The ctypes handle of the library, built on first use; raises when it
    cannot be built or loaded."""
    with _LOCK:
        return _load((CXX, *CXX_FLAGS))


def try_load() -> Optional[ctypes.CDLL]:
    """`load()`, or None where the library cannot be built or loaded. The
    first failure warns (`FallbackWarning`, naming the failed command) and is
    kept: later calls return None at once, without starting g++."""
    key = (CXX, *CXX_FLAGS)
    with _LOCK:
        if key in _FAILED:
            return None
        try:
            return _load(key)
        except (CompilerError, OSError) as e:  # g++ failed or is missing; ctypes.CDLL failed
            _FAILED[key] = str(e)
    warnings.warn(f"{_FAILED[key]}\nthe numpy versions in graphecho_torch.data.transforms "
                  "take over for the rest of this process (the same bytes)",
                  FallbackWarning, stacklevel=3)
    return None


def available() -> bool:
    """True once the library is built and loaded (raises where it cannot be)."""
    load()
    return True


def _dtype_code(arr: np.ndarray) -> int:
    code = DTYPES.get(arr.dtype)
    if code is None:
        raise TypeError(f"the native nearest resize takes float32 or uint8, not {arr.dtype}")
    return code


def nearest_resize_batch(arr: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """(N, H, W, C) nearest resize of each image to (oh, ow), threaded over N."""
    code = _dtype_code(arr)
    lib = load()
    n, h, w, c = arr.shape
    src = np.ascontiguousarray(arr)
    out = np.empty((n, oh, ow, c), arr.dtype)
    lib.ge_nearest_resize_batch(src.ctypes.data_as(ctypes.c_void_p), n, h, w, c,
                                out.ctypes.data_as(ctypes.c_void_p), oh, ow, code)
    return out


def nearest_resize(arr: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Nearest resize of the leading two dims of an (H, W, ...) array; source
    index floor(i * in / out)."""
    h, w = arr.shape[:2]
    trailing = arr.shape[2:]
    c = int(np.prod(trailing)) if trailing else 1
    out = nearest_resize_batch(arr.reshape(1, h, w, c), oh, ow)
    return out.reshape((oh, ow) + trailing)


def polygon_mask(ys: Sequence[float], xs: Sequence[float],
                 shape: Tuple[int, int]) -> np.ndarray:
    """Even-odd scanline fill of a polygon into a float32 {0, 1} mask."""
    ys = np.ascontiguousarray(ys, np.float64)
    xs = np.ascontiguousarray(xs, np.float64)
    if ys.shape != xs.shape:
        raise ValueError(f"ys/xs length mismatch: {ys.shape} vs {xs.shape}")
    lib = load()
    out = np.zeros(shape, np.float32)
    lib.ge_polygon_mask(ys.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        len(ys), shape[0], shape[1],
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def normalize_u8(arr: np.ndarray) -> np.ndarray:
    """uint8 -> float32 scaled by 1/255 (the reference's `/255.0`)."""
    if arr.dtype != np.uint8:
        raise TypeError(f"normalize_u8 takes uint8, not {arr.dtype}")
    lib = load()
    src = np.ascontiguousarray(arr)
    out = np.empty(arr.shape, np.float32)
    lib.ge_normalize_u8(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
