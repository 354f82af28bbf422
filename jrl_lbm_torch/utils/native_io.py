"""ctypes bindings of the native Tecplot writer and reader
(counterpart of the JAX package's `utils/native_io.py`).

``native/tecplot_io.cc`` (this package's own copy) formats a whole zone
in C++, byte for byte what the Python writers of `utils/io.py` write, at
a fraction of their time (a 1024x512 dump costs seconds in Python). It is
built with ``g++`` at first use into the git-ignored ``kernels/_build/``,
under a name that carries a hash of the source. Where no ``g++`` exists,
`get_lib` returns None and the writers format in Python; a compiler that
fails raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).parent / "native" / "tecplot_io.cc"
BUILD_DIR = Path(__file__).parents[1] / "kernels" / "_build"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"tecplot_io-{h.hexdigest()[:16]}.so"


def _build(cxx: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: processes building at once each land a whole library


@functools.cache
def get_lib():
    """The loaded native library, built first if needed; None where no
    ``g++`` exists."""
    out = lib_path()
    if not out.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            return None
        _build(cxx, out)
    lib = ctypes.CDLL(str(out))
    i64 = ctypes.c_int64
    fp = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    lib.tecplot_write_c_rho.argtypes = [ctypes.c_char_p, fp, fp, fp, fp, i64, i64]
    lib.tecplot_write_c_rho.restype = ctypes.c_int
    lib.tecplot_write_single.argtypes = [ctypes.c_char_p, fp, fp, fp, i64, i64]
    lib.tecplot_write_single.restype = ctypes.c_int
    lib.tecplot_read_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.tecplot_read_dims.restype = ctypes.c_int
    lib.tecplot_read_c_rho.argtypes = [ctypes.c_char_p, fp, fp, fp, fp, i64, i64]
    lib.tecplot_read_c_rho.restype = ctypes.c_int
    return lib


def _planes(rho, *others):
    """float32 C-contiguous ``[H, W]`` planes of one shape, and (H, W)."""
    planes = [np.ascontiguousarray(a, np.float32) for a in (rho,) + others]
    if planes[0].ndim != 2 or any(p.shape != planes[0].shape for p in planes):
        raise ValueError(f"expected [H, W] planes of one shape, got {[p.shape for p in planes]}")
    return planes, planes[0].shape


def _written(rc: int, filename: str) -> bool:
    if rc != 0:
        raise OSError(f"native Tecplot writer could not write {filename} (code {rc})")
    return True


def write_c_rho(filename: str, C, rho, u, v) -> bool:
    """The 'X Y C RHO U V NormX NormY' zone; False where the native
    library is unavailable (the caller formats in Python)."""
    lib = get_lib()
    if lib is None:
        return False
    (rho, C, u, v), (H, W) = _planes(rho, C, u, v)
    return _written(lib.tecplot_write_c_rho(filename.encode(), C, rho, u, v, H, W), filename)


def write_single(filename: str, rho, u, v) -> bool:
    """The 'X Y RHO U V' zone; False where the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    (rho, u, v), (H, W) = _planes(rho, u, v)
    return _written(lib.tecplot_write_single(filename.encode(), rho, u, v, H, W), filename)


def read_c_rho(filename: str):
    """``[C, rho, u, v]`` of a 'X Y C RHO U V ...' zone, each ``[1, 1, H, W]``
    float32 (the reference reader's shape); None where the native library
    is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    H, W = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.tecplot_read_dims(filename.encode(), ctypes.byref(H), ctypes.byref(W))
    if rc != 0:
        raise OSError(f"cannot read the zone size of {filename} (code {rc})")
    H, W = H.value, W.value
    out = [np.zeros((H, W), np.float32) for _ in range(4)]
    rc = lib.tecplot_read_c_rho(filename.encode(), *out, H, W)
    if rc != 0:
        raise OSError(f"cannot read the zone of {filename} (code {rc})")
    return [a.reshape(1, 1, H, W) for a in out]
