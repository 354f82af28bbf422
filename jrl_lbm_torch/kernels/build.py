"""Build and load the CUDA kernels of `csrc/`.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Libraries land in
``kernels/_build/`` under a name that carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never
loaded. Nothing is built at import: the first launch builds its own
library, and :func:`build_all` builds every library with one ``nvcc``
process each, all started together.
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

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NAMES = ("c_balance", "c_approach", "fluid_a", "fluid_b",
         "fused_fluid", "fused_balance", "fused_approach",
         "cyl_full", "cyl_interior", "cyl_interior_k", "cyl_band_k",
         "fluid_k", "fluid_k_lean", "fluid_k_bt", "periodic",
         "fluid_a_sh", "fluid_b_sh", "c_balance_sh", "c_approach_sh", "halo_pack",
         "cyl_block_sh", "cyl_lean_sh", "cyl_window_sh",
         "fused_fluid_cl", "fused_balance_cl", "fluid_pass",
         "c_approach_pass", "fused_approach_cl", "cyl_pass",
         "fused_fluid_mc", "fused_balance_mc", "fused_approach_mc", "cyl_pass_sh",
         "fluid_pass_sh", "c_balance_pass_sh", "c_approach_pass_sh", "fused_fluid_tl",
         "fused_approach_rw")

# --fmad=false: no multiply-add contraction, so each kernel rounds where
# its plain PyTorch twin does (see csrc/jrl_common.cuh)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}
build_log: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_file(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = _lib_file(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    build_log[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=NAMES) -> float:
    """Build every library that is missing, all ``nvcc`` processes at once;
    returns the seconds taken."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {n: _start(n) for n in names}
        errors = []
        for n, job in jobs.items():
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            _libs[name] = ctypes.CDLL(str(_lib_file(name)))
        return _libs[name]


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of library ``name`` with its argument types declared
    (each pointer and the stream as ``c_void_p``, so none is cut to 32
    bits) and an ``int`` (``cudaError_t``) result; bound once."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        lib = load(name)
        lib.jrl_error_string.restype = ctypes.c_char_p
        lib.jrl_error_string.argtypes = [ctypes.c_int]
        msg = lib.jrl_error_string(err).decode()
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err} ({msg})")
