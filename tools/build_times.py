"""Time the ``nvcc`` build of each kernel library on this host.

Usage (on a machine with ``nvcc``)::

    python3 tools/build_times.py

Builds every library of ``kernels/build.py::NAMES`` into a temporary
directory, all at once with the flags ``build.build_all`` gives them
(``build.nvcc_flags``), and prints each library's seconds; then each
library of ``build.SPLIT`` alone, with and without ``--split-compile=0``,
and whether the two builds' SASS (``cuobjdump -sass``) is the same. Nothing
is written into the repository; the package's build directory is not
touched.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jrl_lbm_torch.kernels import build as B  # noqa: E402


def nvcc(name: str, flags, out: str) -> float:
    """Seconds of one ``nvcc`` of library ``name`` with ``flags``."""
    t0 = time.monotonic()
    p = subprocess.run([B.nvcc_path(), *flags, "-o", out, str(B.CSRC / f"{name}.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{p.stdout}{p.stderr}")
    return time.monotonic() - t0


def sass(lib: str) -> list[str]:
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(B.nvcc_path()),
                                                     "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True)
    return [ln for ln in out.stdout.splitlines() if ln.strip()]


def main() -> int:
    print(f"{os.cpu_count()} CPUs", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        res = {}

        def one(n):
            res[n] = nvcc(n, B.nvcc_flags(n), os.path.join(tmp, f"{n}.so"))

        t0 = time.monotonic()
        threads = [threading.Thread(target=one, args=(n,)) for n in B.NAMES]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        print(f"all {len(B.NAMES)} at once as build_all: {time.monotonic() - t0:.1f} s",
              flush=True)
        for n, s in sorted(res.items(), key=lambda x: -x[1]):
            print(f"  {s:7.1f} s  {n}", flush=True)
        for n in B.SPLIT:
            plain, split = (os.path.join(tmp, f"{n}_{x}.so") for x in ("plain", "split"))
            t_plain = nvcc(n, B.NVCC_FLAGS, plain)
            t_split = nvcc(n, B.NVCC_FLAGS + ["--split-compile=0"], split)
            print(f"{n} alone: {t_plain:.1f} s, with --split-compile=0 {t_split:.1f} s; SASS "
                  f"{'the same' if sass(plain) == sass(split) else 'DIFFERENT'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
