"""One build recipe for the port's CUDA kernel libraries.

Each library is one ``.cu`` file with a plain ``extern "C"`` interface,
compiled by ``nvcc`` for ``sm_90a`` at first use into ``build/repro_torch/``
(the file name carries a hash of the source and the flags, so an edited
source builds anew) and loaded with ``ctypes``.  The compiler's
``-Xptxas -v`` report (each kernel's registers, shared memory and spills)
is kept beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put it on PATH")
    return found


class CudaLibrary:
    """A kernel library built from ``source``; ``bind`` sets the ctypes
    ``argtypes``/``restype`` of its functions once it is loaded."""

    def __init__(self, source: Path, stem: str,
                 bind: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
        self.stem = stem
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"{self.stem}_{digest[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless this version is already built; returns
        the shared library's path."""
        out = self.path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{self.source.name}:\n{proc.stdout}"
                               f"{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        # Atomic: a concurrent builder never sees a partial file.
        os.replace(tmp, out)
        return out

    def ptxas_report(self) -> str:
        log = self.path().with_suffix(".log")
        return log.read_text() if log.exists() else ""

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library once per process."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
        return self._lib
