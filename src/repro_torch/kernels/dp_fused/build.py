"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them.

The sources ``csrc/dp_fused.cu`` (the fused tabulation + contraction pair),
``csrc/prod_force_virial.cu`` (the force-and-virial reduction) and
``csrc/dpa1_attention.cu`` (DPA-1's gated attention core) have a plain C
interface, so they compile in seconds without PyTorch's headers,
in one ``nvcc`` call into one shared library. It goes under
``build/dp_fused/`` at the repository root, named by a hash of the sources
and the flags, and is loaded with ``ctypes``. Nothing is compiled or loaded
when this module is imported: :func:`load` does it on the first launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SOURCES = tuple(Path(__file__).resolve().parent / "csrc" / name
                for name in ("dp_fused.cu", "prod_force_virial.cu",
                             "dpa1_attention.cu"))
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "dp_fused"
# -Xptxas -v makes nvcc report each kernel's registers, shared memory and
# spills; the log is kept on the loaded library for the smoke run to print.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float      # nvcc wall time in this process; 0.0 if reused
    log: str            # nvcc's output ("" if reused)

    def check(self, code: int, what: str) -> None:
        """Raise if an entry point returned a CUDA error code."""
        if code != 0:
            msg = self.lib.dp_fused_error_string(code).decode()
            raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "dp_fused kernels are built from source at first use")


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dp_fused_fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, f, p]
    lib.dp_fused_fwd.restype = i
    lib.dp_fused_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, f, p]
    lib.dp_fused_bwd.restype = i
    lib.prod_force_virial.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                      ctypes.c_longlong, ctypes.c_longlong, p]
    lib.prod_force_virial.restype = i
    lib.dpa1_attention_fwd.argtypes = [p] * 8 + [i, i, i, f, f, p]
    lib.dpa1_attention_fwd.restype = i
    lib.dpa1_attention_bwd.argtypes = [p] * 14 + [i, i, i, f, f, p]
    lib.dpa1_attention_bwd.restype = i
    lib.dp_fused_error_string.argtypes = [i]
    lib.dp_fused_error_string.restype = ctypes.c_char_p


_load_lock = threading.Lock()


def load() -> KernelLibrary:
    """Compile (once per source and flag set) and load the kernel library.

    Threads that launch at once (the ranks of ``md/comm.LocalComm``) wait
    for one build: the temporary file is named by process, not thread.
    """
    with _load_lock:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> KernelLibrary:
    digest = hashlib.sha256(
        b"".join(src.read_bytes() for src in SOURCES)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libdp_fused_{digest}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        # build under a private name, then rename: concurrent processes
        # never load a half-written library
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               *map(str, SOURCES)], capture_output=True,
                              text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed with code {proc.returncode} "
                               f"building {', '.join(map(str, SOURCES))}:"
                               f"\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _bind(lib)
    return KernelLibrary(lib, so, seconds, log)
