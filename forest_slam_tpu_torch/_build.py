"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file has a plain C interface (``extern "C"`` launchers
that take raw pointers, ints and a ``cudaStream_t`` and return
``cudaGetLastError()``) and includes no PyTorch header. One ``nvcc`` command
compiles all of them for ``sm_90a`` into one shared library under
``_build/`` (listed in ``.gitignore``), named by a hash of the sources and the
flags. The library is built at first use, written under a temporary name and
renamed into place, so an interrupted build leaves nothing that a later build
would wait on.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_functions: dict[str, ctypes._CFuncPtr] = {}
# what the last build did, for callers that report it
last_build = {"seconds": None, "cached": None, "log": ""}

P = ctypes.c_void_p  # device pointers and the stream
I = ctypes.c_int


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfs_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the library for these sources exists."""
    path = library_path()
    if os.path.exists(path):
        last_build.update(seconds=0.0, cached=True, log="")
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *sources()]
    t0 = time.time()
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S
        )
    except subprocess.TimeoutExpired as e:
        _remove(tmp)
        raise RuntimeError(
            f"nvcc timed out after {BUILD_TIMEOUT_S} s:\n{e.stdout or ''}{e.stderr or ''}"
        ) from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        _remove(tmp)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, path)
    last_build.update(seconds=time.time() - t0, cached=False, log=log)
    return path


def _remove(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)


def function(name: str, *argtypes) -> ctypes._CFuncPtr:
    """The launcher ``name`` from the kernel library, built and loaded on
    first use, with its argument types set."""
    global _lib
    with _lock:
        if name not in _functions:
            if _lib is None:
                _lib = ctypes.CDLL(build())
            fn = getattr(_lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[name] = fn
        return _functions[name]


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
