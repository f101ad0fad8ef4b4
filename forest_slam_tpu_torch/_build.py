"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file has a plain C interface (``extern "C"`` launchers
that take raw pointers, ints and a ``cudaStream_t`` and return
``cudaGetLastError()``) and includes no PyTorch header. One ``nvcc`` per
source, all started together, compiles each for ``sm_90a`` into an object
file; one more links them into one shared library under ``_build/`` (listed
in ``.gitignore``), named by a hash of the sources and the flags. The library
is built at first use, written under a temporary name and renamed into place,
so an interrupted build leaves nothing that a later build would wait on.
The headers the sources share (``csrc/*.cuh``, included by a quoted name
from the same directory) feed the hash too, so an edit to one of them names
a new library.
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

from forest_slam_tpu_torch.utils import trace

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_functions: dict[str, ctypes._CFuncPtr] = {}
# nvcc's output of the last build (its -Xptxas -v report), for callers that
# print it; the build's seconds and whether it compiled are the
# fs.setup.kernel_library span's (utils/trace.py)
last_log = ""

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


def headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfs_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the library for these sources exists, in
    the one-shot span ``fs.setup.kernel_library`` (``built``: whether nvcc
    ran)."""
    with trace.setup_span("fs.setup.kernel_library", built=False) as sp:
        path = library_path()
        if not os.path.exists(path):
            _compile(path)
            sp.attrs["built"] = True
    return path


def _compile(path: str) -> None:
    global last_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    obj_dir = f"{tmp}.objs"
    os.makedirs(obj_dir)
    try:
        objs = [os.path.join(obj_dir, os.path.basename(src) + ".o") for src in sources()]
        log = _run_all([[nvcc_path(), *NVCC_FLAGS, "-c", "-o", obj, src] for src, obj in zip(sources(), objs)])
        log += _run_all([[nvcc_path(), "-shared", "-o", tmp, *objs]])
        os.replace(tmp, path)
    finally:
        _remove(tmp)
        shutil.rmtree(obj_dir, ignore_errors=True)
    last_log = log


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; their joined output, or RuntimeError
    with the output of each that failed or timed out."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    deadline = time.time() + BUILD_TIMEOUT_S
    outs, errors = [], []
    for cmd, proc in zip(cmds, procs):
        try:
            out, _ = proc.communicate(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            errors.append(f"nvcc timed out after {BUILD_TIMEOUT_S} s:\n{' '.join(cmd)}\n{out}")
            continue
        outs.append(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{out}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return "".join(outs)


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
