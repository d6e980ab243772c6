"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. Libraries go into
``build/repro_torch/<hash of sources and flags>/`` at the root of the
checkout (listed in ``.gitignore``), at first use; all missing libraries
build at once, one ``nvcc`` process each, started together, under a file
lock, so that processes that start at once (the ranks of a mesh) build
each library once. Nothing here runs at import time, so the CPU tests
import every module without a toolkit.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("wedge_check", "wedge_intersect", "fold_scatter", "intersect",
           "hist")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_build_lock = threading.Lock()
# guards the wrappers' launch counters: a service's ingest worker launches
# kernels from a second thread, and ``+=`` on a module global is not atomic
COUNT_LOCK = threading.Lock()

# ctypes argument types of the C entry points
PTR, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, float]:
    """Compile every missing library in parallel; returns the seconds each
    new build took (empty when all were built already). Raises with the
    compiler's output when one fails; ``ptxas`` reports (registers, shared
    memory, spills) are kept in ``<name>.log`` beside each library.

    The build holds an exclusive lock on ``<build dir>.lock``: processes
    that start together (a mesh's ranks) build each library once, and a
    process that finds the lock held waits, then finds the libraries
    built."""
    out = build_dir()
    if all((out / f"lib{n}.so").exists() for n in SOURCES):
        return {}
    out.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f"{out.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_missing(out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_missing(out: Path) -> dict[str, float]:
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        so = out / f"lib{name}.so"
        if so.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    secs = {}
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _build_lock:   # two threads' first launches build once
            so = build_dir() / f"lib{name}.so"
            if not so.exists():
                build_all()
            lib = _libs[name] = ctypes.CDLL(str(so))
    return lib


def function(lib: str, name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``csrc/<lib>.cu``; its signature (an
    int result, ``argtypes``) is set once, when it is first asked for."""
    fn = _fns.get((lib, name))
    if fn is None:
        fn = getattr(library(lib), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[(lib, name)] = fn
    return fn


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_strided(name: str, t: torch.Tensor, dtype: torch.dtype,
                  shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` has the dtype, shape and device the kernel takes
    (any strides: the kernel is given them)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless ``t`` has the dtype, shape, device and contiguity the
    kernel takes."""
    check_strided(name, t, dtype, shape, device)
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")
