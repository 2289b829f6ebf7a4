"""Native CPU backend: ctypes bindings to the fp64 C++ oracle solver
(counterpart of ``poisson_tpu/native/__init__.py``).

``poisson_oracle.cpp`` beside this file is the JAX package's oracle source,
byte for byte (``tests/test_torch_native.py`` holds the two identical). It
is compiled on first use with the JAX package's Makefile flags (``g++ -O2
-std=c++17 -fPIC -fopenmp -shared``; ``CXX`` and ``CXXFLAGS`` override the
compiler and the optimization flags) into the port's build directory
``poisson_tpu_torch/ops/build/``, named by a hash of the source and the
command, and loaded with ``ctypes``. When ``CXX`` names a compiler that
cannot build it (a toolchain wrapper without OpenMP's ``libgomp.spec``, as
on some CUDA hosts), ``g++`` on the ``PATH`` is tried next; the error lists
every attempt. Concurrent builds (several test workers) each write their
own temporary file and ``os.replace`` it, which is atomic.

This is the reference's serial/OpenMP stage as a backend: it runs on the
host CPU by nature, only when a caller asks for it by name
(``--backend native``), and is never a fallback for a card path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from poisson_tpu_torch.config import Problem

SRC = Path(__file__).resolve().parent / "poisson_oracle.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "ops" / "build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_built: Optional[str] = None


class NativeResult(NamedTuple):
    """Mirrors ``solvers.pcg.PCGResult`` (numpy instead of tensors)."""

    w: np.ndarray
    iterations: int
    diff: float
    residual_dot: float


def compilers() -> list[str]:
    """The compilers to try, in order: ``CXX`` when set, then ``g++``."""
    return list(dict.fromkeys(c for c in (os.environ.get("CXX"), "g++")
                              if c))


def _command(cxx: str, out: str) -> list[str]:
    """The compile command, the JAX wrapper's: ``CXXFLAGS`` is
    overridable, the flags the library cannot link or load without are
    not."""
    cxxflags = os.environ.get("CXXFLAGS", "-O2").split()
    return [cxx, *cxxflags, "-std=c++17", "-fPIC", "-fopenmp", "-shared",
            str(SRC), "-o", out]


def library_path(cxx: str = "g++") -> Path:
    """Where the library built by ``cxx`` from this source lives."""
    tag = hashlib.sha256(SRC.read_bytes()
                         + " ".join(_command(cxx, "")).encode()).hexdigest()
    return BUILD_DIR / f"poisson_oracle-{tag[:16]}.so"


def _compile(cxx: str) -> Optional[str]:
    """Build with ``cxx``; None on success, else the error."""
    lib = library_path(cxx)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = _command(cxx, tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            return f"({' '.join(cmd)}):\n{proc.stderr}"
        os.replace(tmp, lib)
        return None
    except OSError as e:        # no such compiler
        return f"({' '.join(cmd)}): {e}"
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build(force: bool = False) -> str:
    """Compile the oracle library if it is missing (with the first of
    :func:`compilers` that builds it); returns its path."""
    global _built
    with _lock:
        if _built is not None and not force:
            return _built
        errors = []
        for cxx in compilers():
            lib = library_path(cxx)
            if force or not lib.exists():
                err = _compile(cxx)
                if err is not None:
                    errors.append(err)
                    continue
            _built = str(lib)
            return _built
    raise RuntimeError("native oracle build failed " + "\n".join(errors))


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.poisson_native_solve.restype = ctypes.c_int
        lib.poisson_native_solve.argtypes = [
            ctypes.c_int, ctypes.c_int,                      # M, N
            ctypes.c_double, ctypes.c_double,                # x_min, x_max
            ctypes.c_double, ctypes.c_double,                # y_min, y_max
            ctypes.c_double, ctypes.c_double,                # f_val, delta
            ctypes.c_int64,                                  # max_iter
            ctypes.c_int, ctypes.c_int,                      # weighted, threads
            ctypes.POINTER(ctypes.c_double),                 # w_out
            ctypes.POINTER(ctypes.c_int64),                  # iters_out
            ctypes.POINTER(ctypes.c_double),                 # diff_out
            ctypes.POINTER(ctypes.c_double),                 # zr_out
        ]
        lib.poisson_native_has_openmp.restype = ctypes.c_int
        lib.poisson_native_has_openmp.argtypes = []
        _lib = lib
    return _lib


def has_openmp() -> bool:
    return bool(_load().poisson_native_has_openmp())


def native_solve(problem: Problem, num_threads: int = 0) -> NativeResult:
    """fp64 PCG solve in native code. ``num_threads=0`` keeps the library's
    current OpenMP team (the arithmetic is the same; only the reductions'
    summation order differs across team sizes, so exact counts need
    ``num_threads=1``)."""
    lib = _load()
    w = np.zeros(problem.grid_shape, dtype=np.float64)
    iters = ctypes.c_int64(0)
    diff = ctypes.c_double(0.0)
    zr = ctypes.c_double(0.0)
    rc = lib.poisson_native_solve(
        problem.M, problem.N,
        problem.x_min, problem.x_max, problem.y_min, problem.y_max,
        problem.f_val, problem.delta, problem.iteration_cap,
        int(problem.weighted_norm), int(num_threads),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(iters), ctypes.byref(diff), ctypes.byref(zr),
    )
    if rc != 0:
        raise RuntimeError(f"poisson_native_solve failed with code {rc}")
    return NativeResult(w=w, iterations=int(iters.value), diff=diff.value,
                        residual_dot=zr.value)
