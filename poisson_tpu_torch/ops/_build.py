"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/fused_cg.cu`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``ops/build/`` (listed in
``.gitignore``); ``ctypes`` loads it. The file name carries a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing here runs at import: this module is imported on
machines with no ``nvcc`` and no card, where only the plain versions run.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_cg.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Kernels:
    """The loaded library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an existing build was loaded
    log: str               # nvcc's output (ptxas registers and spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA "
        "kernels are built from source at first use on the card"
    )


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_cg_block_size.argtypes = []
    lib.fused_cg_block_size.restype = i32
    lib.fused_cg_error_string.argtypes = [i32]
    lib.fused_cg_error_string.restype = ctypes.c_char_p
    # beta z p cs cw g pn ap part | rows cols halo blocks device | stream
    lib.fused_cg_direction_stencil.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
    lib.fused_cg_direction_stencil.restype = i32
    # alpha p ap sc2 w r diff_part zr_part | cols halo blocks device | stream
    lib.fused_cg_update.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    lib.fused_cg_update.restype = i32


@functools.lru_cache(maxsize=None)
def load_kernels() -> Kernels:
    """Build (if needed) and load the kernel library; cached per process."""
    source = SOURCE.read_bytes()
    tag = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"fused_cg-{tag[:16]}.so"
    build_seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        build_seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n{log}")
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    return Kernels(lib=lib, path=out, build_seconds=build_seconds, log=log)


def check(kernels: Kernels, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        name = kernels.lib.fused_cg_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({name})")
