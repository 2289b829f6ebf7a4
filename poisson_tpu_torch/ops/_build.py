"""Build and load the port's CUDA kernels.

Every source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, at first use, into
``ops/build/`` (listed in ``.gitignore``); ``ctypes`` loads it. The file name
carries a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. :func:`load_all` starts one ``nvcc``
per missing library, all at once, and waits for them together. Nothing here
runs at import: this module is imported on machines with no ``nvcc`` and no
card, where only the plain versions run.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# (seconds, nvcc output) of the builds this process ran, by library name.
_BUILD_LOGS: dict[str, tuple[float, str]] = {}


@dataclasses.dataclass(frozen=True)
class Kernels:
    """One loaded library and how it was obtained."""

    name: str
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an existing build was loaded
    log: str               # nvcc's output (ptxas registers and spills)


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


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


def _target(name: str) -> Path:
    tag = hashlib.sha256(source(name).read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:16]}.so"


def build(names) -> None:
    """Compile the libraries of ``names`` that are not built yet, one
    ``nvcc`` each, all running at once; raise if any fails."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        # contracts: allow=wallclock -- host-side build timing, no solve
        running[name] = (proc, tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in running.items():
        log = proc.communicate()[0]
        # contracts: allow=wallclock -- host-side build timing, no solve
        _BUILD_LOGS[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {source(name).name}:\n{log}")
        else:
            os.replace(tmp, _target(name))   # atomic: all or none is seen
    if failed:
        raise RuntimeError("\n".join(failed))


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_I64 = ctypes.c_longlong
_I32_OUT = ctypes.POINTER(_I32)

# The C entries of each library: symbol → (argument types, return type).
# Every library also exports ``<name>_error_string``.
ENTRIES = {
    "fused_cg": {
        "fused_cg_block_size": ([], _I32),
        # beta z p cs cw g colmask pn ap part | rows cols halo lo hi blocks
        # device | stream (a null colmask: the single-device form)
        "fused_cg_direction_stencil": ([_PTR] * 10 + [_I32] * 7 + [_PTR],
                                       _I32),
        # alpha p ap sc2 colmask w r diff_part zr_part | cols halo blocks
        # device | stream
        "fused_cg_update": ([_PTR] * 9 + [_I32] * 4 + [_PTR], _I32),
        # denom_sum zr done alpha degenerate | h1h2 | device | stream
        "fused_cg_recurrence_step": ([_PTR] * 5 + [_F32, _I32, _PTR], _I32),
        # alpha degenerate diff_sum zr_sum k done zr beta diff k_out
        # done_out zr_out beta_out diff_out | h1h2 norm_w delta | device
        # | stream
        "fused_cg_recurrence_close": ([_PTR] * 14 + [_F32] * 3
                                      + [_I32, _PTR], _I32),
    },
    "ca_cg": {
        "ca_cg_layout": ([_I32_OUT] * 4, None),
        # device, out: SM count, kernel C's blocks per SM
        "ca_cg_sweep_occupancy": ([_I32, _I32_OUT, _I32_OUT], _I32),
        # beta pprev r cs cw g sc2 colmask pn t1 t2 t3 gram | rows cols halo
        # lo hi seg_h device | stream
        "ca_cg_basis_sweep": ([_PTR] * 13 + [_I32] * 7 + [_PTR], _I32),
        # coefs pn t1 t2 t3 colmask x r p1 rr_part | cols halo blocks device
        # | stream
        "ca_cg_pair_update": ([_PTR] * 10 + [_I32] * 4 + [_PTR], _I32),
    },
    "resident_cg": {
        "resident_cg_layout": ([_I32_OUT] * 4, None),
        # device, out: SM count, shared memory a block may opt in to
        "resident_cg_device": ([_I32, _I32_OUT, _I32_OUT], _I32),
        # cs cw g rhs sc2 w r ap xch spill part k diff zr | h1h2 norm_w
        # delta | cap rows cols halo off_pn off_cs off_cw off_g off_sc2
        # off_w spill_stride smem_bytes blocks device | stream
        "resident_cg_solve": ([_PTR] * 14 + [_F32] * 3 + [_I32] * 14
                              + [_PTR], _I32),
    },
    "blocked_cg": {
        "blocked_cg_layout": ([_I32_OUT] * 3, None),
        # beta z p cs cw g pn ap part | rows cols halo cg bm bn nb ncb device
        # | stream
        "blocked_cg_direction_stencil": ([_PTR] * 9 + [_I32] * 9 + [_PTR],
                                         _I32),
        # alpha p ap sc2 w r diff_part zr_part | cols halo cg bm bn nb ncb
        # device | stream
        "blocked_cg_update": ([_PTR] * 8 + [_I32] * 8 + [_PTR], _I32),
    },
    "serial_sum": {
        "serial_sum_threads": ([], _I32),
        # src out | n elem_stride vec_stride run | vectors device | stream
        "serial_sum_launch": ([_PTR] * 2 + [_I64] * 4 + [_I32] * 2 + [_PTR],
                              _I32),
    },
}


def _bind(name: str, lib: ctypes.CDLL) -> None:
    entries = {f"{name}_error_string": ([_I32], ctypes.c_char_p),
               **ENTRIES[name]}
    for symbol, (argtypes, restype) in entries.items():
        getattr(lib, symbol).argtypes = argtypes
        getattr(lib, symbol).restype = restype


@functools.lru_cache(maxsize=None)
def load_kernels(name: str = "fused_cg") -> Kernels:
    """Build (if needed) and load the library of ``csrc/<name>.cu``; cached
    per process."""
    if name not in ENTRIES:
        raise ValueError(f"unknown kernel library {name!r}")
    build([name])
    out = _target(name)
    lib = ctypes.CDLL(str(out))
    _bind(name, lib)
    seconds, log = _BUILD_LOGS.get(name, (0.0, ""))
    return Kernels(name=name, lib=lib, path=out, build_seconds=seconds,
                   log=log)


def load_all() -> dict:
    """Every library, the missing ones built in parallel."""
    build(ENTRIES)
    return {name: load_kernels(name) for name in ENTRIES}


def check(kernels: Kernels, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        err = getattr(kernels.lib, f"{kernels.name}_error_string")(code)
        raise RuntimeError(f"{what}: CUDA error {code} ({err.decode()})")
