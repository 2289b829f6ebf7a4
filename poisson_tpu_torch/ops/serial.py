"""The serial-reduce mode: kernel S, an ordered and compensated sum of
reduction partials, in CUDA for Hopper (counterpart of the ``serial=True``
variant of every Pallas kernel of the JAX package).

On the TPU the serial variant keeps one (1, 1) SMEM cell per sum and adds
each grid step's partial to it with Kahan compensation
(``poisson_tpu/ops/pallas_cg.py:94-109, 464-478``), in the grid's order.
The port keeps its field kernels as they are, one partial per CUDA block,
and sums those partials with kernel S (``csrc/serial_sum.cu``):

- the partials of one sum are cut, in canvas order, into consecutive runs
  of ``run`` partials, one run per TPU grid step (a strip, or on the
  column-blocked canvas a (strip, column block) tile);
- each run is tree-summed: lane l of a 32-lane warp adds partials
  l, l + 32, … in order, then the shuffle tree combines the lanes;
- the run sums are added in order with Kahan compensation, as
  ``_kahan_add`` does.

:func:`serial_sum_plain` repeats that order with tensor operations, so the
kernel and the plain version agree bit for bit. The wrapper launches the
kernel for CUDA tensors (``ops.launch``, which counts it), and runs the
plain version for CPU tensors, and only for them.

How the partials reach the adds is the kernel's own design, and
:func:`serial_plan` is its launch geometry (the kernel computes the same,
from the same constants, which this module reads from the kernel's
source): a block stages its runs of every vector into shared memory in
one pass of 16-byte ``cp.async`` copies, then deals the lanes' chains to
its threads; a launch is one cluster of 1 to 16 blocks, which hand their
run sums to block 0 through distributed shared memory.
``tests/test_torch_layout.py`` replays that layout in numpy against
:func:`serial_sum_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple

import torch
import torch.nn.functional as F

from poisson_tpu_torch.ops._build import load_kernels, source
from poisson_tpu_torch.ops.launch import launch


def _kernel_constants() -> dict:
    """The integer constants of ``csrc/serial_sum.cu``, by name without
    the ``k``: its shared-memory budget and block rule, written there
    once."""
    text = source("serial_sum").read_text()
    return {m[1]: int(m[2]) for m in re.finditer(
        r"^constexpr (?:int|long long) k(\w+) = (\d+);", text, re.M)}


_K = _kernel_constants()
WARP = _K["Warp"]
THREADS = _K["Threads"]   # the most threads a block of kernel S runs
# The kernel's shared memory, in floats: the stage, the run sums of a
# launch, the lane sums of the interleaved layout.
STAGE_FLOATS, SUM_FLOATS, LANE_FLOATS = (
    _K["StageFloats"], _K["SumFloats"], _K["LaneFloats"])
# Its block rule: one block up to SINGLE_FLOATS partials (all vectors), else
# a cluster of a block per BLOCK_FLOATS, at most MAX_CLUSTER; threads per
# block THREADS_CONTIGUOUS, or THREADS_INTERLEAVED on kernel C's Gram
# buffer.
SINGLE_FLOATS, BLOCK_FLOATS, MAX_CLUSTER = (
    _K["SingleFloats"], _K["BlockFloats"], _K["MaxCluster"])
THREADS_CONTIGUOUS, THREADS_INTERLEAVED = (
    _K["ThreadsContiguous"], _K["ThreadsInterleaved"])


class SerialPlan(NamedTuple):
    """Kernel S's launch geometry for one launch (``make_plan`` in
    ``csrc/serial_sum.cu``, field for field)."""

    runs: int        # runs per vector
    rpb: int         # runs per block
    blocks: int      # the cluster's size
    piece_runs: int  # whole runs per stage, or 0 when a run is sliced
    slice: int       # partials per slice of one run, or 0
    group: int       # vectors one warp walks at once
    threads: int     # threads per block
    stage: int       # floats of the stage region
    lanes: int       # floats of the lane-sum region
    smem_bytes: int


def stage_floats(length: int, nv: int, interleaved: bool) -> int:
    """Stage floats for ``length`` partials of each of ``nv`` vectors: one
    16-byte aligned row per contiguous vector, with room for its segment's
    shift of up to 3 floats, or one interleaved segment."""
    if interleaved:
        return -(-(nv * length + 3) // 4) * 4
    return nv * (-(-(length + 3) // 4) * 4)


def warp_group(nv: int) -> int:
    """gcd(nv, 32): on the interleaved layout a warp walks 32/g lanes of g
    vectors, which read 32 different banks."""
    g = 1
    while g < WARP and nv % (2 * g) == 0:
        g *= 2
    return g


def serial_plan(n: int, nv: int, run: int,
                interleaved: bool = False) -> SerialPlan:
    """The launch geometry kernel S uses for ``nv`` vectors of ``n``
    partials in runs of ``run``, contiguous or ``interleaved`` (the
    columns of one row-major buffer). Raises ValueError where the kernel
    would refuse the launch."""
    runs = -(-n // run) if n >= 1 and run >= 1 else 0
    if runs < 1 or not 1 <= nv <= WARP:
        raise ValueError(f"kernel S: n={n}, vectors={nv}, run={run}")
    if nv * runs > SUM_FLOATS:
        raise ValueError(f"kernel S: {nv} vectors x {runs} runs exceed the "
                         f"{SUM_FLOATS} run sums one launch holds")
    group = warp_group(nv) if interleaved else 1
    wanted = 1 if nv * n <= SINGLE_FLOATS else -(-nv * n // BLOCK_FLOATS)
    rpb = -(-runs // min(wanted, MAX_CLUSTER))
    blocks = -(-runs // rpb)
    per_run = nv * WARP if interleaved else 0
    piece_runs = slice_ = 0
    if (stage_floats(run, nv, interleaved) <= STAGE_FLOATS
            and per_run <= LANE_FLOATS):
        piece_runs = rpb
        while piece_runs > 1 and (
                stage_floats(piece_runs * run, nv, interleaved) > STAGE_FLOATS
                or piece_runs * per_run > LANE_FLOATS):
            piece_runs -= 1
    else:
        slice_ = (STAGE_FLOATS // nv - 8) // WARP * WARP
        while stage_floats(slice_, nv, interleaved) > STAGE_FLOATS:
            slice_ -= WARP
    stage = stage_floats(slice_ or min(piece_runs * run, n), nv, interleaved)
    threads = THREADS_INTERLEAVED if interleaved else THREADS_CONTIGUOUS
    if slice_:
        threads = max(threads, nv * WARP)
    lanes = per_run * max(piece_runs, 1)
    return SerialPlan(runs, rpb, blocks, piece_runs, slice_, group, threads,
                      stage, lanes, (stage + nv * runs + lanes) * 4)


def kernel_layout(x: torch.Tensor):
    """``x`` (nvec, n) in a layout kernel S reads, and whether it is
    interleaved: contiguous vectors (element stride 1), or the columns of
    one row-major buffer (element stride nvec, vector stride 1; kernel C's
    Gram partials); any other is copied contiguous first."""
    nvec = x.shape[0]
    if x.stride(1) == 1 or x.shape[1] == 1:
        return x, False
    if nvec > 1 and x.stride(0) == 1 and x.stride(1) == nvec:
        return x, True
    return x.contiguous(), False


def _as_vectors(parts):
    """``parts`` as an (nvec, n) fp32 view, and whether it was one vector.

    ``parts`` is one vector (n,), an (nvec, n) tensor (any strides: kernel
    C's (tiles, 12) partials transposed), or a sequence of equal-length
    vectors, which are viewed in place when they are evenly spaced rows of
    one buffer (kernel B's two partial vectors) and stacked otherwise."""
    if isinstance(parts, torch.Tensor):
        if parts.dim() == 1:
            return parts.unsqueeze(0), True
        if parts.dim() == 2:
            return parts, False
        raise ValueError(f"partials must be 1-D or 2-D, got {parts.dim()}-D")
    parts = list(parts)
    first = parts[0]
    n = first.numel()
    if any(v.dim() != 1 or v.numel() != n or v.dtype != first.dtype
           or v.device != first.device for v in parts):
        raise ValueError("partials vectors must be 1-D, of one length, type "
                         "and device")
    rows_of_one_buffer = all(
        v.is_contiguous()
        and v.untyped_storage().data_ptr()
        == first.untyped_storage().data_ptr()
        and v.storage_offset() == first.storage_offset() + i * n
        for i, v in enumerate(parts))
    if rows_of_one_buffer:
        return first.as_strided((len(parts), n), (n, 1)), False
    return torch.stack(parts), False


def serial_sum_plain(parts, run: int) -> torch.Tensor:
    """Kernel S's plain version: the sum of each vector of ``parts``, its
    partials cut into runs of ``run``, each run tree-summed in the warp's
    order and the run sums added in order with Kahan compensation. Returns a
    0-d tensor for one vector, else a (nvec,) tensor."""
    x, single = _as_vectors(parts)
    x = x.to(torch.float32)
    nvec, n = x.shape
    runs = -(-n // run)
    padded = -(-run // WARP) * WARP
    # (nvec, runs, padded): each run zero-padded to whole warp rows; +0.0
    # leaves a lane's sum unchanged (it is never -0).
    cut = F.pad(x, (0, runs * run - n)).reshape(nvec, runs, run)
    lanes = F.pad(cut, (0, padded - run)).reshape(nvec, runs, -1, WARP)
    acc = torch.zeros((nvec, runs, WARP), dtype=torch.float32,
                      device=x.device)
    for k in range(lanes.shape[2]):
        acc = acc + lanes[:, :, k, :]
    off = WARP // 2
    while off:
        acc = torch.cat([acc[..., :off] + acc[..., off : 2 * off],
                         acc[..., off:]], dim=-1)
        off //= 2
    run_sums = acc[..., 0]
    total = torch.zeros(nvec, dtype=torch.float32, device=x.device)
    comp = torch.zeros_like(total)
    for q in range(runs):
        y = run_sums[:, q] - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return total[0] if single else total


@functools.lru_cache(maxsize=None)
def _kernels():
    """The built library, checked to use this module's block size."""
    kernels = load_kernels("serial_sum")
    if kernels.lib.serial_sum_threads() != THREADS:
        raise RuntimeError(f"{kernels.path.name} runs "
                           f"{kernels.lib.serial_sum_threads()} threads per "
                           f"block; this module expects {THREADS}")
    return kernels


def serial_sum(parts, run: int) -> torch.Tensor:
    """Kernel S: the ordered, compensated sum of each vector of ``parts``
    (see :func:`_as_vectors` for the forms taken), in runs of ``run``
    partials. One launch for all the vectors; a 0-d tensor for one vector,
    else (nvec,)."""
    x, single = _as_vectors(parts)
    if x.dtype != torch.float32:
        raise ValueError(f"partials must be float32, got {x.dtype}")
    if run < 1:
        raise ValueError(f"run must be >= 1, got {run}")
    if x.device.type == "cpu":
        return serial_sum_plain(x[0] if single else x, run)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x, interleaved = kernel_layout(x)
    nvec, n = x.shape
    serial_plan(n, nvec, run, interleaved)   # raises where the kernel would
    out = torch.empty(nvec, dtype=torch.float32, device=x.device)
    ll = ctypes.c_longlong
    strides = (nvec, 1) if interleaved else (1, x.stride(0))
    launch(_kernels(), "serial_sum_launch", "serial_sum", x.device,
           x.data_ptr(), out.data_ptr(), ll(n), ll(strides[0]),
           ll(strides[1]), ll(run), nvec)
    return out[0] if single else out


