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
kernel for CUDA tensors, counted in ``serial_sum.launches``, and runs the
plain version for CPU tensors, and only for them.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from poisson_tpu_torch.ops._build import check, load_kernels

WARP = 32
THREADS = 1024   # kernel S's block: 32 warps tree-sum 32 runs at once


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
    kernels = _kernels()
    nvec, n = x.shape
    out = torch.empty(nvec, dtype=torch.float32, device=x.device)
    ll = ctypes.c_longlong
    code = kernels.lib.serial_sum_launch(
        x.data_ptr(), out.data_ptr(), ll(n), ll(x.stride(1)),
        ll(x.stride(0)), ll(run), nvec, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(kernels, code, "serial_sum launch")
    serial_sum.launches += 1
    return out[0] if single else out


serial_sum.launches = 0


def reset_launch_counts() -> None:
    serial_sum.launches = 0


def launch_counts() -> dict:
    return {"serial_sum": serial_sum.launches}
