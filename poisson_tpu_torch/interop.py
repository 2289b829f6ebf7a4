"""Carry the JAX package's state across to the port, as plain data.

The port never imports the JAX package; a caller that holds both (the
parity tests) hands over plain fields and numpy arrays, so that both
packages run on the very same inputs: single-device canvases, the
stacked shard canvases of the sharded solves, a batched solver state
(a lane table carried across mid-flight), a multigrid level hierarchy
(one V-cycle of each package under the same levels), or a geometry spec
(by its canonical JSON, fingerprint kept; geometry canvases are host
numpy in both packages and need no converter).
"""

from __future__ import annotations

import numpy as np
import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops.fused_cg import (
    HALO,
    LANE,
    TILE_COLS,
    TILE_ROWS,
    Canvas,
)
from poisson_tpu_torch.utils.platform import resolve_device


def problem_from_reference(fields: dict) -> Problem:
    """A port ``Problem`` from a JAX ``Problem``'s fields
    (``dataclasses.asdict`` of it)."""
    return Problem(**fields)


def canvases_from_reference(cv_fields: dict, cs, cw, g, rhs, sc2, sc_int,
                            device=None):
    """The port's (cv, cS, cW, g, rhs, sc2, sc_int) from the arrays of
    ``poisson_tpu.ops.pallas_cg.build_canvases``.

    ``cv_fields`` is the JAX ``Canvas._asdict()``: full width, or column
    blocked (``cg`` guard columns, ``ncb`` blocks of ``bn`` columns), which
    the port's kernels A′ and B′ take. Arrays may be JAX arrays or numpy;
    they are copied as fp32 tensors to ``device`` (default ``cuda``)."""
    cv = Canvas(**{f: cv_fields[f] for f in Canvas._fields if f in cv_fields})
    blocked_ok = cv.cols == 2 * cv.cg + cv.ncb * cv.bn and not (
        cv.bm % TILE_ROWS or cv.bn % TILE_COLS)
    if (cv.cols % LANE or (cv.rows - 2 * HALO) % 8
            or cv.rows != cv.nb * cv.bm + 2 * HALO
            or (cv.cg and (cv.cg != LANE or not blocked_ok))):
        raise ValueError(f"canvas geometry {cv} is not the port's layout")
    dev = resolve_device(device)
    tensors = [torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
               for x in (cs, cw, g, rhs, sc2, sc_int)]
    for t in tensors[:-1]:
        if tuple(t.shape) != (cv.rows, cv.cols):
            raise ValueError(f"canvas shape {tuple(t.shape)} does not match "
                             f"{(cv.rows, cv.cols)}")
    return (cv, *tensors)


def shard_canvases_from_reference(cs, cw, g, rhs, sc2, sc_int, colmask,
                                  devices):
    """The port's per-shard canvases (a ``ShardCanvases``) from the stacked
    arrays of ``poisson_tpu.parallel.pallas_sharded._shard_canvases`` or
    ``pallas_ca_sharded._ca_shard_canvases``: shard s of each (P, R, C) or
    (P, m̂, n̂) array, as an fp32 tensor on ``devices[s]``, and the (1, C)
    column mask on every shard's device. Arrays may be JAX arrays or
    numpy."""
    from poisson_tpu_torch.parallel.fused_sharded import to_shards

    arrays = dict(cs=cs, cw=cw, g=g, rhs=rhs, sc2=sc2, sc_int=sc_int,
                  colmask=colmask)
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    shards = arrays["cs"].shape[0]
    if len(devices) != shards or any(
            arrays[k].shape[0] != shards
            for k in ("cw", "g", "rhs", "sc2", "sc_int")):
        raise ValueError(f"{len(devices)} devices for stacked arrays of "
                         f"{shards} shards")
    if arrays["colmask"].shape != (1, arrays["cs"].shape[2]):
        raise ValueError(f"colmask has shape {arrays['colmask'].shape}")
    return to_shards(arrays, [resolve_device(d) for d in devices])


def batched_state_from_reference(fields: dict, device=None):
    """The port's batched ``PCGState`` from a JAX batched ``PCGState``
    (``state._asdict()``, arrays numpy or JAX): fields (B, M+1, N+1) as
    they are, member scalars (B,) as (B, 1, 1), in the same dtypes, on
    ``device`` (default ``cuda``). A ``LaneBatch`` or a batched loop of
    either package continues from it."""
    from poisson_tpu_torch.solvers.pcg import PCGState

    dev = resolve_device(device)
    out = {}
    for name in PCGState._fields:
        arr = np.asarray(fields[name])
        t = torch.from_numpy(np.array(arr)).to(dev)
        out[name] = t.reshape(-1, 1, 1) if arr.ndim == 1 else t
    return PCGState(**out)


def batched_state_to_reference(state) -> dict:
    """A port batched ``PCGState`` as the JAX package holds it: numpy
    arrays, member scalars as (B,) vectors (``PCGState(**d)`` of the JAX
    package rebuilds it)."""
    out = {}
    for name, t in zip(state._fields, state):
        arr = t.detach().cpu().numpy()
        out[name] = arr.reshape(-1) if arr.ndim == 3 and arr.shape[1:] == (
            1, 1) else arr
    return out


def mg_levels_from_reference(levels, coarse_inv=None, scinv=None,
                             device=None):
    """The port's ``mg.MGLevels`` from a JAX ``MGLevels`` as arrays
    (``levels``: one (a, b, dinv) triple per level, finest first; then
    ``coarse_inv`` and ``scinv``, each None where the JAX one is), numpy
    or JAX, in their own dtypes, on ``device`` (default ``cuda``): the
    very hierarchy the JAX V-cycle runs, under the port's."""
    from poisson_tpu_torch.mg.hierarchy import MGLevels

    dev = resolve_device(device)
    cast = lambda x: None if x is None else torch.from_numpy(
        np.array(x)).to(dev)
    return MGLevels(levels=tuple(tuple(cast(x) for x in level)
                                 for level in levels),
                    coarse_inv=cast(coarse_inv), scinv=cast(scinv))


def spec_from_reference(spec):
    """The port's geometry spec from a JAX ``GeometrySpec``: parsed from
    its canonical JSON, so the fingerprint is the same. A raw ``SDF``
    (no JSON form) crosses as its callable and name."""
    from poisson_tpu_torch.geometry.dsl import SDF, parse_geometry

    if type(spec).__name__ == "SDF":
        return SDF(spec.fn, name=spec.name)
    return parse_geometry(spec.to_json())


def spec_to_reference(spec) -> str:
    """A port spec as the canonical JSON the JAX package's
    ``parse_geometry`` reads to the same fingerprint. ``SDF`` specs have
    no JSON form (in either package) and raise."""
    from poisson_tpu_torch.geometry.dsl import parse_geometry

    text = spec.to_json()
    parse_geometry(text)        # raises for a spec holding a callable
    return text
