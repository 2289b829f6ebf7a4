"""mesh_sum_us_per_iter (us; layer: mesh): host µs inside the program's
``mesh.sum`` ranges (the sums in mesh order, ``parallel.halo.mesh_sum`` and
``mesh_sums``) and ``mesh.replicate`` ranges (a scalar copied to every
shard's device), clipped to the traced slice, over the iterations its
solves returned. The two never nest. Nothing where no such range falls in
the slice: a program without the ranges, or a cell with no mesh."""

from __future__ import annotations

RANGES = ("mesh.sum", "mesh.replicate")


def _inside_us(cap, names):
    """µs of the host ranges named ``names`` inside the slice, or None
    where none overlaps it."""
    parts = [min(e.end_us, cap.end_us) - max(e.start_us, cap.start_us)
             for e in cap.events if e.kind == "host" and e.name in names]
    parts = [p for p in parts if p > 0]
    return sum(parts) if parts else None


def read(cap):
    us = _inside_us(cap, RANGES)
    if us is None or cap.iterations <= 0:
        return None
    return us / cap.iterations
