"""Geometry as data: the shape DSL, the canvas compiler and its cache, and
the manufactured-solution gate (counterpart of ``poisson_tpu/geometry``).

- the spec algebra (:mod:`geometry.dsl`): :class:`Ellipse`,
  :class:`Rectangle`, :class:`Polygon`, :class:`Union`,
  :class:`Intersection`, :class:`Difference`, :class:`SDF`,
  :data:`DEFAULT_ELLIPSE`, :func:`parse_geometry`, :func:`fingerprint_of`;
- the canvas compiler and cache (:mod:`geometry.canvas`):
  :func:`geometry_setup` (device canvases, ``geom.cache.{hits,misses}``
  keyed by fingerprint), :func:`build_geometry_fields` (host fp64),
  :func:`render_ascii`, :func:`reset_geometry_cache`;
- the accuracy gate (:mod:`geometry.manufactured`): one manufactured
  solution per family, held to the L2 floor the ellipse is held to.

``geometry=`` reaches ``pcg_solve`` (with ``preconditioner="mg"`` too),
``pcg_solve_chunked``, ``solve_batched(geometries=)``,
``LaneBatch(multi_geometry=True)`` and the CLI; ``solvers.adjoint`` takes
shape gradients of the closed-form families.
"""

from poisson_tpu_torch.geometry.canvas import (
    build_geometry_fields,
    cut_face_mask,
    geometry_face_lengths,
    geometry_setup,
    render_ascii,
    reset_geometry_cache,
)
from poisson_tpu_torch.geometry.dsl import (
    DEFAULT_ELLIPSE,
    Difference,
    Ellipse,
    GeometrySpec,
    Intersection,
    Polygon,
    Rectangle,
    SDF,
    Union,
    fingerprint_of,
    parse_geometry,
)

__all__ = [
    "GeometrySpec", "Ellipse", "Rectangle", "Polygon", "Union",
    "Intersection", "Difference", "SDF", "DEFAULT_ELLIPSE",
    "parse_geometry", "fingerprint_of", "geometry_setup",
    "build_geometry_fields", "cut_face_mask", "geometry_face_lengths",
    "render_ascii", "reset_geometry_cache",
]
