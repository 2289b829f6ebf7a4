"""Geometry DSL: the domain as a request parameter (counterpart of
``poisson_tpu/geometry/dsl.py``, of which this is the port's own copy).

The fictitious-domain method sees the domain only through the blend
canvases ``a``, ``b`` and the RHS indicator. This module makes the domain
a value, a small spec algebra

    Ellipse(cx, cy, rx, ry)        — axis-aligned ellipse
    Rectangle(x0, y0, x1, y1)      — open axis-aligned box
    Polygon(vertices)              — simple polygon
    Union(shapes) / Intersection(shapes) / Difference(shape, hole)
    SDF(fn, name=…)                — raw signed-distance(-like) callable

each of which has

    contains(x, y, xp) — exact membership of the open set (the RHS
                         indicator and the error mask)
    sdf(x, y, xp)      — a continuous level set, negative inside, zero on
                         the boundary (the face sampler of
                         ``geometry.canvas`` bisects it)
    normalize()        — the canonical form: boolean children flattened
                         and sorted by fingerprint, polygons started at
                         their smallest vertex and counter-clockwise,
                         rectangle corners ordered
    fingerprint        — a hash of the canonical JSON: the key of the
                         canvas cache and of the MG hierarchy cache

``xp`` is ``numpy`` (the default) or ``torch``: the closed-form families
take tensors with ``requires_grad`` and stay differentiable, which the
shape gradients of ``solvers.adjoint`` need. ``Ellipse`` and ``Rectangle``
validate only plain numbers, so tensor parameters pass.

The canonical JSON and the fingerprint are the JAX package's byte for
byte: a spec written by either package parses in the other to the same
fingerprint (``interop.spec_from_reference``). ``SDF`` specs serialise
their ``name`` but cannot be parsed back (a callable does not survive
JSON).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Optional, Tuple

__all__ = [
    "GeometrySpec", "Ellipse", "Rectangle", "Polygon", "Union",
    "Intersection", "Difference", "SDF", "DEFAULT_ELLIPSE",
    "parse_geometry", "fingerprint_of",
]


class _TorchNS:
    """The numpy calls the specs make, on tensors: scalars are lifted to
    the tensor operand's dtype and device, and the square root is the
    correctly rounded one (``fictitious_domain.sqrt_rn``; torch's CPU fp32
    ``sqrt`` is not), which keeps autograd."""

    def __init__(self):
        import torch

        self.t = torch

    def _lift(self, a, b):
        t = self.t
        ref = a if isinstance(a, t.Tensor) else b
        if not isinstance(a, t.Tensor):
            a = t.as_tensor(a, dtype=ref.dtype, device=ref.device)
        if not isinstance(b, t.Tensor):
            b = t.as_tensor(b, dtype=ref.dtype, device=ref.device)
        return a, b

    def asarray(self, x, dtype=None):
        return self.t.as_tensor(x, dtype=self.t.float64)

    def roll(self, x, shift, axis):
        return self.t.roll(x, shift, dims=axis)

    def broadcast_arrays(self, *xs):
        return self.t.broadcast_tensors(*xs)

    def clip(self, x, lo, hi):
        return self.t.clamp(x, lo, hi)

    def sqrt(self, x):
        from poisson_tpu_torch.models.fictitious_domain import sqrt_rn

        return sqrt_rn(x)

    def abs(self, x):
        return self.t.abs(x)

    def amin(self, x, axis):
        return self.t.amin(x, dim=axis)

    def maximum(self, a, b):
        return self.t.maximum(*self._lift(a, b))

    def minimum(self, a, b):
        return self.t.minimum(*self._lift(a, b))

    def where(self, c, a, b):
        if not isinstance(a, self.t.Tensor) and \
                not isinstance(b, self.t.Tensor):
            a = self.t.as_tensor(a, dtype=self.t.float64, device=c.device)
        a, b = self._lift(a, b)
        return self.t.where(c, a, b)

    def zeros_like(self, x):
        return self.t.zeros_like(x)


_TORCH_NS = None


def _ns(xp):
    """The array namespace for ``xp``: numpy for None or numpy, the tensor
    adapter for ``torch``."""
    global _TORCH_NS
    if xp is None:
        import numpy as np

        return np
    if getattr(xp, "__name__", None) == "torch":
        if _TORCH_NS is None:
            _TORCH_NS = _TorchNS()
        return _TORCH_NS
    return xp


def _canon_float(v) -> float:
    """Canonical float for fingerprints: plain ``float()`` so ints,
    numpy scalars and floats that compare equal hash equal."""
    return float(v)


def _is_number(v) -> bool:
    return isinstance(v, (int, float))


class GeometrySpec:
    """Base of the spec algebra. Subclasses are frozen dataclasses:
    hashable values, safe as dict keys."""

    def contains(self, x, y, xp=None):
        """Exact open-set membership, elementwise over broadcast x, y."""
        return self.sdf(x, y, xp) < 0.0

    def sdf(self, x, y, xp=None):
        raise NotImplementedError

    def normalize(self) -> "GeometrySpec":
        return self

    def to_obj(self) -> dict:
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps(self.normalize().to_obj(), sort_keys=True)

    @property
    def fingerprint(self) -> str:
        """``"g"`` and the first 16 hex digits of the sha256 of the
        canonical JSON: equivalent specs (permuted unions, rotated
        polygon rings) share it. Memoized on the (frozen) instance."""
        fp = self.__dict__.get("_fp")
        if fp is None:
            digest = hashlib.sha256(self.to_json().encode()).hexdigest()
            fp = f"g{digest[:16]}"
            object.__setattr__(self, "_fp", fp)
        return fp

    def __str__(self) -> str:
        return self.to_json()


@dataclasses.dataclass(frozen=True)
class Ellipse(GeometrySpec):
    """Axis-aligned ellipse ((x−cx)/rx)² + ((y−cy)/ry)² < 1. The defaults
    are the reference's domain x² + 4y² < 1."""

    cx: float = 0.0
    cy: float = 0.0
    rx: float = 1.0
    ry: float = 0.5

    def __post_init__(self):
        # Plain radii are checked; tensor ones (the shape gradient's)
        # pass, as JAX's tracers do.
        if _is_number(self.rx) and _is_number(self.ry) and \
                not (self.rx > 0 and self.ry > 0):
            raise ValueError(f"ellipse radii must be > 0, got "
                             f"rx={self.rx} ry={self.ry}")

    def contains(self, x, y, xp=None):
        tx = (x - self.cx) / self.rx
        ty = (y - self.cy) / self.ry
        return tx * tx + ty * ty < 1.0

    def sdf(self, x, y, xp=None):
        # An implicit level set, not a true distance: continuous, negative
        # inside, zero on the boundary, which is all the sampler needs.
        tx = (x - self.cx) / self.rx
        ty = (y - self.cy) / self.ry
        return tx * tx + ty * ty - 1.0

    def normalize(self) -> "Ellipse":
        return Ellipse(_canon_float(self.cx), _canon_float(self.cy),
                       _canon_float(self.rx), _canon_float(self.ry))

    def to_obj(self) -> dict:
        return {"type": "ellipse", "cx": self.cx, "cy": self.cy,
                "rx": self.rx, "ry": self.ry}


DEFAULT_ELLIPSE = Ellipse()
"""The reference's fictitious domain, as a spec."""


@dataclasses.dataclass(frozen=True)
class Rectangle(GeometrySpec):
    """Open axis-aligned box (x0, x1) × (y0, y1)."""

    x0: float
    y0: float
    x1: float
    y1: float

    def __post_init__(self):
        if all(_is_number(v) for v in (self.x0, self.y0, self.x1,
                                       self.y1)) and \
                not (self.x1 > self.x0 and self.y1 > self.y0):
            raise ValueError(
                f"rectangle needs x1 > x0 and y1 > y0, got "
                f"({self.x0},{self.y0})..({self.x1},{self.y1})")

    def contains(self, x, y, xp=None):
        return (x > self.x0) & (x < self.x1) & (y > self.y0) & (y < self.y1)

    def sdf(self, x, y, xp=None):
        xp = _ns(xp)
        cx, cy = 0.5 * (self.x0 + self.x1), 0.5 * (self.y0 + self.y1)
        hx, hy = 0.5 * (self.x1 - self.x0), 0.5 * (self.y1 - self.y0)
        return xp.maximum(xp.abs(x - cx) - hx, xp.abs(y - cy) - hy)

    def normalize(self) -> "Rectangle":
        x0, x1 = sorted((_canon_float(self.x0), _canon_float(self.x1)))
        y0, y1 = sorted((_canon_float(self.y0), _canon_float(self.y1)))
        return Rectangle(x0, y0, x1, y1)

    def to_obj(self) -> dict:
        return {"type": "rect", "x0": self.x0, "y0": self.y0,
                "x1": self.x1, "y1": self.y1}


@dataclasses.dataclass(frozen=True)
class Polygon(GeometrySpec):
    """Simple polygon (no self-intersections assumed), vertices a tuple of
    (x, y) pairs. Membership is even-odd ray crossing; the level set is
    the distance to the nearest edge with the membership sign."""

    vertices: Tuple[Tuple[float, float], ...]

    def __post_init__(self):
        verts = tuple((float(x), float(y)) for x, y in self.vertices)
        if len(verts) < 3:
            raise ValueError(f"polygon needs >= 3 vertices, got "
                             f"{len(verts)}")
        object.__setattr__(self, "vertices", verts)

    def _edges(self, xp):
        v = xp.asarray(self.vertices, dtype=float)
        return v, xp.roll(v, -1, axis=0)

    def contains(self, x, y, xp=None):
        xp = _ns(xp)
        x = xp.asarray(x, dtype=float)
        y = xp.asarray(y, dtype=float)
        px, py = xp.broadcast_arrays(x, y)
        a, b = self._edges(xp)
        # Even-odd crossing count of a +x ray, points × edges.
        ax, ay = a[:, 0], a[:, 1]
        bx, by = b[:, 0], b[:, 1]
        P = px[..., None]
        Q = py[..., None]
        straddles = (ay <= Q) != (by <= Q)
        # x where the edge crosses the line y = Q (guarded; masked below).
        t = (Q - ay) / (by - ay + (ay == by))
        cross_x = ax + t * (bx - ax)
        hits = straddles & (P < cross_x)
        return (hits.sum(axis=-1) % 2) == 1

    def sdf(self, x, y, xp=None):
        xp = _ns(xp)
        x = xp.asarray(x, dtype=float)
        y = xp.asarray(y, dtype=float)
        px, py = xp.broadcast_arrays(x, y)
        a, b = self._edges(xp)
        ax, ay = a[:, 0], a[:, 1]
        bx, by = b[:, 0], b[:, 1]
        ex, ey = bx - ax, by - ay
        ee = ex * ex + ey * ey
        P = px[..., None] - ax
        Q = py[..., None] - ay
        t = xp.clip((P * ex + Q * ey) / ee, 0.0, 1.0)
        dx = P - t * ex
        dy = Q - t * ey
        d = xp.sqrt(xp.amin(dx * dx + dy * dy, axis=-1))
        return xp.where(self.contains(px, py, xp), -d, d)

    def normalize(self) -> "Polygon":
        verts = [(_canon_float(x), _canon_float(y))
                 for x, y in self.vertices]
        # Counter-clockwise (positive signed area).
        area2 = sum(x0 * y1 - x1 * y0
                    for (x0, y0), (x1, y1)
                    in zip(verts, verts[1:] + verts[:1]))
        if area2 < 0:
            verts = verts[::-1]
        # Start at the lexicographically smallest vertex.
        k = min(range(len(verts)), key=lambda i: verts[i])
        verts = verts[k:] + verts[:k]
        return Polygon(tuple(verts))

    def to_obj(self) -> dict:
        return {"type": "polygon",
                "vertices": [[x, y] for x, y in self.vertices]}


def _norm_children(shapes, flatten_type) -> tuple:
    """Normalize boolean children: recurse, flatten same-type nests,
    dedupe and sort by fingerprint, so permuted unions hash equal."""
    flat = []
    for s in shapes:
        n = s.normalize()
        if isinstance(n, flatten_type):
            flat.extend(n.shapes)
        else:
            flat.append(n)
    seen, out = set(), []
    for s in flat:
        fp = s.fingerprint
        if fp not in seen:
            seen.add(fp)
            out.append(s)
    return tuple(sorted(out, key=lambda s: s.fingerprint))


@dataclasses.dataclass(frozen=True)
class Union(GeometrySpec):
    shapes: Tuple[GeometrySpec, ...]

    def __post_init__(self):
        object.__setattr__(self, "shapes", tuple(self.shapes))
        if len(self.shapes) < 1:
            raise ValueError("union needs at least one shape")

    def contains(self, x, y, xp=None):
        out = self.shapes[0].contains(x, y, xp)
        for s in self.shapes[1:]:
            out = out | s.contains(x, y, xp)
        return out

    def sdf(self, x, y, xp=None):
        ns = _ns(xp)
        out = self.shapes[0].sdf(x, y, xp)
        for s in self.shapes[1:]:
            out = ns.minimum(out, s.sdf(x, y, xp))
        return out

    def normalize(self) -> GeometrySpec:
        children = _norm_children(self.shapes, Union)
        return children[0] if len(children) == 1 else Union(children)

    def to_obj(self) -> dict:
        return {"type": "union",
                "shapes": [s.to_obj() for s in self.shapes]}


@dataclasses.dataclass(frozen=True)
class Intersection(GeometrySpec):
    shapes: Tuple[GeometrySpec, ...]

    def __post_init__(self):
        object.__setattr__(self, "shapes", tuple(self.shapes))
        if len(self.shapes) < 1:
            raise ValueError("intersection needs at least one shape")

    def contains(self, x, y, xp=None):
        out = self.shapes[0].contains(x, y, xp)
        for s in self.shapes[1:]:
            out = out & s.contains(x, y, xp)
        return out

    def sdf(self, x, y, xp=None):
        ns = _ns(xp)
        out = self.shapes[0].sdf(x, y, xp)
        for s in self.shapes[1:]:
            out = ns.maximum(out, s.sdf(x, y, xp))
        return out

    def normalize(self) -> GeometrySpec:
        children = _norm_children(self.shapes, Intersection)
        return (children[0] if len(children) == 1
                else Intersection(children))

    def to_obj(self) -> dict:
        return {"type": "intersection",
                "shapes": [s.to_obj() for s in self.shapes]}


@dataclasses.dataclass(frozen=True)
class Difference(GeometrySpec):
    """``shape`` minus (the closure of) ``hole``."""

    shape: GeometrySpec
    hole: GeometrySpec

    def contains(self, x, y, xp=None):
        return self.shape.contains(x, y, xp) & ~self.hole.contains(x, y, xp)

    def sdf(self, x, y, xp=None):
        return _ns(xp).maximum(self.shape.sdf(x, y, xp),
                               -self.hole.sdf(x, y, xp))

    def normalize(self) -> "Difference":
        return Difference(self.shape.normalize(), self.hole.normalize())

    def to_obj(self) -> dict:
        return {"type": "difference", "shape": self.shape.to_obj(),
                "hole": self.hole.to_obj()}


@dataclasses.dataclass(frozen=True)
class SDF(GeometrySpec):
    """Raw level-set callable ``fn(x, y) -> array`` (negative inside,
    continuous, zero on the boundary). ``name`` is mandatory and is the
    fingerprint's identity: a callable has no stable content hash, so two
    SDFs of one name are one geometry, cache included. Not parseable from
    JSON: in-process requests only."""

    fn: Callable = dataclasses.field(compare=False, hash=False)
    name: str = ""

    def __post_init__(self):
        if not self.name:
            raise ValueError(
                "SDF specs need a name=: the fingerprint (canvas-cache "
                "and co-batching key) cannot hash a callable")

    def contains(self, x, y, xp=None):
        return self.fn(x, y) < 0.0

    def sdf(self, x, y, xp=None):
        return self.fn(x, y)

    def to_obj(self) -> dict:
        return {"type": "sdf", "name": self.name}


def _parse_ellipse(o):
    return Ellipse(o.get("cx", 0.0), o.get("cy", 0.0),
                   o.get("rx", 1.0), o.get("ry", 0.5))


def _parse_rect(o):
    return Rectangle(o["x0"], o["y0"], o["x1"], o["y1"])


def _parse_polygon(o):
    verts = []
    for v in o["vertices"]:
        if not isinstance(v, (list, tuple)) or len(v) != 2:
            raise ValueError(
                f"polygon vertices must be [x, y] pairs, got {v!r}")
        verts.append((v[0], v[1]))
    return Polygon(tuple(verts))


def _parse_union(o):
    return Union(tuple(_parse_obj(s) for s in o["shapes"]))


def _parse_intersection(o):
    return Intersection(tuple(_parse_obj(s) for s in o["shapes"]))


def _parse_difference(o):
    return Difference(_parse_obj(o["shape"]), _parse_obj(o["hole"]))


def _parse_sdf(o):
    raise ValueError(
        "SDF specs carry a Python callable and cannot be parsed from "
        "JSON; construct geometry.SDF(fn, name=...) in-process instead")


_PARSERS = {
    "ellipse": _parse_ellipse, "rect": _parse_rect,
    "rectangle": _parse_rect, "polygon": _parse_polygon,
    "union": _parse_union, "intersection": _parse_intersection,
    "difference": _parse_difference, "sdf": _parse_sdf,
}

# Per-type key whitelists: a misspelled parameter ("Rx", "radius") must
# not fall through to a default and solve the wrong domain.
_FIELDS = {
    "ellipse": {"type", "cx", "cy", "rx", "ry"},
    "rect": {"type", "x0", "y0", "x1", "y1"},
    "rectangle": {"type", "x0", "y0", "x1", "y1"},
    "polygon": {"type", "vertices"},
    "union": {"type", "shapes"},
    "intersection": {"type", "shapes"},
    "difference": {"type", "shape", "hole"},
    "sdf": {"type", "name"},
}


def _parse_obj(o) -> GeometrySpec:
    if not isinstance(o, dict) or "type" not in o:
        raise ValueError(f"geometry spec must be an object with a "
                         f"'type' key, got {o!r}")
    t = str(o["type"]).lower()
    if t not in _PARSERS:
        raise ValueError(
            f"unknown geometry type {t!r}; known: "
            f"{', '.join(sorted(k for k in _PARSERS if k != 'rectangle'))}")
    unknown = set(o) - _FIELDS[t]
    if unknown:
        raise ValueError(
            f"geometry type {t!r} got unknown field(s) "
            f"{', '.join(sorted(map(repr, unknown)))}; allowed: "
            f"{', '.join(sorted(_FIELDS[t] - {'type'}))}")
    try:
        return _PARSERS[t](o)
    except KeyError as e:
        raise ValueError(f"geometry type {t!r} is missing field {e}")


def parse_geometry(spec) -> GeometrySpec:
    """Coerce ``spec`` (GeometrySpec | dict | JSON string) into a
    normalized :class:`GeometrySpec`."""
    if isinstance(spec, GeometrySpec):
        return spec.normalize()
    if isinstance(spec, str):
        try:
            spec = json.loads(spec)
        except json.JSONDecodeError as e:
            raise ValueError(f"geometry spec is not valid JSON: {e}")
    return _parse_obj(spec).normalize()


def fingerprint_of(spec: Optional[GeometrySpec]) -> str:
    """A spec's fingerprint, or ``"default"`` for no geometry (the
    reference ellipse)."""
    return spec.fingerprint if spec is not None else "default"
