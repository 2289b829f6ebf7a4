"""Roofline observatory: per-dispatch measured bandwidth attribution
(counterpart of ``poisson_tpu/obs/roofline.py``).

:class:`RooflineModel` keeps, per cohort (backend, grid, batch, dtype,
preconditioner, verify stride, device), a streaming profile of the measured
fraction of the device's bandwidth ceiling. Each observation turns measured
seconds into achieved GB/s (the backend's bytes per iteration ×
iterations / seconds) and a fraction of ``obs.costs.platform_peak_gbps``
(``obs.forecast.DEFAULT_COLD_GBPS`` where no ceiling is on file), and is
graded against the cohort's expectation before it is absorbed (cold
cohorts expect :data:`DEFAULT_COLD_FRACTION`). The snapshot is CRC-sealed
JSON in the JAX package's format: either package loads the other's.

The port's backends map to bytes through ``obs.costs.iteration_bytes``
(the kernels' bytes for ``fused``, ``ca`` and the kernel-sharded backends,
the JAX ``xla`` model for ``torch`` and ``sharded``). The resident solve
keeps its state on chip; like the JAX package, the model prices it at the
placeholder :data:`RESIDENT_EFFECTIVE_PASSES` so that a router can rank it.

Counters and gauges by the JAX package's names: ``obs.roofline.observations``,
``.cold_cohorts``, ``.skipped``, ``.abs_err_pct``, ``.calibration_err_pct``,
``.calibration_pct``, ``.fraction``, ``.fraction.<backend>`` and the
``obs.roofline.snapshot.{saves,loads,torn,write_errors}`` family.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

from poisson_tpu_torch.obs import metrics as obs
from poisson_tpu_torch.obs.costs import (
    grid_points,
    iteration_bytes,
    platform_peak_gbps,
)
from poisson_tpu_torch.obs.forecast import (
    DEFAULT_COLD_GBPS,
    SAMPLE_WINDOW,
    LatencyHistogram,
    _quantile,
    _read_sealed,
    _write_sealed,
    cohort_name,
)

# The resident kernel's placeholder passes per iteration (its working set
# stays on chip): a model constant for ranking, which a measured cohort
# replaces.
RESIDENT_EFFECTIVE_PASSES = 0.5

# Cold expected roofline fraction, before a cohort has a measurement.
DEFAULT_COLD_FRACTION = 0.6

# |expected − measured| fraction error histogram bounds, percent.
CALIBRATION_BUCKETS_PCT = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0,
                           200.0)

SNAPSHOT_VERSION = 1


def snapshot_path(journal_path: str) -> str:
    """The roofline snapshot lives beside the journal it serves."""
    return journal_path + ".roofline.json"


def effective_passes(backend: Optional[str],
                     preconditioner: Optional[str] = None,
                     M: int = 0, N: int = 0,
                     dtype_bytes: int = 8) -> Optional[float]:
    """Grid passes per iteration of ``backend`` on an (M, N) grid: its
    bytes per iteration (``obs.costs.iteration_bytes``, default canvas and
    a 1×1 mesh) over one grid pass, the resident placeholder, plus one
    V-cycle's fine-equivalent passes for MG. None for a backend with no
    model (a kernel backend needs the grid)."""
    name = backend or ""
    if name == "resident":
        passes: Optional[float] = RESIDENT_EFFECTIVE_PASSES
    elif M > 0 and N > 0:
        from poisson_tpu_torch.config import Problem

        nbytes = iteration_bytes(Problem(M=M, N=N), name,
                                 dtype_bytes=dtype_bytes)
        passes = (None if nbytes is None
                  else nbytes / (grid_points(M, N) * dtype_bytes))
    else:
        from poisson_tpu_torch.obs.costs import EFFECTIVE_PASSES

        passes = EFFECTIVE_PASSES.get(name)
    if passes is None:
        return None
    if preconditioner == "mg" and M > 0 and N > 0:
        passes += _mg_passes(M, N, dtype_bytes)
    return passes


_MG_PASSES_MEMO: Dict[tuple, float] = {}


def _mg_passes(M: int, N: int, dtype_bytes: int) -> float:
    key = (M, N, dtype_bytes)
    if key not in _MG_PASSES_MEMO:
        from poisson_tpu_torch.obs.costs import mg_vcycle_cost

        _MG_PASSES_MEMO[key] = float(
            mg_vcycle_cost(M, N, dtype_bytes=dtype_bytes)
            ["passes_fine_equivalent"])
    return _MG_PASSES_MEMO[key]


def roofline_cohort(backend: str, M: int, N: int, batch: int,
                    dtype_bytes: int, preconditioner: Optional[str],
                    verify_every: int,
                    device_kind: Optional[str]) -> str:
    """Canonical roofline cohort key (the forecast module's spelling)."""
    return cohort_name(backend, f"{M}x{N}", batch, dtype_bytes,
                       preconditioner, verify_every, device_kind)


@dataclass(frozen=True)
class RooflineSample:
    """One graded measurement: ``fraction`` measured, ``expected_fraction``
    the cohort's expectation before it, ``err_pct`` their gap in percent of
    the expectation."""

    cohort: str
    backend: str
    achieved_gbps: float
    peak_gbps: float
    fraction: float
    expected_fraction: float
    err_pct: float
    cold: bool
    samples: int


class RooflineModel:
    """Per-cohort streaming roofline-fraction profiles.

    :meth:`expected_fraction` is pure. :meth:`observe` computes the
    measured fraction, grades it against the expectation, publishes the
    calibration counters, then absorbs the sample."""

    def __init__(self):
        self._cohorts: Dict[str, deque] = {}
        self._by_backend: Dict[str, deque] = {}
        self._errs: deque = deque(maxlen=SAMPLE_WINDOW * 4)
        self._calibration = LatencyHistogram(CALIBRATION_BUCKETS_PCT)
        self._lock = threading.Lock()

    def expected_fraction(self, cohort: str) -> tuple:
        """(expected fraction, cold, samples): the cohort's running p50, or
        the cold prior."""
        with self._lock:
            fracs = sorted(self._cohorts.get(cohort, ()))
        if fracs:
            return _quantile(fracs, 0.5), False, len(fracs)
        return DEFAULT_COLD_FRACTION, True, 0

    def backend_fraction(self, backend: str) -> Optional[float]:
        """Running p50 measured fraction over every cohort of ``backend``,
        or None unmeasured."""
        with self._lock:
            fracs = sorted(self._by_backend.get(backend, ()))
        return _quantile(fracs, 0.5) if fracs else None

    def observe(self, *, backend: str, M: int, N: int, batch: int = 1,
                dtype_bytes: int = 8,
                preconditioner: Optional[str] = None,
                verify_every: int = 0,
                device_kind: Optional[str] = None,
                iterations: int, seconds: float, devices: int = 1,
                passes_override: Optional[float] = None
                ) -> Optional[RooflineSample]:
        """Grade and absorb one measured dispatch; None (counting
        ``obs.roofline.skipped``) when it cannot be measured (no wall, no
        iteration, or no bytes model)."""
        if seconds <= 0.0 or iterations <= 0:
            obs.inc("obs.roofline.skipped")
            return None
        passes = (passes_override if passes_override is not None
                  else effective_passes(backend, preconditioner, M, N,
                                        dtype_bytes))
        if passes is None or passes <= 0.0:
            obs.inc("obs.roofline.skipped")
            return None
        peak = platform_peak_gbps(device_kind)
        if peak is None or peak <= 0.0:
            peak = DEFAULT_COLD_GBPS
        grid_bytes = grid_points(M, N) * dtype_bytes
        model_bytes = passes * grid_bytes * max(1, int(batch)) \
            * int(iterations)
        achieved = model_bytes / seconds / max(1, int(devices)) / 1e9
        fraction = achieved / peak
        cohort = roofline_cohort(backend, M, N, max(1, int(batch)),
                                 dtype_bytes, preconditioner,
                                 int(verify_every), device_kind)
        expected, cold, samples = self.expected_fraction(cohort)
        err_pct = abs(expected - fraction) / max(expected, 1e-12) * 100.0
        obs.inc("obs.roofline.observations")
        if cold:
            obs.inc("obs.roofline.cold_cohorts")
        obs.gauge("obs.roofline.fraction", round(fraction, 6))
        obs.gauge("obs.roofline.abs_err_pct", round(err_pct, 3))
        with self._lock:
            self._calibration.observe(err_pct)
            self._errs.append(err_pct)
            obs.gauge("obs.roofline.calibration_pct",
                      self._calibration.snapshot())
            obs.gauge("obs.roofline.calibration_err_pct",
                      round(_quantile(sorted(self._errs), 0.5), 3))
            self._cohorts.setdefault(
                cohort, deque(maxlen=SAMPLE_WINDOW)).append(fraction)
            per_backend = self._by_backend.setdefault(
                backend, deque(maxlen=SAMPLE_WINDOW))
            per_backend.append(fraction)
            obs.gauge(f"obs.roofline.fraction.{backend}",
                      round(_quantile(sorted(per_backend), 0.5), 6))
        return RooflineSample(
            cohort=cohort, backend=backend,
            achieved_gbps=round(achieved, 4), peak_gbps=float(peak),
            fraction=fraction, expected_fraction=expected,
            err_pct=err_pct, cold=cold, samples=samples)

    def calibration_err_pct(self) -> Optional[float]:
        """Running p50 |expected − measured| fraction error (percent), or
        None before the first observation."""
        with self._lock:
            if not self._errs:
                return None
            return _quantile(sorted(self._errs), 0.5)

    def cohorts(self) -> Dict[str, dict]:
        """Per-cohort sample counts and fraction quantiles."""
        out: Dict[str, dict] = {}
        with self._lock:
            for key, fracs in self._cohorts.items():
                ordered = sorted(fracs)
                out[key] = {
                    "samples": len(ordered),
                    "fraction_p50": round(_quantile(ordered, 0.5), 6),
                    "fraction_p90": round(_quantile(ordered, 0.9), 6),
                }
        return out

    def save(self, path: str) -> bool:
        """Atomically write the CRC-sealed snapshot; best effort."""
        with self._lock:
            payload = {
                "version": SNAPSHOT_VERSION,
                "cohorts": {
                    key: {"fractions": [round(f, 9) for f in fracs]}
                    for key, fracs in self._cohorts.items()
                },
                "by_backend": {
                    backend: [round(f, 9) for f in fracs]
                    for backend, fracs in self._by_backend.items()
                },
                "errs": [round(e, 6) for e in self._errs],
            }
        return _write_sealed(path, payload, "obs.roofline.snapshot")

    def load(self, path: str) -> bool:
        """Warm-load a snapshot in place; missing is silent, torn is
        counted (``obs.roofline.snapshot.torn``) and leaves the model as it
        was."""
        payload = _read_sealed(path, "obs.roofline.snapshot.torn")
        if payload is None:
            return False
        with self._lock:
            self._cohorts = {
                key: deque((float(f) for f in rec.get("fractions", [])),
                           maxlen=SAMPLE_WINDOW)
                for key, rec in payload.get("cohorts", {}).items()}
            self._by_backend = {
                backend: deque((float(f) for f in fracs),
                               maxlen=SAMPLE_WINDOW)
                for backend, fracs in payload.get("by_backend", {}).items()}
            self._errs.clear()
            self._errs.extend(float(e) for e in payload.get("errs", []))
        obs.inc("obs.roofline.snapshot.loads")
        return True
