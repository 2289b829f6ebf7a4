"""Convergence observatory: iteration forecasting, mid-flight rate
estimation and the fleet scoreboard (counterpart of
``poisson_tpu/obs/forecast.py``).

1. :class:`ForecastModel`: a per-cohort streaming estimator of iteration
   count (median/p90) and per-iteration wall. Cold cohorts are seeded from
   the analytic model (iterations ≈ √(M·N), seconds per iteration = the
   analytic bytes over the device's peak bandwidth, ``obs.costs``). It
   persists as a CRC-sealed JSON snapshot in the JAX package's format, so
   either package loads the other's; a torn snapshot is skipped audibly
   (``obs.forecast.snapshot.torn``), a missing one silently.
2. The ``history_every`` residual-history seam: (k, ‖Δw‖) samples of a
   running solve into the process-wide :class:`HistoryBuffer`. The JAX
   loop ships them through a ``jax.debug.callback``; the port's plain body
   stages them on the device with an ``obs.stream.StreamTap`` aimed at
   :func:`emit_history`, and ``solvers.pcg.drive`` copies them to the host
   at its read of ``done`` (no host sync per sample). The chunked solves
   tap each chunk boundary (``run_chunked(history=True)``). The host-side
   estimators (:func:`log_residual_slope`, :func:`remaining_iterations`)
   turn the samples into a convergence rate and an ETA.
3. :func:`build_scoreboard` / :func:`render_scoreboard`: the one-screen
   operator surface behind ``python -m poisson_tpu_torch top``, read from
   a live registry snapshot, a Prometheus page or textfile, or a dead
   process's ``metrics-rank*.json`` directory.

Counters per completed solve, by the JAX package's names:
``obs.forecast.predictions``, ``obs.forecast.abs_err_pct``,
``obs.forecast.cold_cohorts``, the ``obs.forecast.calibration_pct``
histogram and ``obs.forecast.calibration_err_pct``.
"""

from __future__ import annotations

import json
import math
import os
import threading
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from poisson_tpu_torch.obs import metrics as obs

# Cold-model fallback bandwidth (GB/s) for a device with no ceiling on
# file: pessimistic, so cold ETAs over-estimate.
DEFAULT_COLD_GBPS = 10.0

# Per-cohort sample window.
SAMPLE_WINDOW = 128

# Calibration histogram bucket upper bounds, in absolute percent error.
CALIBRATION_BUCKETS_PCT = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0,
                           200.0)

# Cold p90 head-room over the √(M·N) median seed.
COLD_P90_FACTOR = 1.5

SNAPSHOT_VERSION = 1


class LatencyHistogram:
    """A fixed-bucket histogram (the JAX package's
    ``obs.flight.LatencyHistogram``): its :meth:`snapshot` is the shape
    ``obs.export`` renders as a Prometheus histogram."""

    def __init__(self, buckets):
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = max(0.0, float(value))
        self._sum += v
        self._count += 1
        for i, le in enumerate(self.buckets):
            if v <= le:
                self._counts[i] += 1
                return
        self._counts[-1] += 1

    def snapshot(self) -> dict:
        """Cumulative ``le`` counts plus ``sum``/``count``."""
        cumulative: Dict[str, int] = {}
        running = 0
        for le, n in zip(self.buckets, self._counts):
            running += n
            cumulative[f"{le:g}"] = running
        cumulative["+Inf"] = self._count
        return {"le": cumulative, "sum": round(self._sum, 6),
                "count": self._count}


# -- residual-history seam (the history_every solver flag) ---------------

class HistoryBuffer:
    """Host-side ring of (k, ‖Δw‖) samples, the receiver of
    :func:`history_tap`."""

    def __init__(self, maxlen: int = 256):
        self.samples: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def emit(self, k: int, diff: float) -> None:
        with self._lock:
            self.samples.append((int(k), float(diff)))

    def slope(self) -> Optional[float]:
        with self._lock:
            return log_residual_slope(list(self.samples))


_LOCK = threading.Lock()
_HISTORY: Optional[HistoryBuffer] = None


def set_history(buf: Optional[HistoryBuffer]) -> Optional[HistoryBuffer]:
    """Install the process-wide history sink; returns the previous one."""
    global _HISTORY
    with _LOCK:
        prev, _HISTORY = _HISTORY, buf
    return prev


def get_history() -> Optional[HistoryBuffer]:
    return _HISTORY


def history_tap(k, diff) -> None:
    """Forward one sample to the active buffer; with none it is dropped,
    and a failing buffer never takes the solve down."""
    buf = _HISTORY
    if buf is not None:
        try:
            buf.emit(int(k), float(diff))
        except Exception:
            pass


def emit_history(history_every: int, k, diff) -> None:
    """Ship (k, ‖Δw‖) to :func:`history_tap` when ``k`` is a multiple of
    ``history_every`` (> 0)."""
    if int(k) % history_every == 0:
        history_tap(k, diff)


# -- rate estimation -----------------------------------------------------

def log_residual_slope(
        samples: Sequence[Tuple[int, float]]) -> Optional[float]:
    """Least-squares slope of ln‖Δw‖ against k; None with fewer than two
    positive samples or no spread in k."""
    pts = [(float(k), math.log(d)) for k, d in samples if d > 0.0]
    if len(pts) < 2:
        return None
    n = float(len(pts))
    sx = sum(k for k, _ in pts)
    sy = sum(y for _, y in pts)
    sxx = sum(k * k for k, _ in pts)
    sxy = sum(k * y for k, y in pts)
    denom = n * sxx - sx * sx
    if denom <= 0.0:
        return None
    return (n * sxy - sx * sy) / denom


def remaining_iterations(diff: float, delta: float,
                         slope: Optional[float]) -> Optional[int]:
    """Iterations left until ‖Δw‖ ≤ delta at the estimated slope; None
    ("unknown", never "done") when it cannot be estimated."""
    if slope is None or slope >= 0.0 or diff <= 0.0 or delta <= 0.0:
        return None
    if diff <= delta:
        return 0
    return int(math.ceil(math.log(delta / diff) / slope))


def progress_fraction(done: int, predicted_total: int) -> float:
    """done/predicted, clamped to [0, 1]."""
    if predicted_total <= 0:
        return 0.0
    return max(0.0, min(1.0, float(done) / float(predicted_total)))


# -- the cold (analytic) model -------------------------------------------

def cold_iterations(M: int, N: int) -> int:
    """Analytic iteration seed: O(√(M·N)) for CG on the 5-point
    Laplacian."""
    return max(1, int(round(math.sqrt(float(M) * float(N)))))


def cold_seconds_per_iteration(M: int, N: int, *, dtype_bytes: int = 8,
                               scaled: bool = True,
                               device_kind: Optional[str] = None) -> float:
    """Analytic per-iteration wall: the cost model's bytes per iteration
    over the device's peak bandwidth (:data:`DEFAULT_COLD_GBPS` when it has
    none on file)."""
    from poisson_tpu_torch.obs.costs import (
        analytic_iteration_cost,
        platform_peak_gbps,
    )

    cost = analytic_iteration_cost(M, N, dtype_bytes=dtype_bytes,
                                   scaled=scaled)
    gbps = platform_peak_gbps(device_kind)
    if gbps is None or gbps <= 0.0:
        gbps = DEFAULT_COLD_GBPS
    return float(cost["bytes"]) / (gbps * 1e9)


# -- the online per-cohort model -----------------------------------------

@dataclass(frozen=True)
class Forecast:
    """One prediction: iterations × per-iteration wall; ``cold`` marks the
    analytic seed; ``samples`` counts the solves behind it."""

    cohort: str
    iterations_p50: float
    iterations_p90: float
    seconds_per_iteration: float
    eta_p50_seconds: float
    eta_p90_seconds: float
    cold: bool
    samples: int


def _quantile(ordered: List[float], q: float) -> float:
    """Nearest-rank quantile of an already sorted list."""
    if not ordered:
        return 0.0
    idx = min(len(ordered) - 1, max(0, int(math.ceil(q * len(ordered))) - 1))
    return ordered[idx]


class _CohortStats:
    __slots__ = ("iterations", "spi")

    def __init__(self):
        self.iterations: deque = deque(maxlen=SAMPLE_WINDOW)
        self.spi: deque = deque(maxlen=SAMPLE_WINDOW)


def cohort_name(*parts) -> str:
    """Canonical cohort key: the parts joined with '|', None as '-'."""
    return "|".join("-" if p is None else str(p) for p in parts)


def _seal(payload: dict) -> int:
    """CRC32 over the canonical (sorted-key) JSON."""
    blob = json.dumps(payload, sort_keys=True, default=str)
    return zlib.crc32(blob.encode()) & 0xFFFFFFFF


def snapshot_path(journal_path: str) -> str:
    """The forecast snapshot lives beside the journal it serves."""
    return journal_path + ".forecast.json"


def _read_sealed(path: str, torn_counter: str) -> Optional[dict]:
    """A snapshot's payload, or None: silently when the file is missing,
    counting ``torn_counter`` when it is unreadable, torn, tampered with or
    of another version."""
    try:
        with open(path) as fh:
            payload = json.load(fh)
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        obs.inc(torn_counter)
        return None
    if not isinstance(payload, dict):
        obs.inc(torn_counter)
        return None
    stored = payload.pop("crc32", None)
    if (stored is None or _seal(payload) != stored
            or payload.get("version") != SNAPSHOT_VERSION):
        obs.inc(torn_counter)
        return None
    return payload


def _write_sealed(path: str, payload: dict, prefix: str) -> bool:
    """Atomically write the CRC-sealed ``payload`` (tmp + rename), counting
    ``<prefix>.saves`` or ``<prefix>.write_errors``."""
    payload["crc32"] = _seal(payload)
    tmp = path + ".tmp"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w") as fh:
            json.dump(payload, fh, sort_keys=True)
        os.replace(tmp, path)
    except (OSError, ValueError):
        obs.inc(f"{prefix}.write_errors")
        return False
    obs.inc(f"{prefix}.saves")
    return True


class ForecastModel:
    """Per-cohort streaming iteration and wall estimator.

    :meth:`predict` is pure (no counters). :meth:`observe` predicts, grades
    the prediction against the completed solve, publishes the calibration
    counters and only then absorbs the sample."""

    def __init__(self):
        self._cohorts: Dict[str, _CohortStats] = {}
        self._errs: deque = deque(maxlen=SAMPLE_WINDOW * 4)
        self._calibration = LatencyHistogram(CALIBRATION_BUCKETS_PCT)
        self._lock = threading.Lock()

    def predict(self, cohort: str, *, M: int, N: int,
                dtype_bytes: int = 8, scaled: bool = True,
                device_kind: Optional[str] = None) -> Forecast:
        cold_spi = cold_seconds_per_iteration(
            M, N, dtype_bytes=dtype_bytes, scaled=scaled,
            device_kind=device_kind)
        with self._lock:
            stats = self._cohorts.get(cohort)
            iters = sorted(stats.iterations) if stats else []
            spis = sorted(s for s in (stats.spi if stats else []) if s > 0.0)
        if iters:
            it50 = _quantile(iters, 0.5)
            it90 = _quantile(iters, 0.9)
            cold = False
        else:
            it50 = float(cold_iterations(M, N))
            it90 = it50 * COLD_P90_FACTOR
            cold = True
        spi = _quantile(spis, 0.5) if spis else cold_spi
        return Forecast(cohort=cohort, iterations_p50=it50,
                        iterations_p90=it90, seconds_per_iteration=spi,
                        eta_p50_seconds=it50 * spi,
                        eta_p90_seconds=it90 * spi,
                        cold=cold, samples=len(iters))

    def observe(self, cohort: str, iterations: int,
                compute_seconds: float, *, M: int, N: int,
                dtype_bytes: int = 8, scaled: bool = True,
                device_kind: Optional[str] = None) -> float:
        """Feed back one completed solve; returns the absolute percent
        iteration error of the prediction made before it."""
        fc = self.predict(cohort, M=M, N=N, dtype_bytes=dtype_bytes,
                          scaled=scaled, device_kind=device_kind)
        actual = max(1, int(iterations))
        err_pct = abs(fc.iterations_p50 - actual) / float(actual) * 100.0
        obs.inc("obs.forecast.predictions")
        if fc.cold:
            obs.inc("obs.forecast.cold_cohorts")
        obs.gauge("obs.forecast.abs_err_pct", round(err_pct, 3))
        with self._lock:
            self._calibration.observe(err_pct)
            self._errs.append(err_pct)
            p50_err = _quantile(sorted(self._errs), 0.5)
            obs.gauge("obs.forecast.calibration_pct",
                      self._calibration.snapshot())
            obs.gauge("obs.forecast.calibration_err_pct",
                      round(p50_err, 3))
            stats = self._cohorts.setdefault(cohort, _CohortStats())
            stats.iterations.append(int(iterations))
            if compute_seconds > 0.0 and iterations > 0:
                stats.spi.append(float(compute_seconds) / float(iterations))
        return err_pct

    def calibration_err_pct(self) -> Optional[float]:
        """Running p50 absolute iteration error (percent), or None."""
        with self._lock:
            if not self._errs:
                return None
            return _quantile(sorted(self._errs), 0.5)

    def cohorts(self) -> Dict[str, dict]:
        """Per-cohort sample counts and medians."""
        out: Dict[str, dict] = {}
        with self._lock:
            for key, stats in self._cohorts.items():
                iters = sorted(stats.iterations)
                spis = sorted(s for s in stats.spi if s > 0.0)
                out[key] = {
                    "samples": len(iters),
                    "iterations_p50": _quantile(iters, 0.5),
                    "iterations_p90": _quantile(iters, 0.9),
                    "seconds_per_iteration":
                        _quantile(spis, 0.5) if spis else None,
                }
        return out

    def save(self, path: str) -> bool:
        """Atomically write the CRC-sealed snapshot; best effort."""
        with self._lock:
            payload = {
                "version": SNAPSHOT_VERSION,
                "cohorts": {
                    key: {"iterations": list(stats.iterations),
                          "spi": [round(s, 12) for s in stats.spi]}
                    for key, stats in self._cohorts.items()
                },
                "errs": [round(e, 6) for e in self._errs],
            }
        return _write_sealed(path, payload, "obs.forecast.snapshot")

    def load(self, path: str) -> bool:
        """Warm-load a snapshot in place; missing is silent, torn is
        counted and leaves the model as it was."""
        payload = _read_sealed(path, "obs.forecast.snapshot.torn")
        if payload is None:
            return False
        with self._lock:
            self._cohorts.clear()
            for key, rec in payload.get("cohorts", {}).items():
                stats = _CohortStats()
                for it in rec.get("iterations", []):
                    stats.iterations.append(int(it))
                for s in rec.get("spi", []):
                    stats.spi.append(float(s))
                self._cohorts[key] = stats
            self._errs.clear()
            for e in payload.get("errs", []):
                self._errs.append(float(e))
        obs.inc("obs.forecast.snapshot.loads")
        return True


# -- the fleet scoreboard ------------------------------------------------

def _flatten_metrics(metrics: dict) -> Dict[str, object]:
    """Either registry shape (a snapshot, a merged ``load_dir``, or a
    ``parse_text`` result) as one flat dict keyed by Prometheus name."""
    from poisson_tpu_torch.obs.export import metric_name

    flat: Dict[str, object] = {}
    if ("counters" in metrics or "gauges" in metrics
            or "gauges_by_rank" in metrics):
        for section in ("counters", "gauges"):
            for name, value in (metrics.get(section) or {}).items():
                flat[metric_name(name)] = value
        by_rank = metrics.get("gauges_by_rank") or {}
        for rank in sorted(by_rank):
            for name, value in (by_rank[rank] or {}).items():
                flat.setdefault(metric_name(name), value)
    else:
        for name, rec in metrics.items():
            flat[name] = rec.get("value") if isinstance(rec, dict) else rec
    return flat


def _get(flat: Dict[str, object], dotted: str, default=None):
    from poisson_tpu_torch.obs.export import metric_name

    return flat.get(metric_name(dotted), default)


def _hit_rate(flat: Dict[str, object], prefix: str) -> Optional[float]:
    hits = _get(flat, prefix + ".hits")
    misses = _get(flat, prefix + ".misses")
    if hits is None and misses is None:
        return None
    h = float(hits or 0)
    m = float(misses or 0)
    total = h + m
    return (h / total) if total > 0 else None


def _prefix_scan(flat: Dict[str, object],
                 dotted_prefix: str) -> Dict[str, object]:
    """Every scalar metric under a dotted prefix, keyed by its suffix."""
    from poisson_tpu_torch.obs.export import metric_name

    prom_prefix = metric_name(dotted_prefix)
    out: Dict[str, object] = {}
    for name, value in flat.items():
        if name.startswith(prom_prefix + "_"):
            if isinstance(value, dict):
                continue
            out[name[len(prom_prefix) + 1:]] = value
    return out


def build_scoreboard(metrics: dict) -> dict:
    """A metrics registry (any shape :func:`_flatten_metrics` reads) as the
    ``top`` scoreboard's sections, the JAX package's; a metric never
    emitted reads None."""
    flat = _flatten_metrics(metrics)
    g = lambda name: _get(flat, name)   # noqa: E731
    return {
        "queue": {
            "depth": g("serve.queue_depth"),
            "load_level": g("serve.load_level"),
            "shed_rate": g("serve.shed_rate"),
            "eta_backlog_seconds": g("serve.forecast.backlog_seconds"),
            "lost_requests": g("serve.lost_requests"),
        },
        "lanes": {
            "active_lanes": g("serve.refill.active_lanes"),
            "dispatches": g("serve.dispatches"),
            "workers_alive": g("serve.placement.alive"),
            "devices": g("serve.placement.devices"),
        },
        "breakers": {
            "trips": g("serve.breaker.trips"),
            "half_opens": g("serve.breaker.half_opens"),
            "closes": g("serve.breaker.closes"),
        },
        "slo": {
            "good": g("serve.slo.good"),
            "bad": g("serve.slo.bad"),
            "budget_remaining": g("serve.slo.budget_remaining"),
            "burn_rates": _prefix_scan(flat, "serve.slo.burn_rate"),
        },
        "caches": {
            "canvas": _hit_rate(flat, "geom.cache"),
            "bucket": _hit_rate(flat, "batched.bucket_cache"),
            "krylov": _hit_rate(flat, "krylov.cache"),
            "hierarchy": _hit_rate(flat, "mg.hierarchy_cache"),
        },
        "placement": {
            "epoch": g("serve.placement.epoch"),
            "rebinds": g("serve.placement.rebinds"),
            "replans": g("serve.placement.replans"),
        },
        "forecast": {
            "predictions": g("obs.forecast.predictions"),
            "cold_cohorts": g("obs.forecast.cold_cohorts"),
            "abs_err_pct": g("obs.forecast.abs_err_pct"),
            "calibration_err_pct": g("obs.forecast.calibration_err_pct"),
            "predicted_deadline_sheds": g("serve.shed.predicted_deadline"),
            "preempted": g("serve.forecast.preempted"),
        },
        "backends": {
            "decisions": g("serve.router.decisions"),
            "cold_decisions": g("serve.router.cold_decisions"),
            "warm_decisions": g("serve.router.warm_decisions"),
            "mispredictions": g("serve.router.mispredictions"),
            "demotions": g("serve.router.demotions"),
            "recoveries": g("serve.router.recoveries"),
            "demoted_arms": g("serve.router.demoted_arms"),
            "chosen": _prefix_scan(flat, "serve.router.chosen"),
            "fractions": _prefix_scan(flat, "obs.roofline.fraction"),
            "calibration_err_pct": g("obs.roofline.calibration_err_pct"),
        },
        "tenants": {
            "shares": _prefix_scan(flat, "serve.tenant.share"),
            "quota_tokens": _prefix_scan(flat, "serve.tenant.quota_tokens"),
            "retry_tokens": _prefix_scan(flat, "serve.tenant.retry_tokens"),
            "slo_burn": _prefix_scan(flat, "serve.tenant.slo_burn"),
            "shed": _prefix_scan(flat, "serve.tenant.shed"),
            "quota_sheds": g("serve.tenant.quota_sheds"),
            "retry_exhausted": g("serve.tenant.retry_exhausted"),
        },
    }


def _cell(value, fmt: str = "{}") -> str:
    if value is None:
        return "-"
    if isinstance(value, float):
        if fmt == "{}" and value == int(value):
            return str(int(value))
        return fmt.format(value)
    return str(value)


def render_scoreboard(board: dict) -> str:
    """One plain-text screen of the scoreboard (the JAX package's layout,
    line for line)."""
    q, ln = board["queue"], board["lanes"]
    br, slo = board["breakers"], board["slo"]
    ca, pl, fc = board["caches"], board["placement"], board["forecast"]
    bk = board.get("backends") or {}
    fractions = bk.get("fractions") or {}
    lines = [
        "poisson_tpu fleet scoreboard",
        "=" * 64,
        (f"queue     depth {_cell(q['depth'])}"
         f"  level {_cell(q['load_level'])}"
         f"  shed_rate {_cell(q['shed_rate'], '{:.3f}')}"
         f"  eta_backlog {_cell(q['eta_backlog_seconds'], '{:.3f}')}s"
         f"  lost {_cell(q['lost_requests'])}"),
        (f"lanes     active {_cell(ln['active_lanes'])}"
         f"  dispatches {_cell(ln['dispatches'])}"
         f"  workers {_cell(ln['workers_alive'])}"
         f"  devices {_cell(ln['devices'])}"),
        (f"breakers  trips {_cell(br['trips'])}"
         f"  half_opens {_cell(br['half_opens'])}"
         f"  closes {_cell(br['closes'])}"),
        (f"slo       good {_cell(slo['good'])}  bad {_cell(slo['bad'])}"
         f"  budget {_cell(slo['budget_remaining'], '{:.3f}')}"
         + "".join(f"  burn[{w}] {_cell(v, '{:.2f}')}"
                   for w, v in sorted(slo["burn_rates"].items()))),
        ("caches    "
         + "  ".join(f"{name} {_cell(rate, '{:.0%}')}"
                     for name, rate in ca.items())),
        (f"placement epoch {_cell(pl['epoch'])}"
         f"  rebinds {_cell(pl['rebinds'])}"
         f"  replans {_cell(pl['replans'])}"),
        (f"forecast  predictions {_cell(fc['predictions'])}"
         f"  cold {_cell(fc['cold_cohorts'])}"
         f"  p50_err {_cell(fc['calibration_err_pct'], '{:.1f}')}%"
         f"  pred_sheds {_cell(fc['predicted_deadline_sheds'])}"
         f"  preempted {_cell(fc['preempted'])}"),
        (f"backends  decisions {_cell(bk.get('decisions'))}"
         f" (cold {_cell(bk.get('cold_decisions'))}"
         f"/warm {_cell(bk.get('warm_decisions'))})"
         f"  mispred {_cell(bk.get('mispredictions'))}"
         f"  demoted {_cell(bk.get('demotions'))}"
         f"  recovered {_cell(bk.get('recoveries'))}"
         f"  p50_err {_cell(bk.get('calibration_err_pct'), '{:.1f}')}%"
         + "".join(
             f"  {arm} n={_cell(n)}"
             + (f" frac={_cell(fractions.get(arm), '{:.3f}')}"
                if fractions.get(arm) is not None else "")
             for arm, n in sorted((bk.get("chosen") or {}).items()))),
    ]
    tn = board.get("tenants") or {}
    tenant_names = sorted(
        set(tn.get("shares") or {})
        | set(tn.get("quota_tokens") or {})
        | set(tn.get("retry_tokens") or {}))
    if tenant_names:
        lines.append(
            f"tenants   quota_sheds {_cell(tn.get('quota_sheds'))}"
            f"  retry_exhausted {_cell(tn.get('retry_exhausted'))}")
        for name in tenant_names:
            retry = (tn.get("retry_tokens") or {}).get(name)
            lines.append(
                f"  {name:<8}"
                f" share {_cell((tn.get('shares') or {}).get(name), '{:g}')}"
                f"  quota {_cell((tn.get('quota_tokens') or {}).get(name), '{:.1f}')}"
                f"  retry {'off' if retry is not None and retry < 0 else _cell(retry, '{:.1f}')}"
                f"  shed {_cell((tn.get('shed') or {}).get(name))}"
                f"  slo_burn {_cell((tn.get('slo_burn') or {}).get(name), '{:.2f}')}")
    return "\n".join(lines)
