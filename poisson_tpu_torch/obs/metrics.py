"""Counters: the process-wide metrics registry (counterpart of
``poisson_tpu/obs/metrics.py``).

A flat registry of named counters (monotone adds) and gauges (last-set
values), always on: an increment is a dict add under a lock, so the call
sites never ask whether telemetry is configured. Snapshots are written as
JSON by :func:`poisson_tpu_torch.obs.finalize` (to ``--metrics-out`` and/or
``metrics-rank{R}.json`` in the trace directory); per-rank snapshots merge
with :func:`merge` (counters sum across ranks, gauges stay per rank).

The snapshot schema and the counter names are the JAX package's, so a
snapshot written by either package loads with the other's :func:`load_dir`.
The names the port emits:

- ``pcg.solves.<verdict>`` / ``pcg.iterations.<verdict>`` — solves and
  iterations by stop-flag name (``solvers.pcg.FLAG_NAMES``), counted by
  the CLI's report (``utils.timing.count_solve``);
- ``pcg.drive.{graph_captures,graph_replays,eager_steps}`` — the loop's
  captured blocks (``solvers.graphs``): blocks of a capturable step (the
  fused body on a card, the sharded body on a mesh's cards) captured as
  CUDA graphs, blocks replayed, and steps of a capturable step run eagerly
  (a first block, a tail shorter than ``check_every``, a state not yet in
  the block's shape, a block held by another thread, a block whose capture
  failed); the share of steps replayed is replays × ``check_every`` ÷
  (that + ``eager_steps``); ``pcg.drive.multi_card_replays`` — the
  replays of a block whose state spans more than one card (0 on one
  card);
- ``ops.launches.<key>`` — the CUDA kernels' launches (``ops.launch``),
  one add a launch, by the wrapper's form: ``direction_and_stencil`` and
  ``fused_update`` (A, B; with ``_sharded`` their masked forms, with
  ``_blocked`` A′, B′), ``basis_sweep`` and ``pair_update`` (C, D; with
  ``_sharded``), ``resident_solve`` (R), ``serial_sum`` (S), and
  ``recurrence_step`` and ``recurrence_close`` (the fused iteration's
  scalar recurrence, ``ops.recurrence``: one of each an iteration on a
  card, none on the CPU); a replayed block adds what its capture counted,
  as to every counter;
- ``time.compile_seconds`` / ``time.execute_seconds`` — accumulating float
  counters: the first call's extra time (kernel build and load, canvas
  setup) and the timed solves;
- ``checkpoint.writes`` / ``checkpoint.corrupt`` /
  ``checkpoint.crc_failures`` / ``checkpoint.generation_fallbacks`` /
  ``checkpoint.deadline_stops`` — the checkpoint layer
  (``solvers.checkpoint``);
- ``resilient.restarts`` / ``resilient.escalations`` /
  ``resilient.deadline_stops`` and ``integrity.checks`` /
  ``integrity.detections`` / ``integrity.verified_restarts`` /
  ``integrity.false_alarms`` — the self-healing solve
  (``solvers.resilient``) and its integrity probe;
- ``watchdog.beats`` / ``watchdog.stalls`` — the chunk-boundary watchdog
  (``parallel.watchdog``);
- ``multihost.init_retries`` / ``multihost.degraded`` — the process-group
  launch (``parallel.multihost``): transient rendezvous failures retried,
  and env-driven launches that fell back to one process;
  ``multihost.sent_bytes`` / ``multihost.staged_copies`` — the transport
  of a mesh over processes (``parallel.halo``): bytes this process sent to
  other ranks (halo slices, its share of each all-gather), and copies
  staged from a card to host memory for gloo (each a host sync);
- ``mesh.halo_copies`` / ``mesh.halo_bytes`` / ``mesh.sums`` /
  ``mesh.replicas`` — the mesh's traffic between shards
  (``parallel.halo``, one add a call): halo slices this process copied
  into its shards from another shard (zero fills at the mesh edge are not
  copies) and their bytes, mesh-order sums taken (a ``mesh_sum`` call or
  a group of ``mesh_sums``), and the copies ``replicate`` makes of a
  scalar to a device other than its own;
- ``batched.solves`` / ``batched.padding_members`` /
  ``batched.bucket_cache.hits`` / ``batched.bucket_cache.misses`` and the
  gauges ``batched.last_bucket`` / ``batched.solves_per_sec`` — the
  multi-RHS driver (``solvers.batched``) and its CLI;
- ``krylov.cache.hits`` / ``krylov.cache.misses`` /
  ``krylov.cache.evictions`` / ``krylov.cache.invalidations`` — the
  deflation-basis cache (``krylov.recycle``): a miss runs the harvesting
  cold solve, a hit the warm deflated one; evictions over the byte budget,
  invalidations for cause (each with a ``krylov.invalidate`` event);
  ``krylov.harvests`` (converged cold solves whose window gave a basis),
  ``krylov.warm_solves`` (warm solves that converged),
  ``krylov.iterations_saved`` (Σ cold count − warm count) and
  ``krylov.fallbacks`` (warm solves that did not converge and ran cold,
  each with a ``krylov.fallback`` event); ``krylov.block.solves`` —
  members dispatched through the block recurrence
  (``solve_batched(mode="block")``);
- ``session.steps`` / ``session.warm.hits`` / ``session.warm.fallbacks``
  (with a ``session.warm.fallback`` event and its reason) /
  ``session.setup.hits`` / ``session.setup.misses`` /
  ``session.design.steps`` — the session steps (``solvers.session``);
  the session host (``serve.session``) adds ``session.opens`` /
  ``session.closes`` / ``session.recovered`` / ``session.recovery_errors``
  / ``session.callback_errors`` / ``session.step.deadline_misses`` /
  ``session.slo.good``.

The solve service (:mod:`poisson_tpu_torch.serve`) emits the JAX
package's ``serve.*`` families, by the same names:

- the ``serve`` family — the request ledger, from which the chaos
  campaign asserts the no-lost-request invariant
  (``admitted == completed + errors + shed`` once drained):
  ``serve.admitted`` / ``serve.completed`` (with
  ``serve.completed.partial`` and ``serve.completed.recovered``) /
  ``serve.errors`` and ``serve.errors.{divergence,transient,internal,
  integrity,placement}`` / ``serve.shed`` and ``serve.shed.{queue_full,
  breaker_open,deadline_expired,predicted_deadline,quota_exceeded}``;
  the lifecycle: ``serve.dispatches`` / ``serve.batch_members`` /
  ``serve.retries`` / ``serve.backoff_seconds`` / ``serve.escalations``
  / ``serve.requeued.isolated`` / ``serve.requeued.geometry_isolated``
  / ``serve.deadline.{expired_in_queue,expired_mid_solve}`` /
  ``serve.breaker.{trips,half_opens,closes}`` / ``serve.recovered``
  (requests re-enqueued from a journal replay, never re-counted as
  admitted) / ``serve.dedup.hits``; the degradation ladder
  ``serve.degraded.{padding,iteration_cap,precision,backend_downshift,
  slo_driven,backlog_driven,mesh_shrink,single_device,mesh_shed}``; the
  gauges ``serve.queue_depth`` / ``serve.load_level`` /
  ``serve.latency_seconds`` / ``serve.p99_latency_seconds`` /
  ``serve.shed_rate`` / ``serve.lost_requests``;
- ``serve.refill.{splices,retired_lanes,idle_lane_steps,
  refill_denied_by_breaker}`` and the gauge ``serve.refill.active_lanes``
  — the continuous engine's lane table (``serve.refill``);
- ``serve.fleet.{quarantines,restarts,warmup_solves,warmup_failures,
  worker_deaths,hangs,recovered_requests,sticky_hits,sticky_misses,
  device_losses}`` and the gauges ``serve.fleet.workers`` /
  ``serve.fleet.live_workers`` — the supervised workers
  (``serve.fleet``); ``device_losses`` counts devices, ``quarantines``
  workers;
- the ``serve.placement`` family — the device registry
  (``serve.placement``): ``serve.placement.binds`` /
  ``serve.placement.rebinds`` (workers rebound to a surviving device at
  restart) / ``serve.placement.remapped`` (recovered requests whose
  recorded device is gone, remapped audibly) /
  ``serve.placement.replans`` and the gauges
  ``serve.placement.{devices,alive,epoch}``;
- ``serve.journal.{records,write_errors,replays,torn_records}`` — the
  write-ahead journal (``serve.journal``);
- the ``serve.integrity`` family — the service's silent-data-corruption
  response (``ServicePolicy.integrity``):
  ``serve.integrity.detections`` / ``serve.integrity.retries`` /
  ``serve.integrity.suspect_cohorts`` (hardware cohorts tainted by a
  first detection) / ``serve.integrity.suspect_dispatches`` (dispatches
  verified only because their cohort was suspect);
- the ``serve.router`` family — the backend router (``serve.router``):
  ``serve.router.decisions`` / ``serve.router.{cold,warm}_decisions`` /
  ``serve.router.chosen.<backend>`` (``torch``, ``resident``, ``ca``) /
  ``serve.router.{mispredictions,demotions,half_opens,recoveries}`` /
  ``serve.router.executor_fallbacks`` (routed to a kernel arm, run on
  the torch solve: the closed gate) and the gauge
  ``serve.router.demoted_arms``;
- the ``serve.slo`` family — the SLO tracker (``obs.flight``):
  ``serve.slo.good`` / ``serve.slo.bad`` and the gauges
  ``serve.slo.latency_seconds`` (histogram-shaped; Prometheus renders it
  as a histogram) / ``serve.slo.budget_remaining`` /
  ``serve.slo.objective_seconds`` / ``serve.slo.burn_rate.<window>s``;
  ``serve.tenant.slo.<tenant>.*`` is the same per tenant;
- ``serve.forecast.{admission_checks,preempted}`` and the gauge
  ``serve.forecast.backlog_seconds`` — the forecaster's service side;
  ``serve.krylov.{sticky_hits,sticky_misses,verify_suspensions}``;
  ``serve.session.shed_opens``;
- the ``serve.tenant`` family — tenancy (``serve.tenancy``):
  ``serve.tenant.{admitted,completed,errors,shed,dispatches,retries}.
  <tenant>`` / ``serve.tenant.{quota_sheds,retry_exhausted,promotions,
  lane_deferred,degraded_offender,degraded_spared}`` and the gauges
  ``serve.tenant.{share,quota_tokens,retry_tokens,slo_burn}.<tenant>``.

Beyond the service (named here so the contract gate's ``counter-doc``
rule finds every name the port writes):

- ``geom.cache.{hits,misses}`` — the canvas cache (``geometry.canvas``);
- ``mg.solves`` (MG solves started, lane splices included),
  ``mg.hierarchy_cache.{hits,misses}`` and the gauges
  ``mg.{levels,coarse_dense}`` — multigrid (``mg``);
- ``krylov.block.rank_deficient`` — block solves that truncated a
  rank-deficient direction (the service's count);
- the cost-model gauges ``cost.<name>`` (``obs.costs``: the counted
  iteration beside the model), ``cost.mg.{bytes_per_cycle,
  flops_per_cycle,passes}``, ``cost.krylov.{block_bytes_per_iter,
  block_flops_per_iter,block_passes_per_member,deflated_bytes_per_iter,
  deflated_flops_per_iter,deflated_passes}`` and ``roofline.<name>``
  (the roofline of a measured run);
- ``obs.forecast.{predictions,cold_cohorts,snapshot.loads}`` and the
  gauges ``obs.forecast.{abs_err_pct,calibration_pct,
  calibration_err_pct}`` — the forecaster (``obs.forecast``);
- ``obs.roofline.{observations,skipped,cold_cohorts,snapshot.loads,
  snapshot.torn}`` and the gauges ``obs.roofline.{fraction,abs_err_pct,
  calibration_pct,calibration_err_pct}`` / ``obs.roofline.fraction.<arm>``
  — the measured roofline model (``obs.roofline``);
- ``profile.{captures,errors}`` — profiler captures (``obs.profile``);
  the gauge ``export.http_port`` — the live ``/metrics`` endpoint
  (``obs.export``);
- the bench's gauges ``bench.{mlups,vs_baseline,batched_solves_per_sec,
  batched_speedup,verify_overhead_fraction,session_steps_per_sec,
  session_speedup}``;
- the contract gate's gauges ``contracts.{findings,suppressed,rules}``
  (``python -m poisson_tpu_torch.contracts``) and ``selfcheck.runs``
  (``python -m poisson_tpu_torch.obs.selfcheck``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

SCHEMA = "poisson_tpu.obs.metrics/1"
MERGED_SCHEMA = "poisson_tpu.obs.metrics/merged-1"

_LOCK = threading.Lock()
_COUNTERS: dict[str, float] = {}
_GAUGES: dict[str, object] = {}
_TALLY = threading.local()    # ``counts``: the open :func:`tally`, if any


def inc(name: str, value: float = 1) -> None:
    """Add ``value`` to counter ``name`` (creating it at 0)."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + value
    counts = getattr(_TALLY, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + value


@contextlib.contextmanager
def tally():
    """Yields a dict that gathers what this thread adds to each counter
    inside the block (the registry is added to as ever); another thread's
    adds are not in it. A tally opened inside another adds its counts to
    the outer one at its end."""
    outer = getattr(_TALLY, "counts", None)
    counts: dict[str, float] = {}
    _TALLY.counts = counts
    try:
        yield counts
    finally:
        _TALLY.counts = outer
        if outer is not None:
            for name, value in counts.items():
                outer[name] = outer.get(name, 0) + value


def gauge(name: str, value) -> None:
    """Set gauge ``name`` to ``value`` (last write wins)."""
    with _LOCK:
        _GAUGES[name] = value


def get(name: str, default: float = 0) -> float:
    """Current value of counter ``name`` (``default`` when never
    incremented)."""
    with _LOCK:
        return _COUNTERS.get(name, default)


def reset() -> None:
    """Clear the registry (tests; several runs in one process)."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()


def snapshot(rank: Optional[int] = None) -> dict:
    """The registry as one JSON-ready dict, stamped with the rank and both
    clocks (wall for cross-host alignment, monotonic for stall math)."""
    if rank is None:
        from poisson_tpu_torch.obs.trace import default_rank

        rank = default_rank()
    with _LOCK:
        return {
            "schema": SCHEMA,
            "rank": rank,
            "pid": os.getpid(),
            "at_unix": time.time(),
            "at_mono": time.monotonic(),
            "counters": dict(_COUNTERS),
            "gauges": dict(_GAUGES),
        }


def write_snapshot(path: str, rank: Optional[int] = None) -> None:
    """Atomically write :func:`snapshot` to ``path``. Best effort: a
    failing metrics disk never takes the solve down with it."""
    snap = snapshot(rank)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(snap, f, sort_keys=True, indent=1, default=str)
        os.replace(tmp, path)
    except OSError:
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass


def merge(snapshots: list[dict]) -> dict:
    """Merge per-rank snapshots: counters sum; gauges are kept per rank
    under ``gauges_by_rank`` (an aggregate would hide a straggler)."""
    counters: dict[str, float] = {}
    gauges_by_rank: dict[str, dict] = {}
    ranks = []
    for snap in snapshots:
        if not isinstance(snap, dict):
            continue
        rank = snap.get("rank", "?")
        ranks.append(rank)
        for name, val in (snap.get("counters") or {}).items():
            try:
                counters[name] = counters.get(name, 0) + val
            except TypeError:
                continue
        g = snap.get("gauges") or {}
        if g:
            gauges_by_rank[str(rank)] = dict(g)
    return {
        "schema": MERGED_SCHEMA,
        "ranks": ranks,
        "counters": counters,
        "gauges_by_rank": gauges_by_rank,
    }


def load_dir(trace_dir: str) -> dict:
    """Every ``metrics-rank*.json`` under ``trace_dir``, merged
    (:func:`merge`; no counters when there are none)."""
    snaps = []
    for fname in sorted(os.listdir(trace_dir)):
        if not (fname.startswith("metrics-rank")
                and fname.endswith(".json")):
            continue
        try:
            with open(os.path.join(trace_dir, fname)) as f:
                snaps.append(json.load(f))
        except (OSError, ValueError):
            continue
    return merge(snaps)
