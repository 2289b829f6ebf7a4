"""Command line: ``python -m poisson_tpu_torch M N`` and
``python -m poisson_tpu_torch solve-batched M N --batch B`` (the solve and
batched-solve subsets of ``poisson_tpu/cli.py``).

Backends: ``fused`` is the two-sweep canvas iteration with CUDA kernels A and
B; ``resident`` the whole solve in one launch of kernel R (grids within the
residency budget); ``ca`` the communication-avoiding pair iteration with
kernels C and D; ``fused-sharded`` and ``ca-sharded`` the same two
iterations on every shard of a ``--mesh PXxPY`` of cards, with the kernels'
sharded forms — these five are fp32 only, the counterparts of the JAX CLI's
``pallas``, ``pallas-resident``, ``pallas-ca``, ``pallas-sharded`` and
``pallas-ca-sharded``. ``torch`` is the plain PyTorch solver (fp64
Jacobi-PCG or fp32 on the scaled system) and ``sharded`` the same over the
mesh (the JAX CLI's ``xla`` and ``sharded``); ``--setup host|device``
builds the sharded solve's fields on the host in fp64 or on every shard's
device in the state's dtype.

``auto`` picks as the JAX CLI does (``poisson_tpu/cli.py:359-377``), with
the card in the TPU's place: with ``--mesh`` or more than one visible card,
``fused-sharded`` for fp32 with host setup, ``torch`` for ``--checkpoint``
with ``--setup device`` and no ``--mesh`` (the sharded checkpoint gathers
on the host), and ``sharded`` otherwise; on one card ``fused`` for fp32 and
``torch`` for fp64.

``--bm``/``--bn`` choose the fused path's canvas (``--bn`` a column-blocked
one, with kernels A′ and B′; a grid wide enough takes it on its own);
``--serial-reduce`` sums the reduction partials of every fused backend with
kernel S, in the JAX package's serial order; ``--checkpoint PATH`` runs the
solve in chunks of ``--chunk`` iterations, saving its state to PATH after
each and resuming from it, in the file format both packages read (every
backend but ``resident``, whose solve is one launch). ``--trace-dir`` and
``--metrics-out`` write the run's spans, events and counters (``obs``) in
the JAX package's formats.

``--preconditioner mg`` swaps the Jacobi diagonal for one geometric
V-cycle per iteration (``poisson_tpu_torch.mg``). It rides the plain
``torch`` solve only, as the JAX CLI's rides ``xla``: ``auto`` picks
``torch``, and every kernel or sharded backend refuses it. The hierarchy
is built before the first solve and reported as ``hierarchy_seconds``.

The "resilience" flags are the JAX CLI's: ``--resilient`` runs the
self-healing solve (``solvers.resilient``) on the ``torch`` backend (``auto``
picks it), ``--verify-every`` arms the in-loop integrity probe, and
``--heartbeat``/``--watchdog-timeout``, ``--stagnation-window`` and the
``--fault-*`` drills reach the chunk boundaries of the resilient solve or
of ``--checkpoint`` on ``torch`` or ``sharded``. A preempted run exits 75
(rerun to resume), a watchdog timeout 124. ``--stream-every`` streams
(k, ‖Δw‖) from the ``torch`` solve (``obs.stream``). Each flag refuses a
backend it cannot reach, in the JAX CLI's words with ``torch`` for
``xla``.

``--geometry SPEC`` (inline JSON or ``@file.json``) solves that domain
instead of the reference ellipse (``poisson_tpu_torch.geometry``) on the
``torch`` solve, which ``auto`` picks, as the JAX CLI's rides ``xla``; the
kernel and sharded backends, ``--checkpoint`` and ``--resilient`` refuse
it, and the record's ``l2_error`` is null (the ellipse's oracle does not
apply). ``python -m poisson_tpu_torch geometry SPEC`` prints a spec's
fingerprint, canonical form and canvas statistics, or an ASCII preview.

``--backend native`` runs the fp64 C++ oracle (``poisson_tpu_torch.native``,
the JAX CLI's ``native``) on the host with ``--threads`` OpenMP threads; it
refuses what the JAX CLI refuses with it, and ``--device`` changes nothing
for it. ``auto`` never picks it.

``--profile DIR`` (or ``POISSON_TPU_PROFILE_DIR``) captures a
``torch.profiler`` trace of one extra, untimed solve (``obs.profile``);
``--prom-out PATH`` writes the counters as a Prometheus textfile at exit and
``--metrics-port PORT`` serves them live on 127.0.0.1 (``obs.export``). The
report carries the backend's bytes model (``obs.costs.iteration_bytes``),
the bandwidth it achieved on a card and its share of the card's ceiling.

``solve-batched`` solves B right-hand sides of one operator together
(``solvers.batched``; see :func:`main_solve_batched`); ``top`` renders the
fleet scoreboard (``obs.forecast``) from a live endpoint, a textfile or a
metrics directory (see :func:`main_top`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from poisson_tpu_torch.config import Problem

BACKENDS = ("auto", "torch", "fused", "resident", "ca", "sharded",
            "fused-sharded", "ca-sharded", "native")
FP32_BACKENDS = ("fused", "resident", "ca", "fused-sharded", "ca-sharded")
SHARDED_BACKENDS = ("sharded", "fused-sharded", "ca-sharded")


def parse_mesh(text: str) -> tuple[int, int]:
    """``PXxPY`` → (px, py), both positive."""
    try:
        px, py = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh takes PXxPY, e.g. 2x2; got {text!r}") from None
    if px < 1 or py < 1:
        raise argparse.ArgumentTypeError(f"--mesh {text}: both sides >= 1")
    return px, py


def parse_geometry_arg(spec: str):
    """A ``--geometry`` value, inline JSON or ``@file.json``, as a
    normalized spec; a bad one exits like every other flag error."""
    label = spec if len(spec) < 60 else spec[:57] + "..."
    if spec.startswith("@"):
        try:
            with open(spec[1:]) as f:
                spec = f.read()
        except OSError as e:
            raise SystemExit(f"--geometry {label}: {e}")
    from poisson_tpu_torch.geometry import parse_geometry

    try:
        return parse_geometry(spec)
    except ValueError as e:
        raise SystemExit(f"--geometry {label}: {e}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m poisson_tpu_torch",
        description="Fictitious-domain Poisson PCG solve (PyTorch/CUDA port).",
    )
    p.add_argument("M", type=int, nargs="?", default=None,
                   help="grid cells in x (nodes: M+1)")
    p.add_argument("N", type=int, nargs="?", default=None,
                   help="grid cells in y (nodes: N+1)")
    p.add_argument("--M", type=int, default=None, dest="M_opt", metavar="M",
                   help="grid cells in x (same as positional M)")
    p.add_argument("--N", type=int, default=None, dest="N_opt", metavar="N",
                   help="grid cells in y (same as positional N)")
    p.add_argument("--delta", type=float, default=1e-6,
                   help="convergence threshold on ||w(k+1)-w(k)|| "
                        "(default 1e-6)")
    p.add_argument("--max-iter", type=int, default=None,
                   help="iteration cap (default (M-1)(N-1))")
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32", help="state precision (default float32)")
    p.add_argument("--unweighted-norm", action="store_true",
                   help="stage0's unweighted convergence norm")
    p.add_argument("--repeat", type=int, default=1,
                   help="timed solve repetitions after the first; report "
                        "the best")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default; raises without a card) or cpu, "
                        "which runs the kernels' plain versions")
    p.add_argument("--backend", choices=BACKENDS, default="auto",
                   help="auto: with --mesh or more than one card, "
                        "fused-sharded for float32 with --setup host, "
                        "torch for --checkpoint with --setup device and no "
                        "--mesh, else sharded; on one card fused for "
                        "float32, torch for float64. resident, ca and "
                        "ca-sharded are the other fp32 paths; torch and "
                        "sharded the plain solve, on one card or the mesh; "
                        "native the fp64 C++ oracle on the host CPU")
    p.add_argument("--mesh", type=parse_mesh, default=None,
                   metavar="PXxPY",
                   help="shard grid of the sharded backends (default: "
                        "near-square over the visible cards; one shard per "
                        "card on cuda, every shard on the CPU with "
                        "--device cpu)")
    p.add_argument("--setup", choices=("host", "device"), default="host",
                   help="sharded field setup: host fp64, or per shard on "
                        "its device in the state's dtype (--backend sharded "
                        "only)")
    p.add_argument("--threads", type=int, default=0,
                   help="OpenMP threads for --backend native (0 = runtime "
                        "default)")
    p.add_argument("--bm", type=int, default=None,
                   help="strip height of the fused or ca canvas (a "
                        "multiple of 8; default: one strip, or the JAX "
                        "strip height on a column-blocked canvas)")
    p.add_argument("--bn", type=int, default=None,
                   help="fused backend: column-block width (a multiple of "
                        "128), 0 forces full width; default: blocked only "
                        "for very wide grids")
    p.add_argument("--serial-reduce", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="fused, ca and the sharded backends: sum the "
                        "reduction partials with kernel S, ordered and "
                        "Kahan-compensated as the JAX package's serial "
                        "kernels (default off)")
    p.add_argument("--geometry", metavar="SPEC", default=None,
                   help="solve this domain instead of the reference "
                        "ellipse: a geometry-DSL JSON spec inline or "
                        "@file.json (poisson_tpu_torch.geometry; the "
                        "single-device torch backend). Preview specs with "
                        "`python -m poisson_tpu_torch geometry SPEC`")
    p.add_argument("--preconditioner", choices=("jacobi", "mg"),
                   default="jacobi",
                   help="M^-1 of the CG recurrence: jacobi (the diagonal; "
                        "default) or mg, one geometric V-cycle per "
                        "iteration (the torch backend only; the grid must "
                        "coarsen: even M and N)")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="every backend but resident: save the solver state "
                        "to PATH every --chunk iterations and resume from "
                        "it; removed on convergence, kept on a cap-hit")
    p.add_argument("--chunk", type=int, default=None,
                   help="iterations per checkpoint chunk (default 200; with "
                        "--fault-nan-at or --fault-bitflip-at K, min(200, K) "
                        "so the injection boundary lands before a fast "
                        "solve converges)")
    r = p.add_argument_group(
        "resilience",
        "divergence recovery, integrity probe, hardened checkpoints, "
        "watchdog, fault injection")
    r.add_argument("--resilient", action="store_true",
                   help="self-healing solve (--backend torch): in-loop "
                        "divergence detection plus restart-from-last-good-"
                        "iterate recovery with precision escalation")
    r.add_argument("--max-restarts", type=int, default=3,
                   help="recovery attempts before the resilient solve "
                        "fails loudly (default 3)")
    r.add_argument("--escalate-precision",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="allow the resilient solve to move up the "
                        "f32->f64 precision ladder after a repeated failure "
                        "at the same precision (default on)")
    r.add_argument("--stagnation-window", type=int, default=None,
                   metavar="ITERS",
                   help="in-loop stagnation detection: stop after this many "
                        "iterations without a new best ||dw|| (default: "
                        "200 with --resilient, off otherwise)")
    r.add_argument("--keep-last", type=int, default=2, metavar="K",
                   help="checkpoint generations to retain for corruption "
                        "fallback (default 2)")
    r.add_argument("--heartbeat", metavar="PATH", default=None,
                   help="write a JSON heartbeat file at every chunk "
                        "boundary (chunked solvers)")
    r.add_argument("--watchdog-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="abort with diagnostics if no chunk completes "
                        "within this window (the first chunk includes the "
                        "first call's setup: size generously)")
    r.add_argument("--verify-every", type=int, default=0, metavar="K",
                   help="in-loop integrity probe (--backend torch): every K "
                        "iterations (and on every convergence event) "
                        "recompute the true residual ||b-Aw|| and stop with "
                        "an 'integrity' verdict when it drifts from the "
                        "recurrence; with --resilient the recovery is a "
                        "verified restart. 0 (default): no probe")
    r.add_argument("--verify-tol", type=float, default=None,
                   help="relative drift tolerance for --verify-every "
                        "(default: dtype-aware, 1e-6 f64, 2e-5 f32)")
    r.add_argument("--fault-nan-at", type=int, default=None, metavar="K",
                   help="fault injection: poison the residual with a NaN at "
                        "the first chunk boundary at/after iteration K")
    r.add_argument("--fault-bitflip-at", default=None,
                   metavar="ITER[:BUF[:BIT]]",
                   help="fault injection: flip one storage bit of buffer "
                        "BUF (w/r/p/z/Ap; default w) at the first chunk "
                        "boundary at/after ITER (silent; only --verify-every "
                        "detects it. Drill: --resilient --verify-every 5 "
                        "--fault-bitflip-at 100)")
    r.add_argument("--fault-preempt-after", type=int, default=None,
                   metavar="CHUNKS",
                   help="fault injection: simulate preemption (exit code 75) "
                        "after this many chunks; the checkpoint survives for "
                        "the resumed run")
    r.add_argument("--fault-corrupt-checkpoint",
                   choices=("flip", "truncate", "zero"), default=None,
                   help="fault injection: damage the newest checkpoint "
                        "generation on disk before solving (exercises the "
                        "CRC fallback)")
    p.add_argument("--trace-dir", metavar="DIR", default=None,
                   help="write spans and events (Perfetto trace JSON, "
                        "JSONL) and a counters snapshot here, and the "
                        "streamed convergence curve with --stream-every")
    p.add_argument("--metrics-out", metavar="PATH", default=None,
                   help="write the counters/gauges snapshot here at exit")
    p.add_argument("--stream-every", type=int, default=0, metavar="K",
                   help="stream (iteration, ||dw||) out of the torch solve "
                        "every K iterations: live progress and a recorded "
                        "curve (0 = off, the default)")
    p.add_argument("--prom-out", metavar="PATH", default=None,
                   help="write the counters/gauges as a Prometheus text-"
                        "format snapshot to PATH at exit")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve a live GET /metrics endpoint on "
                        "127.0.0.1:PORT for the run's lifetime (0 = OS-"
                        "assigned, reported on the export.http_port gauge)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a torch.profiler trace of one extra, "
                        "untimed solve into DIR")
    p.add_argument("--json", action="store_true",
                   help="one JSON line instead of a table")
    return p


def visible_devices(device: str) -> int:
    """Cards a mesh may take: those visible for ``cuda``, one for ``cpu``."""
    import torch

    if device == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def pick_backend(backend: str, dtype: str, visible: int = 1,
                 mesh=None, checkpoint=None, setup: str = "host",
                 preconditioner: str = "jacobi",
                 resilient: bool = False, geometry=None) -> str:
    """The backend ``auto`` resolves to, by the JAX CLI's rule
    (``poisson_tpu/cli.py:340-377``) with the card in the TPU's place; an
    explicit backend is checked against the dtype and the mesh. With
    ``resilient`` ``auto`` is ``torch``, the single-device recovery
    driver's, as the JAX CLI's is ``xla``; so it is with a ``geometry``,
    whose canvases ride the plain solve. With ``preconditioner="mg"``
    ``auto`` is ``torch``, the plain solve the V-cycle rides; with a
    ``--mesh`` it is ``sharded``, which :func:`check_flags` then refuses
    (the mesh is not dropped)."""
    if backend == "auto" and (resilient or geometry):
        return "torch"
    if backend == "auto" and preconditioner == "mg":
        backend = "torch" if mesh is None else "sharded"
    if backend == "auto":
        if visible > 1 or mesh is not None:
            if dtype == "float32" and setup != "device":
                return "fused-sharded"
            if checkpoint and setup == "device" and mesh is None:
                return "torch"
            return "sharded"
        return "fused" if dtype == "float32" else "torch"
    if backend in FP32_BACKENDS and dtype != "float32":
        raise SystemExit(f"--backend {backend} is an fp32 path; use "
                         "--backend torch for float64")
    if mesh is not None and backend not in SHARDED_BACKENDS:
        raise SystemExit(f"--mesh shards the fp32 sharded backends "
                         f"({', '.join(SHARDED_BACKENDS)}), not {backend}")
    return backend


SERIAL_BACKENDS = ("fused", "ca", "fused-sharded", "ca-sharded")


def check_flags(args, backend: str) -> None:
    """Every geometry, reduction and checkpoint flag must reach the backend
    that was picked, as in the JAX CLI (``poisson_tpu/cli.py:538-544,
    2003-2058``); anything else raises."""
    if args.geometry is not None:
        if backend != "torch":
            raise SystemExit(
                f"--geometry drives the single-device torch solve "
                f"(resolved backend: {backend}); the kernel and sharded "
                f"paths bake the reference ellipse")
        if args.resilient or args.checkpoint:
            raise SystemExit(
                "--geometry rides the plain torch solve; the "
                "checkpointed/resilient CLI drivers are ellipse-only")
        if args.mesh is not None:
            raise SystemExit("--geometry drives the single-device torch "
                             "solve; drop --mesh")
    if args.bn is not None and backend != "fused":
        raise SystemExit(f"--bn applies to the single-device fused backend "
                         f"(resolved backend: {backend})")
    if args.bm is not None and backend not in ("fused", "ca"):
        raise SystemExit(f"--bm shapes the fused and ca canvases "
                         f"(resolved backend: {backend})")
    if args.serial_reduce is not None and backend not in SERIAL_BACKENDS:
        raise SystemExit(f"--serial-reduce/--no-serial-reduce applies to the "
                         f"fused backends ({', '.join(SERIAL_BACKENDS)}), "
                         f"not {backend}")
    if args.preconditioner == "mg":
        if backend != "torch":
            raise SystemExit(
                f"--preconditioner mg drives the single-device torch solve "
                f"body (resolved backend: {backend}); the CUDA kernels and "
                f"sharded meshes have no MG program yet — drop the flag or "
                f"use --backend torch")
        check_mg_grid(args)
    if args.setup == "device" and backend in ("fused-sharded", "ca-sharded"):
        raise SystemExit(f"--backend {backend} builds its canvases on the "
                         "host; use --backend sharded for --setup device")
    if args.checkpoint is None:
        return
    if backend == "resident":
        raise SystemExit(
            "--backend resident runs the whole solve in one kernel launch; "
            "there is no chunk boundary to checkpoint at — use --backend "
            "fused (the portable format resumes across backends)")
    if backend == "sharded" and args.setup == "device":
        raise SystemExit("--checkpoint gathers state on the host; use the "
                         "default --setup host")


def resolve_chunk(args) -> None:
    """The JAX CLI's ``--chunk`` default: 200, or the smallest injection
    iteration when a NaN or bitflip drill is armed (so that the injection's
    boundary lands before a fast solve converges)."""
    bitflip_at = None
    if args.fault_bitflip_at:
        from poisson_tpu_torch.testing.faults import parse_bitflip_spec

        try:
            bitflip_at, _, _ = parse_bitflip_spec(args.fault_bitflip_at)
        except ValueError as e:
            raise SystemExit(f"--fault-bitflip-at: {e}") from None
    if args.chunk is None:
        inject_ats = [k for k in (args.fault_nan_at, bitflip_at)
                      if k is not None]
        args.chunk = (min(200, max(1, min(inject_ats)))
                      if inject_ats else 200)
    elif args.chunk < 1:
        raise SystemExit(f"--chunk must be >= 1, got {args.chunk}")
    if args.verify_every < 0:
        raise SystemExit(f"--verify-every must be >= 0, "
                         f"got {args.verify_every}")
    if args.verify_tol is not None and not args.verify_every:
        raise SystemExit("--verify-tol tunes the integrity probe; pass "
                         "--verify-every K to arm it")
    if args.stream_every < 0:
        raise SystemExit(f"--stream-every must be >= 0, "
                         f"got {args.stream_every}")


def check_resilience(args, backend: str) -> None:
    """The JAX CLI's guards on the resilience and stream flags
    (``poisson_tpu/cli.py:2081-2127``), with ``torch`` for ``xla`` and the
    port's kernel backends for the pallas ones: a flag that cannot reach
    the resolved backend is refused, never dropped."""
    if args.resilient and backend != "torch":
        raise SystemExit(
            f"--resilient drives the single-device torch solve "
            f"(resolved backend: {backend}); the sharded/fused chunked "
            f"paths take the detection, watchdog and "
            f"checkpoint-hardening flags via --checkpoint")
    hookable = args.resilient or (
        args.checkpoint and backend in ("torch", "sharded"))
    if (args.fault_nan_at is not None
            or args.fault_preempt_after is not None) and not hookable:
        raise SystemExit(
            "--fault-nan-at/--fault-preempt-after inject at chunk "
            "boundaries; use --resilient, or --checkpoint with "
            f"--backend torch or sharded (resolved backend: {backend})")
    if args.fault_bitflip_at is not None and not (
            args.resilient or (args.checkpoint and backend == "torch")):
        raise SystemExit(
            "--fault-bitflip-at injects at chunk boundaries of the "
            "single-device drivers; use --resilient, or --checkpoint "
            f"with --backend torch (resolved backend: {backend})")
    if args.verify_every and backend != "torch":
        raise SystemExit(
            "--verify-every arms the in-loop integrity probe in the "
            "torch solvers; use --backend torch (resolved "
            f"backend: {backend})")
    if (args.heartbeat or args.watchdog_timeout is not None) \
            and not hookable:
        raise SystemExit(
            "--heartbeat/--watchdog-timeout guard the chunked torch "
            "drivers; use --resilient, or --checkpoint with "
            f"--backend torch or sharded (resolved backend: {backend})")
    if args.stream_every and backend != "torch":
        raise SystemExit(
            "--stream-every streams (k, ||dw||) from the torch solve "
            f"loop; use --backend torch (resolved backend: {backend})")
    if args.stagnation_window is not None and not hookable:
        raise SystemExit(
            "--stagnation-window needs an in-loop-detecting driver; "
            "use --resilient, or --checkpoint with --backend torch or "
            f"sharded (resolved backend: {backend})")
    if args.keep_last != 2 and not args.checkpoint:
        raise SystemExit("--keep-last shapes checkpoint retention; "
                         "it needs --checkpoint")
    if args.keep_last < 1:
        raise SystemExit(f"--keep-last must be >= 1, got {args.keep_last}")


def corrupt_checkpoint(args) -> None:
    """``--fault-corrupt-checkpoint``: damage the newest generation."""
    import os

    if not args.checkpoint:
        raise SystemExit("--fault-corrupt-checkpoint damages the "
                         "--checkpoint file; pass --checkpoint PATH")
    if not os.path.exists(args.checkpoint):
        raise SystemExit(
            f"--fault-corrupt-checkpoint: no checkpoint at "
            f"{args.checkpoint} to corrupt (run once with "
            f"--checkpoint first)")
    from poisson_tpu_torch.testing.faults import corrupt_file

    corrupt_file(args.checkpoint, args.fault_corrupt_checkpoint)
    print(f"fault injection: corrupted ({args.fault_corrupt_checkpoint}) "
          f"checkpoint {args.checkpoint}", file=sys.stderr)


def resilience_kit(args):
    """The watchdog and the fault-injection hook from the flags (None,
    None when unused), as the JAX CLI's ``_resilience_kit``."""
    watchdog = None
    if args.heartbeat or args.watchdog_timeout is not None:
        from poisson_tpu_torch.parallel.watchdog import Watchdog

        watchdog = Watchdog(heartbeat_path=args.heartbeat,
                            timeout=args.watchdog_timeout)
    hooks = []
    if args.fault_nan_at is not None or args.fault_preempt_after is not None:
        from poisson_tpu_torch.testing.faults import FaultPlan, chunk_hook

        hooks.append(chunk_hook(FaultPlan(
            nan_at_iteration=args.fault_nan_at,
            preempt_after_chunks=args.fault_preempt_after)))
    if args.fault_bitflip_at:
        from poisson_tpu_torch.testing.faults import (
            bitflip_hook,
            parse_bitflip_spec,
        )

        it, buf, bit = parse_bitflip_spec(args.fault_bitflip_at)
        hooks.append(bitflip_hook(it, buffer=buf, bit=bit))
    if not hooks:
        return watchdog, None
    if len(hooks) == 1:
        return watchdog, hooks[0]

    def on_chunk(state, chunks_done):
        # Faults compose: each hook sees the previous one's replacement.
        changed = None
        for hook in hooks:
            new = hook(changed if changed is not None else state,
                       chunks_done)
            if new is not None:
                changed = new
        return changed

    return watchdog, on_chunk


def check_mg_grid(args) -> None:
    """An MG solve's grid must coarsen at least once."""
    from poisson_tpu_torch.mg.hierarchy import validate_mg_problem

    try:
        validate_mg_problem(Problem(M=args.M, N=args.N))
    except ValueError as e:
        raise SystemExit(f"--preconditioner mg: {e}") from None


def build_mesh(args, visible: int):
    """The mesh of a sharded backend: ``--mesh`` or the near-square grid
    over the visible cards; shard s on card s (a mesh larger than the
    visible cards is refused), or every shard on the CPU."""
    from poisson_tpu_torch.parallel.mesh import (
        choose_process_grid,
        make_solver_mesh,
    )

    px, py = args.mesh if args.mesh is not None else choose_process_grid(
        max(visible, 1))
    n = px * py
    if args.device == "cpu":
        return make_solver_mesh(["cpu"] * n, grid=(px, py))
    if n > visible:
        raise SystemExit(f"--mesh {px}x{py} needs {n} cards; {visible} "
                         "visible (--device cpu puts every shard on the CPU)")
    return make_solver_mesh([f"cuda:{i}" for i in range(n)], grid=(px, py))


def _grid(args) -> None:
    """Reconcile the positional and flag grid forms: exactly one per axis."""
    for axis in ("M", "N"):
        pos, opt = getattr(args, axis), getattr(args, f"{axis}_opt")
        if pos is not None and opt is not None:
            raise SystemExit(f"give {axis} either positionally or as "
                             f"--{axis}, not both")
        if pos is None and opt is None:
            raise SystemExit(f"missing grid size {axis} (positional or "
                             f"--{axis})")
        setattr(args, axis, pos if pos is not None else opt)


def check_native(args) -> None:
    """The JAX CLI's refusals with ``--backend native``
    (``poisson_tpu/cli.py:1955-2011``), in its words with the port's
    backends and kernels for its JAX and pallas ones."""
    resilience_flags = (
        args.resilient or args.heartbeat
        or args.watchdog_timeout is not None
        or args.stagnation_window is not None or args.keep_last != 2
        or args.fault_nan_at is not None
        or args.fault_preempt_after is not None
        or args.fault_corrupt_checkpoint is not None
        or args.fault_bitflip_at is not None
        or args.verify_every != 0)
    if args.checkpoint:
        raise SystemExit("--checkpoint is supported on the torch and CUDA "
                         "backends, not native")
    if resilience_flags:
        raise SystemExit("the resilience/fault-injection flags drive the "
                         "torch chunked solvers; not available with "
                         "--backend native")
    if args.geometry is not None:
        raise SystemExit("--geometry drives the single-device torch solve; "
                         "the native C++ path bakes the reference ellipse")
    if args.preconditioner == "mg":
        raise SystemExit("--preconditioner mg drives the torch solve body "
                         "(poisson_tpu_torch.mg); not available with "
                         "--backend native")
    if args.stream_every:
        raise SystemExit("--stream-every streams from the torch solve loop; "
                         "not available with --backend native")
    if args.profile:
        raise SystemExit("--profile captures a torch.profiler device trace; "
                         "not available with --backend native")
    if (args.bm is not None or args.bn is not None
            or args.serial_reduce is not None):
        raise SystemExit("--bm/--bn/--serial-reduce shape the CUDA kernels; "
                         "not available with --backend native")


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "solve-batched":
        return main_solve_batched(argv[1:])
    if argv and argv[0] == "geometry":
        return main_geometry(argv[1:])
    if argv and argv[0] == "top":
        return main_top(argv[1:])
    args = build_parser().parse_args(argv)
    _grid(args)
    if args.repeat < 1:
        raise SystemExit(f"--repeat must be >= 1, got {args.repeat}")
    resolve_chunk(args)
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.obs import profile as obs_profile

    if (args.trace_dir or args.metrics_out or args.stream_every
            or args.prom_out or args.metrics_port is not None):
        obs.configure(trace_dir=args.trace_dir, metrics_path=args.metrics_out,
                      stream_every=args.stream_every,
                      stream_live=sys.stderr.isatty() and not args.json,
                      prom_path=args.prom_out,
                      metrics_port=args.metrics_port)
    # Env-driven capture directory; an explicit --profile DIR wins for the
    # CLI's own capture.
    obs_profile.configure_from_env()
    problem = Problem(M=args.M, N=args.N, delta=args.delta,
                      max_iter=args.max_iter,
                      weighted_norm=not args.unweighted_norm)
    if args.backend == "native":
        check_native(args)
        return _solve_native(args, problem)
    visible = visible_devices(args.device)
    backend = pick_backend(args.backend, args.dtype, visible, args.mesh,
                           args.checkpoint, args.setup, args.preconditioner,
                           args.resilient, args.geometry)

    check_flags(args, backend)
    check_resilience(args, backend)
    if args.fault_corrupt_checkpoint is not None:
        corrupt_checkpoint(args)
    watchdog, on_chunk = resilience_kit(args)
    try:
        return _solve(args, problem, backend, visible, watchdog, on_chunk)
    except KeyboardInterrupt:
        # The chunked drivers turn a watchdog interrupt into SolveTimeout;
        # one that arrives here raw gets the same exit.
        if watchdog is not None and watchdog.fired:
            print("watchdog timeout: solve aborted (diagnostics next to "
                  "the heartbeat file)", file=sys.stderr)
            obs.finalize()
            return 124
        raise
    except Exception as e:
        from poisson_tpu_torch.parallel.watchdog import SolveTimeout
        from poisson_tpu_torch.testing.faults import PreemptionInjected

        if isinstance(e, SolveTimeout):
            print(f"{e}", file=sys.stderr)
            obs.finalize()
            return 124
        if on_chunk is not None and isinstance(e, PreemptionInjected):
            print(f"{e}; checkpoint retained at {args.checkpoint}"
                  if args.checkpoint else str(e), file=sys.stderr)
            obs.finalize()
            return 75   # EX_TEMPFAIL: rerun to resume
        raise


def _emit(args, report, profiled: bool = False) -> int:
    """The report as an event, the artifacts flushed, the line printed."""
    from poisson_tpu_torch import obs

    # The report is itself an event, so a trace directory alone holds the
    # run's outcome (the JAX CLI's "solve.report").
    obs.event("solve.report", **dataclasses.asdict(report))
    obs.finalize()
    print(report.json_line() if args.json else report.table())
    if profiled and args.profile and not args.json:
        print(f"profiler trace written to {args.profile}")
    return 0


def _solve_native(args, problem: Problem) -> int:
    """``--backend native``: the fp64 C++ oracle on the host, first solve
    and best of ``--repeat``, as the JAX CLI's ``_run_native``."""
    from poisson_tpu_torch.analysis import l2_error_host
    from poisson_tpu_torch.native import build, native_solve
    from poisson_tpu_torch.utils.timing import (
        PhaseTimer,
        SolveReport,
        count_solve,
        mlups,
    )

    build()     # the one-time g++ compile stays out of the timed phases
    timer = PhaseTimer("cpu")
    with timer.phase("first_solve"):
        result = native_solve(problem, num_threads=args.threads)
    first = best = timer.times["first_solve"]
    for _ in range(args.repeat - 1):
        t0 = time.perf_counter()
        result = native_solve(problem, num_threads=args.threads)
        best = min(best, time.perf_counter() - t0)
    iters = result.iterations
    report = SolveReport(
        M=problem.M, N=problem.N, iterations=iters, solve_seconds=best,
        first_solve_seconds=first, us_per_iter=best / max(1, iters) * 1e6,
        mlups=mlups(problem, iters, best), final_diff=result.diff,
        dtype="float64", backend="native", device="cpu", device_kind="cpu",
        l2_error=l2_error_host(problem, result.w), compile_seconds=0.0,
        devices=0)
    # The oracle tracks no verdict: counted "untracked", as in JAX.
    count_solve(result, compile_seconds=0.0, solve_seconds=best)
    return _emit(args, report)


def _solve(args, problem: Problem, backend: str, visible: int, watchdog,
           on_chunk) -> int:
    """Run the resolved backend's solve, time it, and print the report."""
    import torch

    from poisson_tpu_torch.analysis import l2_error_host
    from poisson_tpu_torch.obs import profile as obs_profile
    from poisson_tpu_torch.obs.costs import (
        iteration_bytes,
        mg_vcycle_cost,
        roofline_summary,
    )
    from poisson_tpu_torch.ops.ca_cg import (
        ca_cg_solve,
        ca_cg_solve_checkpointed,
    )
    from poisson_tpu_torch.ops.fused_cg import (
        canvas_spec,
        fused_cg_solve,
        fused_cg_solve_checkpointed,
    )
    from poisson_tpu_torch.ops.resident import (
        refuse_above_budget,
        resident_cg_solve,
    )
    from poisson_tpu_torch.parallel.fused_sharded import (
        fused_cg_solve_sharded,
        fused_cg_solve_sharded_checkpointed,
    )
    from poisson_tpu_torch.parallel.ca_sharded import (
        ca_cg_solve_sharded,
        ca_cg_solve_sharded_checkpointed,
    )
    from poisson_tpu_torch.parallel.checkpoint_sharded import (
        pcg_solve_sharded_checkpointed,
    )
    from poisson_tpu_torch.parallel.pcg_sharded import pcg_solve_sharded
    from poisson_tpu_torch.solvers.checkpoint import pcg_solve_checkpointed
    from poisson_tpu_torch.solvers.pcg import (
        FLAG_CONVERGED,
        FLAG_NAMES,
        FLAG_NONE,
        pcg_solve,
    )
    from poisson_tpu_torch.utils.platform import device_name, resolve_device
    from poisson_tpu_torch.utils.timing import (
        PhaseTimer,
        SolveReport,
        count_solve,
        mlups,
    )

    if backend == "resident":
        try:
            refuse_above_budget(problem)
        except ValueError as e:
            raise SystemExit(f"--backend resident: {e}") from None
    device = resolve_device(args.device)
    geometry = parse_geometry_arg(args.geometry) if args.geometry else None
    serial = bool(args.serial_reduce)
    ckpt = dict(chunk=args.chunk, keep_last=args.keep_last)
    # (canvas of the solve, the solve) of each single-device kernel path.
    solvers = {
        "fused": (lambda: canvas_spec(problem, args.bm, args.bn), lambda: (
            fused_cg_solve_checkpointed(
                problem, args.checkpoint, bm=args.bm, bn=args.bn,
                serial=serial, device=device, **ckpt)
            if args.checkpoint else
            fused_cg_solve(problem, device=device, bm=args.bm, bn=args.bn,
                           serial=serial))),
        "resident": (lambda: canvas_spec(problem, bn=0),
                     lambda: resident_cg_solve(problem, device=device)),
        "ca": (lambda: canvas_spec(problem, args.bm, 0), lambda: (
            ca_cg_solve_checkpointed(problem, args.checkpoint, bm=args.bm,
                                     serial=serial, device=device, **ckpt)
            if args.checkpoint else
            ca_cg_solve(problem, device=device, bm=args.bm,
                        serial=serial))),
    }
    # (one-shot solve, checkpointed solve) of each sharded kernel path.
    sharded = {"fused-sharded": (fused_cg_solve_sharded,
                                 fused_cg_solve_sharded_checkpointed),
               "ca-sharded": (ca_cg_solve_sharded,
                              ca_cg_solve_sharded_checkpointed)}
    mesh = None
    if backend in solvers:
        canvas, run = solvers[backend]
        try:
            canvas()
        except ValueError as e:
            raise SystemExit(f"--backend {backend}: {e}") from None
    elif backend in sharded:
        mesh = build_mesh(args, visible)
        solve, solve_ck = sharded[backend]
        run = ((lambda: solve_ck(problem, mesh, args.checkpoint,
                                 serial=serial, **ckpt))
               if args.checkpoint else
               (lambda: solve(problem, mesh, serial=serial)))
    elif backend == "sharded":
        mesh = build_mesh(args, visible)
        run = ((lambda: pcg_solve_sharded_checkpointed(
                    problem, mesh, args.checkpoint, dtype=args.dtype,
                    stagnation_window=args.stagnation_window or 0,
                    watchdog=watchdog, on_chunk=on_chunk, **ckpt))
               if args.checkpoint else
               (lambda: pcg_solve_sharded(problem, mesh, dtype=args.dtype,
                                          setup=args.setup)))
    elif args.resilient:
        from poisson_tpu_torch.solvers.resilient import (
            RecoveryPolicy,
            pcg_solve_resilient,
        )

        policy = RecoveryPolicy(
            max_restarts=args.max_restarts, escalate=args.escalate_precision,
            stagnation_window=(200 if args.stagnation_window is None
                               else args.stagnation_window))
        run = lambda: pcg_solve_resilient(
            problem, dtype=args.dtype, chunk=args.chunk, policy=policy,
            checkpoint_path=args.checkpoint, keep_last=args.keep_last,
            stream_every=args.stream_every, watchdog=watchdog,
            on_chunk=on_chunk, verify_every=args.verify_every,
            verify_tol=args.verify_tol, preconditioner=args.preconditioner,
            device=device)
    elif args.checkpoint:
        run = lambda: pcg_solve_checkpointed(
            problem, args.checkpoint, dtype=args.dtype, device=device,
            preconditioner=args.preconditioner,
            stagnation_window=args.stagnation_window or 0,
            stream_every=args.stream_every, watchdog=watchdog,
            on_chunk=on_chunk, verify_every=args.verify_every,
            verify_tol=args.verify_tol, **ckpt)
    else:
        run = lambda: pcg_solve(problem, dtype=args.dtype, device=device,
                                geometry=geometry,
                                preconditioner=args.preconditioner,
                                stream_every=args.stream_every,
                                verify_every=args.verify_every,
                                verify_tol=args.verify_tol)

    dtype_bytes = getattr(torch, args.dtype).itemsize
    bytes_per_iter = iteration_bytes(
        problem, backend, args.bm, args.bn,
        None if mesh is None else (mesh.px, mesh.py), dtype_bytes)
    if bytes_per_iter is not None and args.preconditioner == "mg":
        bytes_per_iter += mg_vcycle_cost(problem.M, problem.N,
                                         dtype_bytes)["bytes"]

    # A checkpointed solve resumes from its own file, so a timed re-run of
    # a capped one would run no iteration: it runs once, and that is timed.
    repeats = 0 if args.checkpoint else args.repeat
    timer = PhaseTimer(device)
    if args.preconditioner == "mg":
        # The host fp64 hierarchy (dense coarsest inverse included) is a
        # one-time cost per problem: timed on its own, never in a solve.
        from poisson_tpu_torch.mg.hierarchy import device_hierarchy
        from poisson_tpu_torch.solvers.pcg import resolve_scaled

        with timer.phase("mg_hierarchy"):
            device_hierarchy(problem, args.dtype,
                             resolve_scaled(None, args.dtype),
                             geometry=geometry, device=device)
    with timer.phase("first_solve"):   # builds kernels and canvases
        result = run()
    # Recovery provenance can land on any run (an injected fault fires once
    # per hook, usually in the first): keep it for the report.
    recovered = (result.restarts, result.recovery_history)
    if int(result.flag) not in (FLAG_NONE, FLAG_CONVERGED):
        # A failed solve is reported as it ran: a timed re-run could
        # resume from the last good generation and mask the verdict.
        repeats = 0
    for i in range(repeats):
        with timer.phase(f"solve_{i}"):
            result = run()
    if recovered[0] and not result.restarts:
        result = result._replace(restarts=recovered[0],
                                 recovery_history=recovered[1])
    first = timer.times["first_solve"]
    best = min((timer.times[f"solve_{i}"] for i in range(repeats)),
               default=first)

    profiled = bool(args.profile) or obs_profile.enabled()
    if profiled:
        # One extra, untimed solve under the profiler.
        with obs_profile.capture("cli.solve", profile_dir=args.profile):
            run()

    iters = int(result.iterations)
    flag = int(result.flag)
    stopped = None if flag in (FLAG_NONE, FLAG_CONVERGED) else FLAG_NAMES[flag]
    devices = 1 if mesh is None else mesh.size
    roofline = {}
    # A device rate only from a device run.
    if device.type == "cuda" and bytes_per_iter is not None:
        roofline = roofline_summary(
            problem, backend, dtype_bytes, iters, best,
            device_name(device), devices, bytes_per_iter=bytes_per_iter)
    report = SolveReport(
        M=problem.M, N=problem.N, iterations=iters, solve_seconds=best,
        first_solve_seconds=first,
        us_per_iter=best / max(1, iters) * 1e6,
        mlups=mlups(problem, iters, best), final_diff=float(result.diff),
        dtype=args.dtype, backend=backend, device=device.type,
        device_kind=device_name(device),
        # The analytic control is the ellipse's: another domain has its
        # own manufactured gate (geometry.manufactured), not this error.
        l2_error=(None if args.geometry
                  else l2_error_host(problem, result.w)),
        bytes_per_iter_model=bytes_per_iter,
        achieved_gbps=roofline.get("achieved_gbps"),
        roofline_fraction=roofline.get("fraction"),
        compile_seconds=first - best, devices=devices,
        stopped=stopped,
        mesh=None if mesh is None else (mesh.px, mesh.py),
        hierarchy_seconds=timer.times.get("mg_hierarchy"),
        restarts=int(result.restarts) if result.restarts else None,
        recovery=(tuple(result.recovery_history) if result.restarts
                  else None),
    )
    count_solve(result, compile_seconds=first - best, solve_seconds=best)
    return _emit(args, report, profiled)


def build_batched_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m poisson_tpu_torch solve-batched",
        description="Batched multi-RHS PCG: B Poisson problems of one "
                    "operator stepped together (solvers.batched).")
    p.add_argument("M", type=int, help="grid cells in x (nodes: M+1)")
    p.add_argument("N", type=int, help="grid cells in y (nodes: N+1)")
    p.add_argument("--batch", type=int, required=True, metavar="B",
                   help="batch size: right-hand sides solved together")
    p.add_argument("--bucket", type=int, default=None,
                   help="pad the batch to this size with zero members "
                        "(default: run at --batch; the record's bucket is "
                        "the power-of-two ladder's, as the JAX CLI's)")
    p.add_argument("--delta", type=float, default=1e-6,
                   help="convergence threshold on ||w(k+1)-w(k)|| "
                        "(default 1e-6)")
    p.add_argument("--max-iter", type=int, default=None,
                   help="iteration cap (default (M-1)(N-1))")
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32", help="state precision (default "
                                           "float32, as the JAX CLI's)")
    p.add_argument("--vary-rhs", action="store_true",
                   help="give member i the RHS gate 1+i/B, so members "
                        "converge at different iterations")
    p.add_argument("--mesh", type=parse_mesh, default=None,
                   metavar="PXxPY",
                   help="run the bucket on a PXxPY mesh of shards "
                        "(members whole-grid, the mesh splits the grid; "
                        "one shard per card on cuda, every shard on the "
                        "CPU with --device cpu)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--repeat", type=int, default=1,
                   help="timed batched-solve repetitions; report the best")
    p.add_argument("--compare-sequential", action="store_true",
                   help="also run the B members as sequential solves and "
                        "report the speedup and per-member count parity")
    p.add_argument("--trace-dir", metavar="DIR", default=None,
                   help="write spans, events and counters here")
    p.add_argument("--metrics-out", metavar="PATH", default=None,
                   help="write the counters/gauges snapshot here at exit")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a torch.profiler trace of one extra, "
                        "untimed batched solve into DIR (also "
                        "POISSON_TPU_PROFILE_DIR)")
    p.add_argument("--json", action="store_true",
                   help="one JSON line instead of a table")
    p.add_argument("--geometry", metavar="SPEC", action="append",
                   default=None,
                   help="geometry-DSL JSON (inline or @file.json); "
                        "repeatable: members take the specs round-robin "
                        "and different domains solve in one batch "
                        "(poisson_tpu_torch.geometry; no --mesh, no mg)")
    p.add_argument("--verify-every", type=int, default=0, metavar="K",
                   help="per-member in-loop integrity probe every K "
                        "iterations (0 = off; not on a --mesh)")
    p.add_argument("--verify-tol", type=float, default=None,
                   help="relative drift tolerance for --verify-every "
                        "(default: dtype-aware)")
    p.add_argument("--preconditioner", choices=("jacobi", "mg"),
                   default="jacobi",
                   help="per-member M^-1: jacobi (default) or mg, one "
                        "geometric V-cycle per iteration on one shared "
                        "hierarchy (the grid must coarsen: even M and N; "
                        "no --mesh, no --geometry)")
    return p


def main_solve_batched(argv) -> int:
    """``solve-batched``: a table, or one JSON record (``--json``) with the
    JAX CLI's keys. ``batch_seconds`` is the best of ``--repeat`` timed
    solves; ``compile_seconds`` is the first call's extra time over it
    (the port compiles nothing: it is the first call's setup and, on the
    card, the warm-up of its libraries and allocator)."""
    args = build_batched_parser().parse_args(argv)
    if args.batch < 1:
        raise SystemExit(f"--batch must be >= 1, got {args.batch}")
    if args.repeat < 1:
        raise SystemExit(f"--repeat must be >= 1, got {args.repeat}")
    from poisson_tpu_torch.solvers.batched import bucket_size, solve_batched

    B = args.batch
    geometries = None
    if args.geometry:
        specs = [parse_geometry_arg(g) for g in args.geometry]
        geometries = [specs[i % len(specs)] for i in range(B)]
    if args.preconditioner == "mg":
        # The JAX CLI's refusals, then its grid check.
        if args.geometry:
            raise SystemExit(
                "--preconditioner mg does not co-batch --geometry "
                "members yet (each would need its own level hierarchy); "
                "drop one of the two")
        if args.mesh is not None:
            raise SystemExit(
                "--preconditioner mg needs a sharded hierarchy, which no "
                "mesh program has yet; dispatch MG batches on a single "
                "device (drop --mesh)")
        check_mg_grid(args)
    if geometries is not None and args.mesh is not None:
        raise SystemExit(
            "--geometry members carry their own canvases, which no mesh "
            "program shards yet; drop --mesh")
    if args.verify_every < 0:
        raise SystemExit(f"--verify-every must be >= 0, "
                         f"got {args.verify_every}")
    if args.verify_tol is not None and not args.verify_every:
        raise SystemExit("--verify-tol tunes the integrity probe; pass "
                         "--verify-every K to arm it")
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.obs import profile as obs_profile
    from poisson_tpu_torch.solvers.pcg import (
        FLAG_CONVERGED,
        FLAG_NAMES,
        pcg_solve,
    )
    from poisson_tpu_torch.utils.platform import resolve_device
    from poisson_tpu_torch.utils.timing import PhaseTimer, fence

    if args.trace_dir or args.metrics_out:
        obs.configure(trace_dir=args.trace_dir, metrics_path=args.metrics_out)
    obs_profile.configure_from_env()
    problem = Problem(M=args.M, N=args.N, delta=args.delta,
                      max_iter=args.max_iter)
    gates = ([1.0 + i / B for i in range(B)] if args.vary_rhs
             else [1.0] * B)
    device = resolve_device(args.device)
    where = dict(device=device)
    if args.mesh is not None:
        mesh = build_mesh(args, visible_devices(args.device))
        device, where = mesh.lead, dict(mesh=mesh)
    run = lambda: solve_batched(problem, rhs_gates=gates, dtype=args.dtype,
                                bucket=args.bucket, geometries=geometries,
                                verify_every=args.verify_every,
                                verify_tol=args.verify_tol,
                                preconditioner=args.preconditioner, **where)
    timer = PhaseTimer(device)
    with timer.phase("compile_and_first_solve"):
        result = run()
    best = None
    with obs.span("timed_batched_solves", fence=False, repeat=args.repeat):
        for _ in range(args.repeat):
            fence(device)
            t0 = time.perf_counter()
            result = run()
            fence(device)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)

    iters = result.iterations.tolist()
    flags = result.flag.tolist()
    converged = sum(1 for f in flags if f == FLAG_CONVERGED)
    bucket = args.bucket if args.bucket is not None else bucket_size(B)
    record = {
        "M": problem.M, "N": problem.N, "batch": B, "bucket": bucket,
        "dtype": args.dtype,
        "batch_seconds": best,
        "solves_per_sec": B / best,
        "compile_seconds": timer.times["compile_and_first_solve"] - best,
        "max_iterations": int(result.max_iterations),
        "iterations": iters,
        "converged": converged,
        "flags": sorted({FLAG_NAMES.get(f, str(f)) for f in flags}),
    }
    if args.verify_every:
        record["verify_every"] = args.verify_every
    if args.preconditioner != "jacobi":
        record["preconditioner"] = args.preconditioner
    if geometries is not None:
        record["geometry_mix"] = len(args.geometry)
        record["geometries"] = sorted({g.fingerprint for g in geometries})
    if args.compare_sequential:
        geos = geometries or [None] * B
        seq = lambda g, geo: pcg_solve(problem, dtype=args.dtype,
                                       rhs_gate=g, geometry=geo,
                                       device=device,
                                       preconditioner=args.preconditioner)
        seq(gates[0], geos[0])     # first-call setup outside the timing
        with obs.span("timed_sequential_solves", fence=False, batch=B):
            fence(device)
            t0 = time.perf_counter()
            seq_iters = [int(seq(g, geo).iterations)
                         for g, geo in zip(gates, geos)]
            seq_seconds = time.perf_counter() - t0
        record["sequential_seconds"] = seq_seconds
        record["speedup_vs_sequential"] = seq_seconds / best
        record["iterations_match_sequential"] = seq_iters == iters

    if args.profile or obs_profile.enabled():
        with obs_profile.capture("solve_batched", profile_dir=args.profile):
            run()
    obs.event("solve_batched.report", **record)
    obs.gauge("batched.solves_per_sec", record["solves_per_sec"])
    obs.finalize()
    if args.json:
        print(json.dumps(record))
        return 0
    lo, hi = min(iters), max(iters)
    print(f"M={problem.M}, N={problem.N} | batch={B} (bucket {bucket}) "
          f"| Time={best:.4f} s | {record['solves_per_sec']:.2f} solves/s")
    print(f"  first call: {record['compile_seconds']:.2f} s   "
          f"dtype: {record['dtype']}   iterations: "
          + (f"{lo}" if lo == hi else f"{lo}..{hi} (max {hi})")
          + f"   converged: {converged}/{B}")
    if args.compare_sequential:
        match = ("identical to sequential"
                 if record["iterations_match_sequential"]
                 else "MISMATCH vs sequential")
        print(f"  vs sequential: {record['speedup_vs_sequential']:.2f}x "
              f"({seq_seconds:.4f} s for {B} solves; per-member "
              f"iteration counts {match})")
    return 0


def build_top_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m poisson_tpu_torch top",
        description="One-screen fleet scoreboard (obs.forecast), from a "
                    "live Prometheus endpoint, a textfile export, or a "
                    "telemetry directory (a dead process's "
                    "metrics-rank*.json snapshots).")
    p.add_argument("--endpoint", metavar="URL",
                   help="live Prometheus endpoint "
                        "(obs.export.start_http_server), e.g. "
                        "http://127.0.0.1:9464/metrics")
    p.add_argument("--textfile", metavar="PATH",
                   help="Prometheus textfile (--prom-out, "
                        "obs.export.write_textfile)")
    p.add_argument("--metrics-dir", metavar="DIR",
                   help="telemetry directory with metrics-rank*.json "
                        "snapshots (--trace-dir)")
    p.add_argument("--watch", type=float, default=0.0, metavar="N",
                   help="re-render every N seconds until interrupted "
                        "(default: render once)")
    p.add_argument("--json", action="store_true",
                   help="one JSON object per render instead of the screen")
    return p


def main_top(argv) -> int:
    """``top``: the JAX CLI's scoreboard (``poisson_tpu/cli.py:1453``) over
    the port's readers; stdlib only, no card needed."""
    args = build_top_parser().parse_args(argv)
    sources = [s for s in (args.endpoint, args.textfile,
                           args.metrics_dir) if s]
    if len(sources) != 1:
        print("top needs exactly one of --endpoint / --textfile / "
              "--metrics-dir", file=sys.stderr)
        return 2
    from poisson_tpu_torch.obs import export, forecast, metrics

    def read_metrics() -> dict:
        if args.endpoint:
            import urllib.request

            with urllib.request.urlopen(args.endpoint, timeout=5) as r:
                return export.parse_text(r.read().decode("utf-8",
                                                         "replace"))
        if args.textfile:
            with open(args.textfile, encoding="utf-8") as f:
                return export.parse_text(f.read())
        return metrics.load_dir(args.metrics_dir)

    try:
        while True:
            try:
                board = forecast.build_scoreboard(read_metrics())
            except (OSError, ValueError) as e:
                print(f"scoreboard source unreadable: {e}", file=sys.stderr)
                return 1
            if args.json:
                print(json.dumps(board, sort_keys=True), flush=True)
            else:
                if args.watch:
                    sys.stdout.write("\x1b[H\x1b[J")   # repaint in place
                print(forecast.render_scoreboard(board), flush=True)
            if not args.watch:
                return 0
            time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0


def build_geometry_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m poisson_tpu_torch geometry",
        description="Geometry-spec debugger (poisson_tpu_torch.geometry): "
                    "parse a DSL spec, print its fingerprint and "
                    "canonical form, build its blend-coefficient "
                    "canvases, and preview the domain as ASCII "
                    "('#' inside, '+' cut faces, '.' outside).")
    p.add_argument("spec", metavar="SPEC",
                   help="geometry-DSL JSON, inline or @file.json")
    p.add_argument("--M", type=int, default=64,
                   help="grid cells in x for the canvas preview "
                        "(default 64)")
    p.add_argument("--N", type=int, default=64,
                   help="grid cells in y (default 64)")
    p.add_argument("--render", action="store_true",
                   help="ASCII canvas preview (default unless --json)")
    p.add_argument("--width", type=int, default=64,
                   help="render columns (default 64)")
    p.add_argument("--height", type=int, default=24,
                   help="render rows (default 24)")
    p.add_argument("--json", action="store_true",
                   help="one JSON line (fingerprint, canonical spec, "
                        "canvas stats) instead of the render")
    return p


def main_geometry(argv) -> int:
    """``geometry``: the JAX CLI's spec debugger; its ``--json`` line is
    the JAX CLI's for the same spec and grid (host numpy only)."""
    import numpy as np

    from poisson_tpu_torch.geometry import (
        build_geometry_fields,
        cut_face_mask,
        render_ascii,
    )

    args = build_geometry_parser().parse_args(argv)
    spec = parse_geometry_arg(args.spec)
    problem = Problem(M=args.M, N=args.N)
    a64, b64, rhs64 = build_geometry_fields(problem, spec)
    cut = int(cut_face_mask(a64, b64, problem.eps).sum())
    stats = {
        "fingerprint": spec.fingerprint,
        "spec": json.loads(spec.to_json()),
        "M": problem.M, "N": problem.N,
        "inside_nodes": int((rhs64 != 0).sum()),
        "inside_fraction": round(float((rhs64 != 0).mean()), 4),
        "cut_faces": cut,
        "coeff_range": [float(np.min([a64.min(), b64.min()])),
                        float(np.max([a64.max(), b64.max()]))],
    }
    if args.json:
        print(json.dumps(stats))
        return 0
    print(f"fingerprint: {stats['fingerprint']}")
    print(f"canonical:   {spec.to_json()}")
    print(f"grid {problem.M}x{problem.N}: "
          f"{stats['inside_nodes']} nodes inside "
          f"({stats['inside_fraction']:.1%}), {cut} cut faces")
    print(render_ascii(problem, spec, width=args.width,
                       height=args.height))
    return 0


if __name__ == "__main__":
    sys.exit(main())
