#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build of every CUDA source in ``poisson_tpu_torch/ops/csrc`` for
   ``sm_90a``, one ``nvcc`` each, all at once, with their times and
   ``ptxas`` reports, and one "ptxas redesign" line (registers, shared
   memory, stack frame, spill bytes) for each kernel redesigned for the
   card: R and S, which must not spill, and both forms of C;
3. each kernel against its plain PyTorch version on the card, on the same
   seeded canvases with nonzero β and coefficients, at 800×1200 (the
   flagship) and at 2400×3200 (the largest published grid): max abs error of
   every field (pn, Ap, w, r for A and B; pn, t1, t2, t3, x, r, p₁ for C
   and D; tolerance 1e-6, and 0 is expected, since the kernels repeat the
   plain arithmetic in the same order) and relative error of every partial
   sum (tolerance 1e-5; only the summation order differs); the sharded
   forms of A, B, C and D the same way, on shard 0 of both grids cut 2×2
   (canvas 416×640 and 1216×1664), with the live band widened past the
   shard's rows, the column mask, and inputs nonzero on the halo rows and
   columns; the column-blocked kernels A′ and B′ the same way on the
   2400×3200 canvas with bn=1024 (ncb 4, 2448×4352) and on the wide
   probe's auto-blocked canvas (1024×16384: bn 2048, ncb 9, 1136×18688),
   and A and B on the wide probe's full-width canvas (1040×16512); kernel S
   against its plain version, bit for bit, on the partials of A, B, C and
   D at both grids in the serial mode's runs, on those of the sharded
   forms in a shard's runs, and on those of A′ and B′ in a blocked tile's
   runs, each with its ``serial.serial_plan``; the blocked canvases' padding (points swept against the grid's
   interior, which their bytes and bounds count); kernel C's fields exactly
   (0.0) and its strip × segment geometry at each shape; kernel R against
   its plain version after 20 iterations at two grids whose state does not
   all fit on chip (100×8000: sc² and w in device memory; 270×3800: those
   and points past the registers), relative iterate gap ≤ 1e-5;
4. the paths, each with every launch count set to 0 just before it and
   read just after, all before any profiler session:
   - the fused path, ``fused_cg_solve`` (kernels A and B): a warm-up and
     three timed solves at 800×1200 and one at 2400×3200; 800×1200 must give
     989 iterations with diff < 1e-6 and an iterate within 1e-5 of the plain
     fp64 ``pcg_solve`` on the card (the fp32 tolerance of
     tests/test_precision.py); 2400×3200 must give 2449 ± 1 (the fp32
     allowance of tests/test_pcg_golden.py);
   - the resident path, ``resident_cg_solve`` (kernel R, one launch per
     solve) at 40×40, 400×600 and 800×1200 (the grids its budget admits):
     50, 546 and 989 iterations, iterates within 1e-6 of kernel R's plain
     version run on the card and within 1e-5 of the plain fp64 solve; its
     geometry (one block per SM, what stays in device memory);
   - the communication-avoiding path, ``ca_cg_solve`` (kernels C and D):
     546 at 400×600, exactly 989 at 800×1200 with an iterate within 1e-5 of
     the fp64 solve, 2449 ± 1 at 2400×3200;
   - the sharded fused path, ``fused_cg_solve_sharded`` (the sharded forms
     of A and B), and the sharded CA path, ``ca_cg_solve_sharded`` (those
     of C and D), on a 2×2 mesh whose four shards all sit on the one card:
     546 at 400×600 and 989 at 800×1200 exactly, iterates within 1e-5 of
     the plain fp64 solve, 2449 ± 1 at 2400×3200; each sharded form
     launched exactly shards × steps times, no single-device form at all;
     a 2×1 mesh across two cards only where two are visible (a line says
     when it did not run);
   - mixed-precision refinement, ``refined_solve`` at 400×600 over the fused
     backend (kernels A and B) and the resident one (kernel R): relative
     scaled residual ≤ 1e-10, decreasing every pass, the first inner solve
     546 iterations;
   - the column-blocked fused path, ``fused_cg_solve(bn=…)`` (kernels A′
     and B′): 989 at 800×1200 with bn=256 (ncb 5), iterate within 1e-5 of
     the fp64 solve, and 2449 ± 1 at 2400×3200 with bn=1024; A′ and B′
     launched exactly once per step ``drive`` runs, A and B never;
   - the serial-reduce mode (kernel S) at 800×1200 on the fused, blocked
     (bn=256), CA, sharded fused and sharded CA paths (the last two on the
     2×2 mesh), every count zeroed before each: 989 each, iterates within
     1e-5 of the fp64 solve, the path's two field kernels launched exactly
     once per driven step (× shards on the mesh), S exactly 2 times per
     step (× shards) and nothing else; every other path launches S zero
     times;
   - the wide probe, 1024×16384 with δ = 1e-30 and 200 iterations, once on
     the auto-blocked canvas (A′, B′) and once at full width (A, B): µs per
     iteration of each, the host setup seconds of each canvas, and the
     relative difference of the two iterates (≤ 1e-4);
   - the plain sharded solve, ``pcg_solve_sharded`` (no kernel), on the
     2×2 mesh at 400×600 and 800×1200: fp64 Jacobi and fp32 scaled with
     host setup and fp64 with device setup, 546 and 989 exactly, the fp64
     iterates within 1e-10 and the fp32 one within 1e-5 of the plain fp64
     single-device solve, device setup the host setup's count, no kernel
     launched;
   - checkpoint drills at 800×1200 (``fused_cg_solve_checkpointed``,
     ``ca_cg_solve_checkpointed``): chunks of 200 give 989 and the one-shot
     iterate bit for bit; a run capped at 500 and resumed gives the same;
     a blocked (bn=256) write resumed at full width and a CA write resumed
     on the fused path give 989; every count zeroed before each solve and
     its kernels launched exactly once per step its chunks drive; and the
     seconds of one checkpoint write at 2400×3200;
   - the same drills on the 2×2 mesh for ``sharded``, ``fused-sharded``
     and ``ca-sharded`` (``*_sharded_checkpointed``): chunks of 200 bit for
     bit with the one-shot solve, a run capped at 500 and resumed gives 989
     (the fused one bit for bit), a single-device fused file resumes on the
     mesh, and chunked serial solves bit for bit with the one-shot serial
     ones; each sharded kernel form launched once per shard and driven
     step, S twice (8 per step on the fused path), nothing else; and one
     checkpoint write per backend;
   - the batched phase (``solvers.batched``, ``solvers.lanes``: plain
     PyTorch, no kernel launched): 16 fp32 members at 800×1200 with gates
     1 + i/16 against their 16 sequential ``pcg_solve(rhs_gate=…)`` solves
     (counts and flags equal, iterates bit for bit or within 1e-6; batch
     and sequential seconds, solves/s, speedup, µs per batched iteration,
     peak memory); 4 fp64 members, 989 each, against the fp64 solve; 13
     members at their own size and padded to a pinned bucket of 16 (both
     timed), the 3 padding members stopped with FLAG_BREAKDOWN at
     iteration 1 and sliced off; one solve of 64 fp32
     members (solves/s); 4 fp64 members on the 2×2 mesh at 400×600, 546
     each, within 1e-10 of the unsharded batch; a ``LaneBatch`` of 8 lanes
     at 400×600 fp32 taking 12 members through a fixed splice/step/retire
     schedule, each retired member equal to its solo solve;
   - the MG phase (``preconditioner="mg"``, ``poisson_tpu_torch.mg``:
     plain PyTorch, no kernel launched): fp64 14 / 15 / 19 and fp32 14 /
     15 iterations at 400×600 / 800×1200 / 2400×3200, exactly, fp32 at
     2400×3200 converged beside the JAX package's 24; fp32 iterates within
     1e-5 of fp64 MG, fp64 MG within 5e-5 of an fp64 Jacobi solve
     converged to δ = 1e-10 at the two smaller grids; one line per grid
     with the hierarchy build seconds (host, per dtype), the fp32 solve
     (best of 3 after a warm-up, µs per iteration), one plain fp32 Jacobi
     solve and the fused and resident figures of this run; 16 fp32
     members at 800×1200 (gates 1 + i/16) bit for bit with their 16
     sequential MG solves (solves/s, speedup); 6 members through a 4-lane
     ``LaneBatch`` at 400×600, each bit for bit with its solo solve; a
     chunked MG solve at 800×1200 (chunk 4) bit for bit with the one-shot
     one, and a checkpoint written at 8 iterations and resumed to the
     one-shot count;
   - the resilience phase (``solvers.resilient``, the integrity probe,
     ``obs.stream``, ``parallel.watchdog``, ``solvers.history``: plain
     PyTorch, no kernel launched), fp32 at 800×1200: ``verify_every`` 32
     and 5 give 989 bit for bit with the plain solve; the NaN drill
     (NaN at 300, chunk 200) and the bitflip drill (``--verify-every 5
     --fault-bitflip-at 100`` on w and r; an Ap flip lands in r), each
     with the default stagnation window and with it off, give the JAX
     package's recovery histories (``RES_*_HISTORY``), and with it off
     the recovered iterate lies near the clean one (``RES_L2_RATIO``);
     two NaNs at 400×600 escalate to fp64;
     the watchdog beats once per chunk and a stalled ``on_chunk`` raises
     ``SolveTimeout`` with diagnostics; ``stream_every=32`` yields k = 32
     … 960 with the plain bits; the fp64 history solve at 400×600 reaches
     546 with ``pcg_solve``'s last ‖Δw‖; an MG verified resilient solve
     gives 15 with no verdict; then µs per iteration with
     ``verify_every`` 0 / 32 / 5 / 1, a clean resilient solve and a
     streamed one, in turns;
   - the geometry phase (``poisson_tpu_torch.geometry``, ``geometry=``
     through the plain, MG, chunked, batched and lane solves,
     ``solvers.adjoint``: plain PyTorch, no kernel launched), at 800×1200
     with the eight families of ``geometry.manufactured.cases()``: the
     host build seconds of each family's canvases, the default spec's
     canvases bit for bit with the reference fields cast once (fp64 and
     fp32), the canvas cache missing 8 then 0 times across a repeat; fp64
     ``pcg_solve(geometry=)`` at the JAX package's count for each family
     (``GEOM_JAX_ITERATIONS``, from ``python -m
     benchmarks.geometry_goldens``), fp32 within 1e-5 of it, seconds and µs
     per iteration beside the reference ellipse's plain solve; the
     manufactured gate at 64×64 under JAX's floors and its refinement
     rule (400×600 below 0.8× 200×300); 16 fp32 members (the families
     twice, gates 1 + i/16) bit for bit with their solo solves (solves/s);
     a multi-geometry ``LaneBatch`` at 400×600 splicing new families into
     freed lanes, bit for bit with solo solves; fp64 MG on
     ``ellipse-offset`` at JAX's 13; a verified (``verify_every=32``) and
     a chunked geometry solve bit for bit with the plain one; shape
     gradients (fp64, δ = 1e-11) against JAX's and central differences at
     32×32, against JAX's zero and forward mode at 400×600, with forward +
     adjoint seconds beside one forward solve; a "geometry phase" seconds
     line;
   - the measurement phase (``poisson_tpu_torch.bench``, ``native``,
     ``obs.costs``, ``obs.forecast``): the bench's flagship record at
     800×1200 on the fused path (kernels A and B, launched exactly once per
     driven step of its warm-up and three timed solves), 989 iterations,
     no platform fallback, a ``costs.roofline`` block whose bytes model is
     A + B's bytes (``obs.costs`` and this script's own formula agree) and
     whose fraction of the card's bandwidth lies in (0, 1.05]; the
     ``--batch 16``, ``--preconditioner mg`` and ``--verify-every 5``
     records at 400×600 with their counts; the native fp64 oracle on the
     card's host at 400×600, 546 iterations on one thread (±1 on the
     default team), within 1e-10 of the card's fp64 plain solve, seconds
     of each and ``has_openmp``; ``pcg_solve(history_every=50)`` fp32 at
     800×1200 bit for bit with it off, µs per iteration of each in turns,
     and the forecast remaining iterations at the halfway sample beside
     the true remainder;
   - the service phase (``poisson_tpu_torch.serve``, ``testing.chaos``:
     the plain solves, no kernel launched, since the router's execution
     gate keeps every arm on the torch solve): 32 fp32 requests at
     800×1200 with gates 1 + i/32 drained in batches of 16, all converged,
     four members (over both batches) with the iterations, flag and
     ``diff`` of their own ``pcg_solve(rhs_gate=…)`` exactly, the ledger
     closing in ``metrics.snapshot()``, wall seconds, solves/s, p50 and p99
     latency beside the same gates run straight through ``solve_batched``
     in two batches; the same stream under ``scheduling="continuous"``
     (refill chunk 50) with the same iterations, flags and diffs; one
     request whose deadline is a tenth of its solve's time ending typed
     (a partial result flagged at the deadline, or a ``deadline_expired``
     shed); two workers on two slots of the card with a worker killed at
     the second dispatch of 16 requests (batches of 8), the ledger
     closing and the recovered requests finishing at the drain run's
     counts; and the chaos campaign, all 35 scenarios on the card
     (subprocess drills included), green, each closing its ledger, with
     its seconds;
   - the tooling phase (``poisson_tpu_torch.bench``'s serve, Krylov-block
     and session modes, ``contracts``, ``obs.selfcheck``, the solve
     command's ``--save-solution`` and ``--categories``): ``--serve 32
     --arrival-rate 4`` at 800×1200 under both engines, every request
     converged with the same count in both and three of them at their own
     ``pcg_solve``'s count; ``--serve 16`` under fault load at 400×600,
     every clean request a result (converged, or capped by the
     degradation ladder the burst engages) and the poisoned one a typed
     error, its p99; ``--workers 2 --devices 2 --kill-device-at 1`` losing no request
     on a ``2xcuda`` topology; ``--repeat-fingerprint 3`` with a cache hit
     rate above 0; ``--geometry-mix 3`` and ``--tenants a:1,b:4``
     records and an 8-request ``--router`` one with its decisions; ``--krylov-block 16`` with a positive
     ``iteration_cut`` at the same L2 floor; ``--session 20`` at 300×450
     and its steps/s; every record loaded by ``regress.py`` into a cohort
     of its own; ``python -m poisson_tpu_torch.contracts --json`` with
     lint, drift and ``kernels.*`` clean and the traces matched or every
     mismatch named as the environment's; ``python -m
     poisson_tpu_torch.obs.selfcheck --device cuda`` exiting 0; ``solve
     --backend fused --save-solution`` at 800×1200 writing the solve's
     iterate bit for bit (kernels A and B launched exactly once per driven
     step of its three solves); ``--backend torch --categories`` printing
     the table;
   - the multi-process phase (``parallel.multihost``, after the tooling
     phase): two ranks of this script (``--rank``), a gloo process group
     on a free localhost port, each rank declaring two shards on
     ``cuda:0`` so that the 2×2 mesh spans the process boundary; each
     rank solves fp64 ``pcg_solve_sharded(setup="device")`` at 400×600
     and 800×1200 (546 and 989) and runs ``fused_cg_solve_sharded_
     checkpointed`` (A, B sharded) and ``ca_cg_solve_sharded_
     checkpointed`` (C, D sharded) at 800×1200 capped at 400 (the file
     kept), resumed to 989 (the primary removes it) and once more in one
     chunk, timed; each rank's sharded kernels launched exactly its 2
     shards × driven steps; every iterate, on both ranks, bit for bit with
     the same solves on the 2×2 mesh driven by this process (timed too);
     seconds and µs per iteration of both, kernel launches, staged
     host copies and bytes sent per iteration and rank, and the transport
     alone (one all-gather, one staged copy); under NCCL with one card per
     rank where two cards are visible, else a line saying it did not run;
   each path's counts must show each of its kernels launched;
5. the kernels' times (profiler device time per launch; the plain versions
   by CUDA events, and for kernel S ``torch.sum`` over the same partials
   as its library yardstick), bytes and bounds, kernel R's device µs per
   iteration beside its solve's, kernel C's two forms against their bound
   at both grids and both shard sizes, kernel S beside ``torch.sum`` (with
   its chain's latency bound at the card's clock), and a profile of one
   flagship solve on the fused, blocked, CA, sharded fused and sharded CA
   paths, of one batched solve of 16 members capped at 128 iterations
   (launches and device time per batched iteration), of one fp32 MG
   solve at 800×1200 (launches, device and wall µs per iteration, the
   device's idle share), and of 64 fp32 flagship iterations plain, with
   ``verify_every=5`` and with ``stream_every=32`` (launches and device
   µs per iteration); then the measurement phase's profiled part:
   ``obs.profile.capture`` around one fused flagship solve (A and B once
   per driven step), whose exported trace must name
   ``direction_stencil_kernel`` and ``fused_update_kernel``; launches and
   device µs per iteration of 128 capped fp32 iterations with
   ``history_every`` 0 and 50; and this run's counters and gauges through
   ``obs.export``: the textfile parses back to every numeric value, the
   ``/metrics`` endpoint on 127.0.0.1 serves every one, and the ``top``
   scoreboard renders from it;
6. a ``kernels`` JSON line (twelve kernels), then the ``ok`` JSON line last.

Without a CUDA device, or run outside a checkout (no ``poisson_tpu_torch``
beside it), it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

FIELD_TOL = 1e-6     # max abs error of a kernel's fields against the plain
SUM_TOL = 1e-5       # relative error of each partial sum
ITERATE_TOL = 1e-5   # fp32 iterate vs plain fp64 solve
PLAIN_TOL = 1e-6     # kernel R's iterate vs its plain version on the card
REFINE_TOL = 1e-10  # refined solve's relative scaled residual (fp64 floor)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores


class Kernel(NamedTuple):
    wrapper: str    # the key of its launch count in ``launch_counts()``
    symbol: str     # the CUDA kernel's name, as the profiler reports it
    source: str
    replaces: str   # the TPU kernel's pallas_call site
    flops: int      # operations the function needs per live point
    passes: int     # band canvases it must read once or write once
    main: str = "800x1200"   # the shape its headline numbers use
    extra_rows: int = 0      # canvas rows it must also move, past the band


# Flops per live point (per iteration for R), counting what the function
# needs, not what a kernel's design adds. A: pn = z + βp (2), the stencil
# (13), its dot (2); kernel A also recomputes z + βp at the four
# neighbours, which is its design, not work the function needs. B: two
# axpys (4), p²sc² (2), r² (1) and two sums (2). C: pn (2), three stencils
# (39), 6 plain Gram terms (12) and 6 weighted (18). D: r' (6), x' (6),
# p₁ (4), r'² (2). R: A's and B's, 26 per iteration. The sharded forms add
# the column mask's multiply to each masked product (A, B, D 1; C 6), and
# move a few rows past the band (``extra_rows``): A reads z and p on the two
# halo rows and writes pn there (6) and reads the mask (1); C reads p_prev
# and r on its four ring rows (8), cS on three rows past the centre and cW
# and γ on two (7), and the mask (1); B and D read the mask (1). A′ and
# B′ need A's and B's flops and bytes per content point. S adds each
# partial once (its Kahan steps, four per run, are a few hundred
# operations) and moves the partials and one sum per vector: its bytes are
# given per launch (``nbytes``).
KERNELS = {
    "direction_stencil": Kernel(
        "direction_and_stencil", "direction_stencil_kernel",
        "poisson_tpu_torch/ops/csrc/fused_cg.cu",
        "poisson_tpu/ops/pallas_cg.py:733", 17, 7),
    "fused_update": Kernel(
        "fused_update", "fused_update_kernel",
        "poisson_tpu_torch/ops/csrc/fused_cg.cu",
        "poisson_tpu/ops/pallas_cg.py:805", 9, 7),
    "basis_sweep": Kernel(
        "basis_sweep", "basis_sweep_kernel",
        "poisson_tpu_torch/ops/csrc/ca_cg.cu",
        "poisson_tpu/ops/pallas_ca.py:318", 71, 10),
    "pair_update": Kernel(
        "pair_update", "pair_update_kernel",
        "poisson_tpu_torch/ops/csrc/ca_cg.cu",
        "poisson_tpu/ops/pallas_ca.py:369", 18, 9),
    "resident_solve": Kernel(
        "resident_solve", "resident_kernel",
        "poisson_tpu_torch/ops/csrc/resident_cg.cu",
        "poisson_tpu/ops/pallas_resident.py:154", 26, 6, main="400x600"),
    "direction_stencil_sharded": Kernel(
        "direction_and_stencil_sharded", "direction_stencil_sharded",
        "poisson_tpu_torch/ops/csrc/fused_cg.cu",
        "poisson_tpu/ops/pallas_cg.py:733", 18, 7, "800x1200-2x2", 7),
    "fused_update_sharded": Kernel(
        "fused_update_sharded", "fused_update_sharded",
        "poisson_tpu_torch/ops/csrc/fused_cg.cu",
        "poisson_tpu/ops/pallas_cg.py:805", 10, 7, "800x1200-2x2", 1),
    "basis_sweep_sharded": Kernel(
        "basis_sweep_sharded", "basis_sweep_sharded",
        "poisson_tpu_torch/ops/csrc/ca_cg.cu",
        "poisson_tpu/ops/pallas_ca.py:318", 77, 10, "800x1200-2x2", 16),
    "pair_update_sharded": Kernel(
        "pair_update_sharded", "pair_update_sharded",
        "poisson_tpu_torch/ops/csrc/ca_cg.cu",
        "poisson_tpu/ops/pallas_ca.py:369", 19, 9, "800x1200-2x2", 1),
    "direction_stencil_blocked": Kernel(
        "direction_and_stencil_blocked", "blocked_stencil_kernel",
        "poisson_tpu_torch/ops/csrc/blocked_cg.cu",
        "poisson_tpu/ops/pallas_cg.py:702", 17, 7, "1024x16384"),
    "fused_update_blocked": Kernel(
        "fused_update_blocked", "blocked_update_kernel",
        "poisson_tpu_torch/ops/csrc/blocked_cg.cu",
        "poisson_tpu/ops/pallas_cg.py:770", 9, 7, "1024x16384"),
    "serial_sum": Kernel(
        "serial_sum", "serial_sum_kernel",
        "poisson_tpu_torch/ops/csrc/serial_sum.cu",
        "poisson_tpu/ops/pallas_cg.py:464", 1, 1),
}
GRIDS = [(800, 1200), (2400, 3200)]
RESIDENT_GRIDS = [(40, 40, 50), (400, 600, 546), (800, 1200, 989)]
REPEATS = 3          # timed flagship solves after the warm-up; best reported
SHARD_GRID = (2, 2)  # the sharded paths' mesh: four shards on one card
SHARDED_EXPECTED = [(400, 600, 546, 0), (800, 1200, 989, 0),
                    (2400, 3200, 2449, 1)]   # (M, N, iterations, allowance)
# The column-blocked path: (M, N, bn, iterations, allowance, timed solves).
BLOCKED_EXPECTED = [(800, 1200, 256, 989, 0, REPEATS),
                    (2400, 3200, 1024, 2449, 1, 1)]
# The wide probe: the JAX package's big-grid probe shape, which its
# layout rule column-blocks (bn 2048); 200 iterations that never converge.
WIDE = dict(M=1024, N=16384, delta=1e-30, max_iter=200)
WIDE_TOL = 1e-4      # blocked vs full-width iterate after 200 iterations
CKPT_CHUNK = 200     # checkpoint drills: iterations per chunk
CKPT_CAP = 500       # the capped run the drills resume
# The kernels redesigned for the card (R and C in the fifth slice, S in the
# sixth), by library; those in NO_SPILL must report no spill and no stack
# frame.
REDESIGNED = {"resident_cg": ("resident_kernel",),
              "ca_cg": ("basis_sweep_kernel", "basis_sweep_sharded"),
              "serial_sum": ("serial_sum_kernel",)}
NO_SPILL = ("resident_kernel", "serial_sum_kernel")
# The plain sharded solve (no kernel of the port) on the 2x2 mesh: fp64
# Jacobi and fp32 scaled with host setup, fp64 with device setup, exact
# counts; fp64 iterate vs the plain single-device fp64 solve on the card.
PLAIN_SHARDED = [(400, 600, 546), (800, 1200, 989)]
SHARDED_FP64_TOL = 1e-10
# Grids at which kernel R keeps part of its state in device memory: sc² and
# w off chip (one row of 8064 columns per block), and also points past the
# registers (three rows of 3840); 20 iterations that never converge, few
# enough that the two sum orders have not drifted apart.
RESIDENT_FALLBACKS = [dict(M=100, N=8000, delta=1e-30, max_iter=20),
                      dict(M=270, N=3800, delta=1e-30, max_iter=20)]
FALLBACK_TOL = 1e-5  # R vs its plain version after 20 iterations, relative
# The batched phase (``solvers.batched``, ``solvers.lanes``: plain PyTorch,
# no kernel of the port). A member's iterate must equal its sequential
# solve bit for bit, or lie within BATCH_MEMBER_TOL of it (fp32); the mesh
# batch within SHARDED_FP64_TOL of the unsharded one (fp64).
BATCH = 16           # fp32 members at 800x1200, gates 1 + i/16, bucket 16
BATCH_WIDE = 64      # one fp32 solve of 64 members: how the batch scales
BATCH_RAGGED = 13    # run as it is, and padded to a pinned bucket of 16
BATCH_FP64 = 4       # fp64 members, gate 1: 989 each (the golden count)
BATCH_MESH = 4       # fp64 members on the 2x2 mesh at 400x600: 546 each
LANE_BUCKET, LANE_MEMBERS, LANE_CHUNK = 8, 12, 64   # lanes at 400x600 fp32
# The profiled batched solve stops at this cap: a profiler session costs
# seconds per ten thousand launches it records, and every iteration of the
# batch runs the same launches.
BATCH_PROFILE_ITERS = 128
BATCH_MEMBER_TOL = 1e-6
# The MG phase (``preconditioner="mg"``: plain PyTorch, no kernel of the
# port): (M, N, fp64 count, fp32 count or None where it is not gated,
# the JAX package's fp32 count). At 2400x3200 the coarsest level (75x100)
# is over the dense limit, and the fp32 count moves with the sum order.
MG_GRIDS = [(400, 600, 14, 14, 14), (800, 1200, 15, 15, 15),
            (2400, 3200, 19, None, 24)]
MG_FP32_TOL = 1e-5     # fp32 MG iterate vs fp64 MG on the card
# The resilience phase (``solvers.resilient``, the integrity probe, the
# stream, the watchdog and the history solve: plain PyTorch on the torch
# path, no kernel of the port), at the flagship in fp32 unless named.
RES_VERIFY = (0, 32, 5, 1)   # verify_every strides timed per iteration
RES_CHUNK = 200              # the resilient solves' chunk
RES_NAN_AT = 300             # NaN drill: the boundary at/after k = 300
RES_FLIP_AT = 100            # bitflip drill: --fault-bitflip-at 100
RES_FLIP_VERIFY = 5          # ... --verify-every 5 (chunk min(200, 100))
RES_ESCALATE = (400, 600)    # two NaNs at fp32 end in fp64 ...
RES_ESCALATE_AT = 100        # ... at the boundaries at/after k = 100,
# with stagnation detection off: with the default window both packages
# read the fp64 restart as stagnated at 401 and end in DivergenceError.
RES_ESCALATE_HISTORY = [(101, "nonfinite", "restart@float32"),
                        (201, "nonfinite", "escalate->float64")]
RES_ESCALATE_JAX_ITERATIONS = 726
RES_STALL = (0.5, 1.0)       # watchdog timeout, seconds an on_chunk sleeps
RES_STREAM = 32              # stream stride: k = 32, 64, ..., 960
RES_HISTORY = (400, 600, 560)  # fp64 history grid and budget (546 steps)
RES_MG = (5, 5)              # MG verified resilient: verify_every, chunk
# The JAX package's recovery histories, counts and distances on these
# drills at 800x1200 fp32: its resilient driver on the CPU, as
# ``python -m benchmarks.resilience_goldens`` prints them (the port's CPU
# run gives the same histories).
# With the default stagnation window (200) a restarted CG reads as
# stagnated 200 iterations later in both packages, and the bitflip
# drills end in DivergenceError; the drills run with that window and
# with stagnation detection off (window 0), where one restart recovers.
# A flip in r or Ap at k = 100 overflows at this size: a NaN verdict in
# both packages, not an integrity one.
RES_NAN_HISTORY = {
    200: [(401, "nonfinite", "restart@float32"),
          (601, "stagnated", "escalate->float64"),
          (801, "stagnated", "restart@float64")],
    0: [(401, "nonfinite", "restart@float32")]}
RES_NAN_JAX_ITERATIONS = {200: 801, 0: 1424}
RES_NAN_MAX_DIFF = 0.00036009401082992554    # window 0
RES_FLIP_HISTORY = {
    (200, "w"): [(105, "integrity", "verified-restart@100"),
                 (301, "stagnated", "restart@float32"),
                 (501, "stagnated", "escalate->float64")],
    (200, "r"): [(102, "nonfinite", "restart@float32"),
                 (301, "stagnated", "escalate->float64"),
                 (501, "stagnated", "restart@float64")],
    (0, "w"): [(105, "integrity", "verified-restart@100")],
    (0, "r"): [(102, "nonfinite", "restart@float32")]}
# No "Ap" drill: testing.faults lands an Ap flip in r (Ap is never
# stored), so with the same seed it is the r drill exactly.
RES_FLIP_JAX_ITERATIONS = 1002   # window 0, both buffers
RES_FLIP_MAX_DIFF = 0.00027595460414886475   # window 0, both buffers
# Window 0, where one restart recovers: the recovered iterate's L2 error
# is held to RES_L2_RATIO x the clean solve's on the card, and its largest
# gap to the clean iterate to RES_L2_RATIO x the JAX package's gap on the
# same drill (RES_*_MAX_DIFF).
RES_L2_RATIO = 1.5
RES_PROFILE_ITERS = 64       # capped solves profiled for launches per step
# fp64 MG vs the fp64 Jacobi solve converged to MG_TIGHT_DELTA, at the grids
# of MG_TIGHT (tests/test_mg.py:195-205's tolerance). At δ = 1e-6 the Jacobi
# iterate itself lies farther from the solution, by the same gap to MG in
# both packages (tests/test_torch_mg.py), so that gap is printed only.
MG_JACOBI_TOL, MG_TIGHT_DELTA = 5e-5, 1e-10
MG_TIGHT = ("400x600", "800x1200")
MG_FLAGSHIP, MG_MID = (800, 1200), (400, 600)
MG_BATCH = 16          # fp32 members at MG_FLAGSHIP, gates 1 + i/16
MG_LANES = (4, 6, 4)   # bucket, members, chunk: lanes at MG_MID, fp32
MG_CHUNK = 4           # chunked and checkpointed MG solves at MG_FLAGSHIP
MG_CAP = 8             # the capped MG run the checkpoint drill resumes
# The geometry phase (``poisson_tpu_torch.geometry``, ``geometry=`` through
# the plain, MG, chunked, batched and lane solves, ``solvers.adjoint``:
# plain PyTorch, no kernel of the port), with the specs of
# ``geometry.manufactured.cases()``. The JAX package's counts on the CPU
# (x64 on), as ``python -m benchmarks.geometry_goldens`` prints them: fp64
# pcg_solve(geometry=spec) at 800x1200, per family (its fp32 counts are the
# same), and the fp64 MG count of GEOM_MG_CASE there.
GEOM_FLAGSHIP = (800, 1200)
GEOM_JAX_ITERATIONS = {"ellipse": 989, "ellipse-offset": 600,
                       "rectangle": 623, "polygon": 623, "union": 425,
                       "intersection": 367, "difference": 479, "sdf": 447}
GEOM_MG_CASE, GEOM_MG_JAX_ITERATIONS = "ellipse-offset", 13
GEOM_FP32_TOL = 1e-5          # fp32 geometry iterate vs the card's fp64
# The manufactured gate: JAX's floors at 64x64
# (tests/test_geometry_dsl.py:246-255), and the refinement rule on the
# smooth-boundary families (the fine error below 0.8x the coarse one).
GEOM_FLOOR_REL = {"ellipse": 6e-2, "ellipse-offset": 1e-1,
                  "rectangle": 6e-2, "polygon": 6e-2, "union": 7e-2,
                  "intersection": 1e-1, "difference": 5e-2, "sdf": 1.5e-1}
GEOM_REFINE = ((200, 300), (400, 600), ("ellipse", "ellipse-offset", "sdf"),
               0.8)
GEOM_BATCH = 16               # fp32 members: the 8 families twice
# Lanes at 400x600 fp32: the first four families in, then two more
# spliced into the lanes the first to finish free.
GEOM_LANES = (4, 64, ("ellipse-offset", "rectangle", "union", "sdf"),
              ("intersection", "difference"))
GEOM_VERIFY, GEOM_CHUNK = 32, 100   # the verified and chunked solves ...
GEOM_SOLO_CASE = "intersection"     # ... of this family (the fewest steps)
# Shape gradients (``shape_gradient``, fp64, δ = 1e-11, Ellipse(rx, ry)),
# with JAX's loss Σ w·h1·h2 (tests/test_geometry_dsl.py:617-619) and the
# JAX package's gradients on the CPU (benchmarks/geometry_goldens.py). At
# 32x32, JAX's test grid, the gradient must match central differences of
# step GEOM_FD_STEP to GEOM_FD_TOL. At 400x600 that loss's cotangent is
# so small that the adjoint solve stops on the |(Ap, p)| < 1e-15 guard at
# its first step in both packages (a zero gradient), and the discrete
# objective has kinks denser than the step, so there the card is held to
# JAX's gradient, and, with the unscaled loss Σ w, forward mode to
# reverse mode (GEOM_MODES_TOL); its central differences are printed.
GEOM_ADJOINT = ((400, 600), (32, 32))
GEOM_ADJOINT_DELTA, GEOM_ADJOINT_PARAMS = 1e-11, (0.8, 0.42)
GEOM_ADJOINT_JAX = {(400, 600): (0.0, 0.0),
                    (32, 32): (0.0474388066439755, 0.20470295007078093)}
GEOM_ADJOINT_JAX_TOL = 1e-6   # relative, or 1e-12 absolute at zero
GEOM_FD_STEP, GEOM_FD_TOL, GEOM_MODES_TOL = 1e-5, 5e-3, 1e-4

# The Krylov phase (``poisson_tpu_torch.krylov``: block CG and deflation
# recycling; ``solvers.session``; and the chunked ``rhs_gate`` and bf16
# repairs: plain PyTorch, no kernel of the port). The JAX package's values
# on the CPU (x64 on), recomputed by the slow test
# tests/test_torch_krylov.py::test_chip_smoke_krylov_goldens_are_jax_s.
KRY_FLAGSHIP = (800, 1200)
KRY_BLOCK_B = 16                 # clustered_ellipse_stack members, seed 0
KRY_BLOCK_JAX_MAX = 836          # JAX's fp32 block max_iterations there
# fp32 block counts follow the B×B products' sum order (cuBLAS here,
# XLA:CPU in JAX): the card's block count is held to JAX's within this
# share (the CPU tests hold 2% at 160x240).
KRY_BLOCK_ALLOWANCE = 0.05
KRY_L2_RATIO = 1.2               # block member L2 vs independent's
KRY_DEFICIENT_GATES = (1.0, 1.4, 0.7)
# JAX's fp32 rank-deficient block at the flagship: 1032 against the solo
# 989, so "solo + 5" (tests/test_krylov.py's 60x60 rule) holds in neither
# package here; the card is held to JAX's count within the allowance.
KRY_DEFICIENT_JAX_MAX = 1032
KRY_WARM_GATE = 1.5              # the warm recycled solve's rhs_gate
KRY_RECYCLE64 = (400, 600)       # fp64 recycled solves: (cold, warm) ...
KRY_RECYCLE64_JAX = (546, 1)     # ... JAX's counts
# The warm session step on the same domain with its RHS 10% larger: in
# JAX at 800x1200 (fp32 and fp64) the restart's first update (1.2e-7,
# 1.4e-7) is under δ, so the step stops after 1 iteration, 9.99e-3 from
# the cold solve at the same gate (998 iterations): the ‖Δw‖ stop cannot
# tell a small first step of a restart from convergence. The card's fp32
# step is held to JAX's count and to JAX's fp64 gap within two fp32
# iterate tolerances (JAX's own fp32 iterates lie farther off).
KRY_SESSION_GATE = 1.1
KRY_SESSION_JAX = (1, 0.009986091654709484)   # (iterations, gap), fp64
KRY_SESSION_GAP_TOL = 2 * ITERATE_TOL
# Six implicit-Euler heat steps (fp64, m = 1) at 400x600: JAX's counts and
# ‖u − u_steady‖; the warm steps stop after one update for the same reason
# (JAX's 32x32 test contracts 100x in three steps; here it cannot).
KRY_HEAT, KRY_HEAT_STEPS = (400, 600), 6
KRY_HEAT_JAX_ITERATIONS = (540, 1, 1, 1, 1, 1)
KRY_HEAT_JAX_ERRORS = (1.4791134789982716, 1.4790083219748733,
                       1.478981515042114, 1.4789178410090627,
                       1.4788907646000506, 1.4788295552338837)
KRY_HEAT_TOL = 1e-9              # relative, fp64 errors vs JAX's
# The design step (fp64): at 32x32, JAX's session test grid, the four
# gradients are nonzero; at 100x150 the adjoint stops at its first step on
# the |(Ap, p)| < 1e-15 guard in both packages (a zero gradient).
KRY_DESIGN = (32, 32)
KRY_DESIGN_PARAMS = (("cx", 0.05), ("cy", 0.02), ("rx", 0.8), ("ry", 0.45))
KRY_DESIGN_LR = 0.1
KRY_DESIGN_JAX_PARAMS = {"cx": 0.05001412360264326,
                         "cy": 0.020040214309850545,
                         "rx": 0.8000344585202428,
                         "ry": 0.45006155062954617}
KRY_DESIGN_JAX_LOSS = 0.00038625267834980305
KRY_DESIGN_TOL = 1e-6            # relative
KRY_CHUNK = 100                  # the gated chunked solve's chunk
KRY_BF16 = (400, 600)
KRY_BF16_JAX_ITERATIONS = 859
KRY_BF16_ALLOWANCE = 0.02        # relative (tests/test_torch_resilient.py)
KRY_BF16_JAX_GAP = 1.57e-2       # JAX's bf16 iterate from fp64 (2x held)
KRY_BF16_JAX_HISTORY = ((724, "stagnated", "restart@bfloat16"),
                        (1224, "stagnated", "escalate->float32"))
KRY_PROFILE_ITERS = 32           # the profiled capped block solve
# The measurement phase (the bench's records, the native oracle, the
# history seam, the profiler capture and the Prometheus exposition).
MEAS_BATCH = 16                  # bench --batch, at the bench's 400x600
MEAS_VERIFY = 5                  # bench --verify-every
MEAS_NATIVE = (400, 600, 546)    # the oracle's grid and golden count
MEAS_NATIVE_TOL = 1e-10          # oracle vs the card's fp64 plain solve
MEAS_HISTORY = 50                # history_every of the flagship fp32 solve
MEAS_HISTORY_ITERS = 128         # capped solves profiled with it off and on
FRACTION_MAX = 1.05              # a larger roofline share is a fault
# The service phase (the solve service on the card, then the chaos
# campaign).
SERVE_REQUESTS = 32              # fp32 requests at 800x1200, gates 1 + i/32
SERVE_BATCH = 16                 # max_batch: two drained batches
SERVE_CHECKED = (0, 9, 16, 31)   # members held to their own pcg_solve
SERVE_PAIRS = 3                  # drains timed against straight batches
SERVE_REFILL = 50                # the continuous run's refill chunk
SERVE_DEADLINE = (0.1, 25)       # deadline as a share of one measured
                                 # solve, and the chunk
SERVE_FLEET = (2, 16, 8)         # workers (on two slots of the card),
                                 # requests, max_batch
# The tooling phase (the bench's serve, Krylov-block and session modes,
# the contract gate, the selfcheck, the solve command's last flags).
TOOL_OPENLOOP = (32, 4.0)        # --serve 32 --arrival-rate 4 at 800x1200
TOOL_CHECKED = (0, 15, 31)       # open-loop requests held to pcg_solve
TOOL_SERVE = 16                  # requests of the 400x600 serve modes
TOOL_ROUTER = 8                  # ... and of the --router run
TOOL_KILL_DEVICE_AT = 1.0        # --workers 2 --devices 2 --kill-device-at
TOOL_FAMILIES = 3                # --repeat-fingerprint and --geometry-mix
TOOL_TENANTS = (("a", 1.0), ("b", 4.0))
TOOL_BLOCK = 16                  # --krylov-block at 400x600
TOOL_SESSION = 20                # --session steps at 300x450
MP_GRIDS = ((400, 600, 546), (800, 1200, 989))   # fp64 device setup
MP_CAP = 400                     # the capped run the two ranks resume
MP_RANKS = 2                     # processes, each with two shards of the
MP_SHARDS = 2                    # 2x2 mesh on cuda:0 (gloo)
MP_TIMEOUT = 300                 # seconds each rank may take, then killed
MP_PROBES = 200                  # transport probes timed in each rank


def ptxas_report(log: str, symbol: str) -> dict | None:
    """Registers, shared memory, stack frame and spill bytes of the CUDA
    kernel ``symbol`` from ``nvcc -Xptxas -v`` output (mangled names carry
    the identifier's length before it; a local array the compiler could not
    keep in registers shows as stack frame, not as spills)."""
    mangled = f"{len(symbol)}{symbol}"
    current, rec = None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            continue
        if current is None or mangled not in current:
            continue
        rec = rec or {"function": current}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rec["stack_frame_bytes"] = int(m.group(1))
            rec["spill_store_bytes"] = int(m.group(2))
            rec["spill_load_bytes"] = int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rec["smem_bytes"] = int(smem.group(1)) if smem else 0
    return rec


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, message: str) -> None:
    if not ok:
        fail(message)


def events_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events around the burst."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_kernels(fn):
    """Run ``fn`` under torch.profiler; returns ({kernel name: (count,
    total device µs)}, wall seconds), or (None, wall) when the profiler
    recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        n, tot = kernels.get(e.name, (0, 0.0))
        kernels[e.name] = (n + 1, tot + us)
    return (kernels or None), wall


def named(name: str, symbol: str) -> bool:
    """Whether a profiler event ``name`` is the kernel ``symbol`` itself: the
    whole identifier, not part of a longer one (``direction_stencil_kernel``
    is not ``direction_stencil_sharded``)."""
    word = r"[A-Za-z0-9_]"
    return re.search(rf"(?<!{word}){re.escape(symbol)}(?!{word})",
                     name) is not None


def kernel_device_ms(fn, reps: int, symbol: str | None):
    """Device ms per launch of the kernel named ``symbol``, or with
    ``symbol`` None per call of ``fn``, all its kernels together, from the
    profiler over ``reps`` calls; None if it saw no such kernel."""
    def burst():
        for _ in range(reps):
            fn()

    kernels, _ = profile_kernels(burst)
    if not kernels:
        return None
    if symbol is None:
        return sum(us for _, us in kernels.values()) / reps / 1e3
    hits = [(n, us) for name, (n, us) in kernels.items()
            if named(name, symbol)]
    if not hits:
        return None
    n = sum(h[0] for h in hits)
    return sum(h[1] for h in hits) / n / 1e3


def band_points(fc, cv) -> int:
    return (cv.rows - 2 * fc.HALO) * cv.cols


def rel_err(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def timer(results: dict, name: str, tag: str, run, plain, reps: int,
          plain_reps: int, points: int, iterations: int = 1, cols: int = 0,
          library=None, nbytes: int | None = None):
    """A function that times ``run`` (profiler device time per launch, CUDA
    events as the fallback), ``plain`` and, where one PyTorch call computes
    the same function, ``library`` (CUDA events), and records them with the
    bytes and bound of one launch over ``points`` band points
    (``iterations`` sweeps of work for kernel R) and the kernel's extra rows
    of ``cols`` columns, or ``nbytes`` where given. The library call's time
    is its device time under the profiler, as the kernel's is."""
    kernel = KERNELS[name]

    def time_it() -> None:
        ev_ms = events_ms(run, reps)
        dev_ms = kernel_device_ms(run, reps, kernel.symbol)
        plain_ms = events_ms(plain, plain_reps)
        library_ms = None
        if library is not None:
            library_ms = (kernel_device_ms(library, reps, None)
                          or events_ms(library, reps))
        if nbytes is None:
            from poisson_tpu_torch.obs import costs

            moved = costs.kernel_bytes(name, points, cols)
            formula = (kernel.passes * points + kernel.extra_rows * cols) * 4
            check(moved == formula, f"{name} {tag}: obs.costs bytes {moved} "
                                    f"!= the smoke's formula {formula}")
        else:
            moved = nbytes
        bound_bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = (kernel.flops * points * iterations
                        / FP32_FLOPS_PER_S * 1e3)
        results.setdefault(name, {})[tag] = rec = {
            "ms": dev_ms if dev_ms is not None else ev_ms,
            "timing": "profiler" if dev_ms is not None else "cuda_events",
            "events_ms": ev_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bytes": moved,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"),
        }
        print(f"time {name} {tag}: {json.dumps(rec)}", flush=True)
        torch.cuda.synchronize()

    return time_it


def record_err(errors: dict, name: str, err: float) -> None:
    errors[name] = max(errors.get(name, 0.0), err)


def check_serial(sr, tag: str, inputs: dict, errors: dict) -> None:
    """Kernel S against its plain version on each of ``inputs`` (label →
    (partials, run length)), bit for bit."""
    for label, (parts, n) in inputs.items():
        got, want = sr.serial_sum(parts, n), sr.serial_sum_plain(parts, n)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        err = float((got - want).abs().max())
        x, interleaved = sr.kernel_layout(sr._as_vectors(parts)[0])
        plan = sr.serial_plan(x.shape[1], x.shape[0], n, interleaved)
        print(f"kernel serial_sum {tag} on {label}'s partials (run {n}): "
              f"bitwise={same} max_abs_err={err!r} plan "
              f"{json.dumps(plan._asdict())}", flush=True)
        check(same, f"serial_sum {tag} on {label}'s partials: not bit for "
                    f"bit with its plain version ({err})")
        record_err(errors, "serial_sum", err)


@functools.lru_cache(maxsize=None)
def sm_clock_mhz() -> float:
    """The card's maximum SM clock (MHz), from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi clocks: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


# Latency of one dependent fp32 add on Hopper, in cycles: the floor under
# every link of kernel S's chain (its shuffles and shared-memory loads take
# longer).
FADD_CYCLES = 4


def serial_chain_bound(sr, parts, run: int) -> dict:
    """Kernel S's latency bound on ``parts`` in runs of ``run``: the
    dependent adds its result waits for (a lane's run, the five tree
    levels, four per Kahan link) at FADD_CYCLES each, at the card's maximum
    clock."""
    x, _ = sr.kernel_layout(sr._as_vectors(parts)[0])
    ops = -(-run // 32) + 2 * 5 + 4 * -(-x.shape[1] // run)
    return {"chain_dependent_adds": ops,
            "chain_bound_us": ops * FADD_CYCLES / sm_clock_mhz()}


# The recurrence's kernels (``ops.recurrence``), one thread each: the links
# of the longer dependent chain of each (the IEEE divide and square root
# counted as eight links each), the floor under a one-thread kernel's time
# at FADD_CYCLES a link; and the bytes each launch reads and writes.
RECURRENCE_CHAIN = {"recurrence_step": 12, "recurrence_close": 12}
RECURRENCE_BYTES = {"recurrence_step": 14, "recurrence_close": 47}
RECURRENCE_REPS = 500


def check_recurrence(card: str) -> dict:
    """The scalar recurrence's two kernels on the card against their plain
    version (the torch operations they replaced) on a few states, bit for
    bit (``tests/test_torch_recurrence.py`` sweeps many more), and each
    timed by the profiler per launch beside the plain version's kernels per
    call. Returns the line it prints."""
    import types

    from poisson_tpu_torch.config import FLAGSHIP
    from poisson_tpu_torch.ops.recurrence import Recurrence

    dev = torch.device("cuda")
    rec = Recurrence(FLAGSHIP, dev)

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=dev)

    def state(done, zr):
        return types.SimpleNamespace(k=t(7, torch.int32), done=t(done, None),
                                     zr=t(zr), beta=t(0.9), diff=t(1e-2))

    def same(a, b) -> bool:
        return all(torch.equal(x.view(torch.int32) if x.is_floating_point()
                               else x, y.view(torch.int32)
                               if y.is_floating_point() else y)
                   for x, y in zip(a, b))

    for denom, done, zr in ((1.5e6, False, 3.0), (1.5e6, True, 3.0),
                            (0.0, False, 3.0), (-1.5e6, False, 0.0)):
        s = state(done, zr)
        got = rec.step_size(s, t(denom))
        check(same(got, rec.step_size_plain(s, t(denom))),
              f"recurrence_step: not its plain version's bits at denom "
              f"{denom}, done {done}, zr {zr}")
        sums = (t(1e-3), t(2.0))
        closed = rec.close(s, *got, *sums)
        plain = rec.close_plain(s, *got, *sums)
        check(same(closed.values(), plain.values()),
              f"recurrence_close: not its plain version's bits at denom "
              f"{denom}, done {done}, zr {zr}")
    s = state(False, 3.0)
    denom, sums = t(1.5e6), (t(1e-3), t(2.0))
    alpha, deg = rec.step_size(s, denom)
    runs = {"recurrence_step": (lambda: rec.step_size(s, denom),
                                lambda: rec.step_size_plain(s, denom)),
            "recurrence_close": (lambda: rec.close(s, alpha, deg, *sums),
                                 lambda: rec.close_plain(s, alpha, deg,
                                                         *sums))}
    line = {}
    for name, (kernel, plain) in runs.items():
        ms = kernel_device_ms(kernel, RECURRENCE_REPS, f"{name}_kernel")
        check(ms is not None, f"{name}: the profiler saw no launch")
        seen, _ = profile_kernels(
            lambda: [plain() for _ in range(RECURRENCE_REPS)])
        line[name] = {
            "us_per_launch": ms * 1e3,
            "plain_us_per_call": sum(us for _, us in (seen or {}).values())
            / RECURRENCE_REPS,
            "plain_launches_per_call": sum(n for n, _ in (seen or {}).values())
            / RECURRENCE_REPS,
            "bytes": RECURRENCE_BYTES[name],
            "chain_links": RECURRENCE_CHAIN[name],
            "chain_bound_us": RECURRENCE_CHAIN[name] * FADD_CYCLES
            / sm_clock_mhz(),
            "bitwise_vs_plain": True}
    print(f"recurrence kernels [{card}]: {json.dumps(line)}", flush=True)
    return line


def check_kernels(M: int, N: int, fc, ca, sr, results: dict, errors: dict):
    """Phase 3 at one grid: kernels A, B, C, D vs their plain versions, and
    kernel S vs its plain version on their partials, in the serial mode's
    runs. Returns the functions that time them, which run after the main
    paths so that no profiler session precedes the timed solves."""
    from poisson_tpu_torch.config import Problem

    problem = Problem(M=M, N=N)
    cv, cs, cw, g, rhs, sc2, _ = fc.build_canvases(problem, "cuda")
    rng = np.random.default_rng(M)

    def interior_random():
        x = np.zeros((cv.rows, cv.cols), np.float32)
        x[fc.HALO : fc.HALO + M - 1, 1:N] = rng.standard_normal((M - 1, N - 1))
        return torch.tensor(x, device="cuda")

    z, p, w0, r0 = (interior_random() for _ in range(4))
    beta = torch.tensor(0.37, dtype=torch.float32, device="cuda")
    alpha = torch.tensor(0.21, dtype=torch.float32, device="cuda")
    coefs = torch.tensor([0.31, 0.22, 0.07, 0.25, 0.15, 0.0, 0.0, 0.0],
                         dtype=torch.float32, device="cuda")
    points = band_points(fc, cv)
    tag = f"{M}x{N}"

    # Kernel A against its plain version, on the same inputs.
    pn_k, ap_k, part_k = fc.direction_and_stencil(cv, beta, z, p, cs, cw, g)
    pn_p, ap_p = torch.zeros_like(z), torch.zeros_like(z)
    part_p = fc.direction_and_stencil_plain(cv, beta, z, p, cs, cw, g,
                                            pn_p, ap_p)
    # Kernel B (w, r are updated in place).
    w_k, r_k, w_p, r_p = w0.clone(), r0.clone(), w0.clone(), r0.clone()
    _, _, d_k, z_k = fc.fused_update(cv, alpha, pn_k, ap_k, sc2, w_k, r_k)
    d_p, z_p = fc.fused_update_plain(cv, alpha, pn_k, ap_k, sc2, w_p, r_p)
    # Kernel C.
    c_k = ca.basis_sweep(cv, beta, p, z, cs, cw, g, sc2)
    c_p = tuple(torch.zeros_like(z) for _ in range(4))
    gram_p = ca.basis_sweep_plain(cv, beta, p, z, cs, cw, g, sc2, *c_p)
    # Kernel D, on kernel C's outputs (x, r updated in place).
    x_k, rd_k, x_p, rd_p = w0.clone(), r0.clone(), w0.clone(), r0.clone()
    _, _, p1_k, rr_k = ca.pair_update(cv, coefs, *c_k[:4], x_k, rd_k)
    p1_p = torch.zeros_like(z)
    rr_p = ca.pair_update_plain(cv, coefs, *c_k[:4], x_p, rd_p, p1_p)
    torch.cuda.synchronize()

    def max_err(pairs) -> float:
        return max(float((a - b).abs().max()) for a, b in pairs)

    gk, gp = c_k[4].double().sum(dim=0), gram_p.double().sum(dim=0)
    checks = {
        "direction_stencil": (max_err([(pn_k, pn_p), (ap_k, ap_p)]),
                              rel_err(part_k.sum(), part_p.sum())),
        "fused_update": (max_err([(w_k, w_p), (r_k, r_p)]),
                         max(rel_err(d_k.sum(), d_p.sum()),
                             rel_err(z_k.sum(), z_p.sum()))),
        "basis_sweep": (max_err(zip(c_k[:4], c_p)),
                        max(rel_err(a, b) for a, b in zip(gk, gp))),
        "pair_update": (max_err([(x_k, x_p), (rd_k, rd_p), (p1_k, p1_p)]),
                        rel_err(rr_k.sum(), rr_p.sum())),
    }
    for name, (err, rel) in checks.items():
        print(f"kernel {name} {tag}: max_abs_err={err!r} (tol {FIELD_TOL}) "
              f"partial_sum_rel_err={rel!r} (tol {SUM_TOL})", flush=True)
        check(err <= FIELD_TOL, f"{name} {tag}: max abs error {err}")
        check(rel <= SUM_TOL, f"{name} {tag}: partial-sum error {rel}")
        record_err(errors, name, err)
    check(checks["basis_sweep"][0] == 0.0,
          f"basis_sweep {tag}: fields not bit for bit with the plain version")
    print(f"kernel basis_sweep {tag} geometry: " + json.dumps(
        ca.sweep_geometry(cv, *ca.sweep_card(0))._asdict()), flush=True)

    # Kernel S on the partials of A (one vector), B (two rows of one
    # buffer), C (twelve, strided) and D, in the runs of the serial mode:
    # bit for bit with its plain version.
    run, ca_run = fc.serial_run(cv, M - 1), ca.ca_run(problem, cv, True)
    check_serial(sr, tag, {"A": (part_k, run), "B": ((d_k, z_k), run),
                           "C": (c_k[4].T, ca_run), "D": (rr_k, ca_run)},
                 errors)

    # Timers. Inputs stay resident between launches, as in the solve loops.
    c_out = tuple(torch.zeros_like(z) for _ in range(4))
    p1_out = torch.zeros_like(z)
    gram_t = c_k[4].T
    chains = results.setdefault("serial_chain", {})
    chains[tag] = serial_chain_bound(sr, part_k, run)
    chains[f"{tag}-C"] = serial_chain_bound(sr, gram_t, ca_run)
    return [
        timer(results, "serial_sum", tag,
              lambda: sr.serial_sum(part_k, run),
              lambda: sr.serial_sum_plain(part_k, run), 200, 5,
              part_k.numel(), nbytes=(part_k.numel() + 1) * 4,
              library=lambda: torch.sum(part_k)),
        timer(results, "serial_sum", f"{tag}-C",
              lambda: sr.serial_sum(gram_t, ca_run),
              lambda: sr.serial_sum_plain(gram_t, ca_run), 200, 5,
              gram_t.numel(), nbytes=(gram_t.numel() + 12) * 4,
              library=lambda: torch.sum(c_k[4], dim=0)),
        timer(results, "direction_stencil", tag,
              lambda: fc.direction_and_stencil(cv, beta, z, p, cs, cw, g,
                                               out=(pn_k, ap_k)),
              lambda: fc.direction_and_stencil_plain(cv, beta, z, p, cs, cw,
                                                     g, pn_p, ap_p),
              200, 20, points),
        timer(results, "fused_update", tag,
              lambda: fc.fused_update(cv, alpha, pn_k, ap_k, sc2, w_k, r_k),
              lambda: fc.fused_update_plain(cv, alpha, pn_k, ap_k, sc2, w_p,
                                            r_p),
              200, 20, points),
        timer(results, "basis_sweep", tag,
              lambda: ca.basis_sweep(cv, beta, p, z, cs, cw, g, sc2,
                                     out=c_out),
              lambda: ca.basis_sweep_plain(cv, beta, p, z, cs, cw, g, sc2,
                                           *c_p),
              200, 10, points),
        timer(results, "pair_update", tag,
              lambda: ca.pair_update(cv, coefs, *c_k[:4], x_k, rd_k,
                                     out=p1_out),
              lambda: ca.pair_update_plain(cv, coefs, *c_k[:4], x_p, rd_p,
                                           p1_p),
              200, 20, points),
    ]


def check_sharded_kernels(M: int, N: int, fc, ca, fs, sr, mesh,
                          results: dict, errors: dict):
    """Phase 3 for the sharded forms at one grid: kernels A and B on shard 0
    of the fused layout and C and D on shard 0 of the CA layout, on a 2×2
    mesh, with the widened bands, the column masks and inputs that are
    nonzero on every row and column (halo rows and columns included),
    against their plain versions, and kernel S on their partials in the
    shard's runs. Returns the functions that time them."""
    from poisson_tpu_torch.config import Problem

    problem = Problem(M=M, N=N)
    rng = np.random.default_rng(M + 1)
    beta = torch.tensor(0.37, dtype=torch.float32, device="cuda")
    alpha = torch.tensor(0.21, dtype=torch.float32, device="cuda")
    coefs = torch.tensor([0.31, 0.22, 0.07, 0.25, 0.15, 0.0, 0.0, 0.0],
                         dtype=torch.float32, device="cuda")
    tag = f"{M}x{N}-{SHARD_GRID[0]}x{SHARD_GRID[1]}"
    h = fc.HALO

    def anywhere(cv):
        x = rng.standard_normal((cv.rows, cv.cols)).astype(np.float32)
        return torch.tensor(x, device="cuda")

    spec, sh = fs.shard_canvases(problem, mesh, 1)
    cv = spec.cv
    band = (h - 1, h + spec.m_blk + 1)
    a_in = (sh.cs[0], sh.cw[0], sh.g[0])
    mask, sc2 = sh.colmask[0], sh.sc2[0]
    z, p, w0, r0 = (anywhere(cv) for _ in range(4))
    pn_k, ap_k, part_k = fc.direction_and_stencil(cv, beta, z, p, *a_in,
                                                  band=band, colmask=mask)
    pn_p, ap_p = torch.zeros_like(z), torch.zeros_like(z)
    part_p = fc.direction_and_stencil_plain(cv, beta, z, p, *a_in, pn_p,
                                            ap_p, band, mask)
    w_k, r_k, w_p, r_p = w0.clone(), r0.clone(), w0.clone(), r0.clone()
    _, _, d_k, z_k = fc.fused_update(cv, alpha, pn_k, ap_k, sc2, w_k, r_k,
                                     colmask=mask)
    d_p, z_p = fc.fused_update_plain(cv, alpha, pn_k, ap_k, sc2, w_p, r_p,
                                     mask)

    cspec, csh = fs.shard_canvases(problem, mesh, 2)
    ccv = cspec.cv
    cband = (h - 2, h + cspec.m_blk + 2)
    c_in = (csh.cs[0], csh.cw[0], csh.g[0], csh.sc2[0])
    cmask = csh.colmask[0]
    pprev, rc, x0, rd0 = (anywhere(ccv) for _ in range(4))
    c_k = ca.basis_sweep(ccv, beta, pprev, rc, *c_in, band=cband,
                         colmask=cmask)
    c_p = tuple(torch.zeros_like(rc) for _ in range(4))
    gram_p = ca.basis_sweep_plain(ccv, beta, pprev, rc, *c_in, *c_p, cband,
                                  cmask)
    x_k, rd_k, x_p, rd_p = x0.clone(), rd0.clone(), x0.clone(), rd0.clone()
    _, _, p1_k, rr_k = ca.pair_update(ccv, coefs, *c_k[:4], x_k, rd_k,
                                      colmask=cmask)
    p1_p = torch.zeros_like(rc)
    rr_p = ca.pair_update_plain(ccv, coefs, *c_k[:4], x_p, rd_p, p1_p, cmask)
    torch.cuda.synchronize()

    def max_err(pairs) -> float:
        return max(float((a - b).abs().max()) for a, b in pairs)

    gk, gp = c_k[4].double().sum(dim=0), gram_p.double().sum(dim=0)
    checks = {
        "direction_stencil_sharded": (
            max_err([(pn_k, pn_p), (ap_k, ap_p)]),
            rel_err(part_k.sum(), part_p.sum())),
        "fused_update_sharded": (
            max_err([(w_k, w_p), (r_k, r_p)]),
            max(rel_err(d_k.sum(), d_p.sum()), rel_err(z_k.sum(),
                                                       z_p.sum()))),
        # Some Gram entries are sums of terms of both signs: relative to
        # the largest entry.
        "basis_sweep_sharded": (
            max_err(zip(c_k[:4], c_p)),
            float((gk - gp).abs().max() / gp.abs().max())),
        "pair_update_sharded": (
            max_err([(x_k, x_p), (rd_k, rd_p), (p1_k, p1_p)]),
            rel_err(rr_k.sum(), rr_p.sum())),
    }
    for name, (err, rel) in checks.items():
        print(f"kernel {name} {tag} (shard canvas {cv.rows}x{cv.cols}): "
              f"max_abs_err={err!r} (tol {FIELD_TOL}) "
              f"partial_sum_rel_err={rel!r} (tol {SUM_TOL})", flush=True)
        check(err <= FIELD_TOL, f"{name} {tag}: max abs error {err}")
        check(rel <= SUM_TOL, f"{name} {tag}: partial-sum error {rel}")
        record_err(errors, name, err)
    check(checks["basis_sweep_sharded"][0] == 0.0,
          f"basis_sweep_sharded {tag}: fields not bit for bit with the plain "
          "version")
    print(f"kernel basis_sweep_sharded {tag} geometry: " + json.dumps(
        ca.sweep_geometry(ccv, *ca.sweep_card(0))._asdict()), flush=True)
    run = fs.shard_run(problem, spec, mesh, True)
    crun = fs.shard_run(problem, cspec, mesh, True, ca.CA_BUFFERS)
    check_serial(sr, tag, {"A sharded": (part_k, run),
                           "B sharded": ((d_k, z_k), run),
                           "C sharded": (c_k[4].T, crun),
                           "D sharded": (rr_k, crun)}, errors)

    points, cpoints = spec.m_blk * cv.cols, cspec.m_blk * ccv.cols
    c_out = tuple(torch.zeros_like(rc) for _ in range(4))
    p1_out = torch.zeros_like(rc)
    return [
        timer(results, "direction_stencil_sharded", tag,
              lambda: fc.direction_and_stencil(cv, beta, z, p, *a_in,
                                               out=(pn_k, ap_k), band=band,
                                               colmask=mask),
              lambda: fc.direction_and_stencil_plain(cv, beta, z, p, *a_in,
                                                     pn_p, ap_p, band, mask),
              200, 20, points, cols=cv.cols),
        timer(results, "fused_update_sharded", tag,
              lambda: fc.fused_update(cv, alpha, pn_k, ap_k, sc2, w_k, r_k,
                                      colmask=mask),
              lambda: fc.fused_update_plain(cv, alpha, pn_k, ap_k, sc2, w_p,
                                            r_p, mask),
              200, 20, points, cols=cv.cols),
        timer(results, "basis_sweep_sharded", tag,
              lambda: ca.basis_sweep(ccv, beta, pprev, rc, *c_in, out=c_out,
                                     band=cband, colmask=cmask),
              lambda: ca.basis_sweep_plain(ccv, beta, pprev, rc, *c_in, *c_p,
                                           cband, cmask),
              200, 10, cpoints, cols=ccv.cols),
        timer(results, "pair_update_sharded", tag,
              lambda: ca.pair_update(ccv, coefs, *c_k[:4], x_k, rd_k,
                                     out=p1_out, colmask=cmask),
              lambda: ca.pair_update_plain(ccv, coefs, *c_k[:4], x_p, rd_p,
                                           p1_p, cmask),
              200, 20, cpoints, cols=ccv.cols),
    ]


def check_sweeps(problem, bn, fc, sr, results: dict, errors: dict,
                 setup: dict):
    """Phase 3 for kernels A and B, or A′ and B′ on a column-blocked canvas
    (``canvas_spec(problem, bn=bn)``): the wrappers against the plain
    versions of the canvas's kernels, on seeded content, and kernel S on
    their partials in the canvas's runs. Records the host seconds of the
    canvases' first build in ``setup`` and returns the functions that time
    the two kernels, whose bytes and bound count the grid's interior on a
    blocked canvas (``fused_cg.sweep_points``): its padding is reported on a
    line of its own."""
    t0 = time.perf_counter()
    cv, cs, cw, g, rhs, sc2, _ = fc.build_canvases(problem, "cuda", bn=bn)
    torch.cuda.synchronize()
    setup[(problem, bn)] = time.perf_counter() - t0
    M, N = problem.M, problem.N
    rng = np.random.default_rng(M + N)
    blocked = bool(cv.cg)
    names = (("direction_stencil_blocked", "fused_update_blocked") if blocked
             else ("direction_stencil", "fused_update"))
    a_plain = (fc.direction_and_stencil_blocked_plain if blocked
               else fc.direction_and_stencil_plain)
    b_plain = (fc.fused_update_blocked_plain if blocked
               else fc.fused_update_plain)
    tag = f"{M}x{N}" + (f"-bn{cv.bn}" if blocked and M != WIDE["M"] else "")

    def content_random():
        x = np.zeros((cv.rows, cv.cols), np.float32)
        x[fc.HALO : fc.HALO + M - 1, cv.cg + 1 : cv.cg + N] = (
            rng.standard_normal((M - 1, N - 1), dtype=np.float32))
        return torch.tensor(x, device="cuda")

    z, p, w0, r0 = (content_random() for _ in range(4))
    beta = torch.tensor(0.37, dtype=torch.float32, device="cuda")
    alpha = torch.tensor(0.21, dtype=torch.float32, device="cuda")
    pn_k, ap_k, part_k = fc.direction_and_stencil(cv, beta, z, p, cs, cw, g)
    pn_p, ap_p = torch.zeros_like(z), torch.zeros_like(z)
    part_p = a_plain(cv, beta, z, p, cs, cw, g, pn_p, ap_p)
    w_k, r_k, w_p, r_p = w0.clone(), r0.clone(), w0.clone(), r0.clone()
    _, _, d_k, z_k = fc.fused_update(cv, alpha, pn_k, ap_k, sc2, w_k, r_k)
    d_p, z_p = b_plain(cv, alpha, pn_k, ap_k, sc2, w_p, r_p)
    torch.cuda.synchronize()

    def max_err(pairs) -> float:
        return max(float((a - b).abs().max()) for a, b in pairs)

    checks = {
        names[0]: (max_err([(pn_k, pn_p), (ap_k, ap_p)]),
                   rel_err(part_k.double().sum(), part_p.double().sum())),
        names[1]: (max_err([(w_k, w_p), (r_k, r_p)]),
                   max(rel_err(d_k.double().sum(), d_p.double().sum()),
                       rel_err(z_k.double().sum(), z_p.double().sum()))),
    }
    for name, (err, rel) in checks.items():
        print(f"kernel {name} {tag} (canvas {cv.rows}x{cv.cols}, bn "
              f"{cv.bn}, ncb {cv.ncb}): max_abs_err={err!r} (tol "
              f"{FIELD_TOL}) partial_sum_rel_err={rel!r} (tol {SUM_TOL})",
              flush=True)
        check(err <= FIELD_TOL, f"{name} {tag}: max abs error {err}")
        check(rel <= SUM_TOL, f"{name} {tag}: partial-sum error {rel}")
        record_err(errors, name, err)
    run = fc.serial_run(cv, M - 1)
    check_serial(sr, f"{tag} (canvas {cv.rows}x{cv.cols})",
                 {names[0]: (part_k, run), names[1]: ((d_k, z_k), run)},
                 errors)

    points = fc.sweep_points(problem, cv)
    if blocked:
        swept = (cv.rows - 2 * fc.HALO) * (cv.cols - 2 * cv.cg)
        print(f"blocked padding {tag}: " + json.dumps({
            "canvas": [cv.rows, cv.cols], "bn": cv.bn, "ncb": cv.ncb,
            "swept_points": swept, "content_points": points,
            "swept_over_content": swept / points}), flush=True)
    return [
        timer(results, names[0], tag,
              lambda: fc.direction_and_stencil(cv, beta, z, p, cs, cw, g,
                                               out=(pn_k, ap_k)),
              lambda: a_plain(cv, beta, z, p, cs, cw, g, pn_p, ap_p),
              100, 5, points),
        timer(results, names[1], tag,
              lambda: fc.fused_update(cv, alpha, pn_k, ap_k, sc2, w_k, r_k),
              lambda: b_plain(cv, alpha, pn_k, ap_k, sc2, w_p, r_p),
              100, 5, points),
    ]


def check_resident_fallback(problem, fc, rs, errors: dict) -> None:
    """Kernel R at a grid whose state does not all fit on chip (the layout
    leaves a field or some points in device memory) against its plain
    version, after the problem's iteration cap."""
    cv, cs, cw, g, rhs, sc2, _ = fc.build_canvases(problem, "cuda")
    lay = rs.resident_layout(cv, *rs.card_geometry(0))
    w, k, _, _ = rs.resident_solve(problem, cv, cs, cw, g, rhs, sc2)
    wp, kp, _, _ = rs.resident_solve_plain(problem, cv, cs, cw, g, rhs, sc2)
    torch.cuda.synchronize()
    rel = float((w - wp).abs().max() / wp.abs().max())
    print(f"kernel resident_solve {problem.M}x{problem.N} fallback: " +
          json.dumps({"iterations": int(k), "plain_iterations": int(kp),
                      "fields_in_device_memory": [
                          f for f, o in zip(rs.FIELDS, lay.offsets) if o < 0],
                      "points_past_registers": lay.points_per_thread
                      - lay.reg_points, "blocks": lay.blocks,
                      "iterate_rel_diff": rel}), flush=True)
    check(int(k) == int(kp) == problem.iteration_cap,
          f"resident fallback {problem.M}x{problem.N}: {int(k)} / {int(kp)} "
          "iterations")
    check(rel <= FALLBACK_TOL, f"resident fallback {problem.M}x{problem.N}: "
                               f"iterate {rel} from its plain version")


def driven_steps(needed: int, cap: int, check_every: int) -> int:
    """Steps ``solvers.pcg.drive`` runs for a solve whose state is done
    after ``needed`` steps: up to the next read of ``done``, at most
    ``cap``."""
    return min(cap, -(-needed // check_every) * check_every)


def chunk_steps(start: int, done_at: int, cap: int, chunk: int,
                check_every: int, per_step: int = 1) -> int:
    """Steps ``drive`` runs over a chunked solve (``run_chunked``) from
    iteration ``start`` that stops at ``done_at`` (its converged count, or
    its cap): each chunk runs to min(k + chunk, cap) in steps of
    ``per_step`` iterations (pairs on the CA path), or up to the first read
    of ``done`` after ``done_at``."""
    k, total = start, 0
    while k < min(done_at, cap):
        steps = -(-(min(k + chunk, cap) - k) // per_step)
        ran = driven_steps(-(-(done_at - k) // per_step), steps, check_every)
        total += ran
        k = min(k + ran * per_step, done_at)
    return total


def single_counts(counts: dict) -> dict:
    """The counts of the single-device full-width forms."""
    return {k: v for k, v in counts.items()
            if not k.endswith(("_sharded", "_blocked"))}


def blocked_counts(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if k.endswith("_blocked")}


def sharded_counts(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if k.endswith("_sharded")}


# The wrappers whose forms each kernel module launches (the keys of
# ``ops.launch.launch_counts``).
FUSED = ("direction_and_stencil", "fused_update")
CA = ("basis_sweep", "pair_update")
RESIDENT = ("resident_solve",)
SERIAL = ("serial_sum",)
# The fused iteration's scalar recurrence (``ops.recurrence``): one launch
# of each a driven step of the fused or the sharded body on a card (on the
# mesh's lead card, whatever the shards), none on the CA paths.
RECURRENCE = ("recurrence_step", "recurrence_close")


def recurrence_counts(steps: int) -> dict:
    """The launches of the recurrence's kernels over ``steps`` driven steps
    of the fused or the sharded body."""
    return dict.fromkeys(RECURRENCE, steps)


class LaunchGate:
    """The kernels' launches since :meth:`reset` (the ``ops.launches.*``
    counters of ``obs.metrics``), held against what a phase may launch.
    A phase may clear the registry itself (``metrics.reset()``), and with
    it those counters; while the gate is installed, each clear first
    carries the launch counts it drops into the gate, so a gate covers its
    whole phase, not the tail after the phase's last clear."""

    def __init__(self) -> None:
        from poisson_tpu_torch.obs import metrics
        from poisson_tpu_torch.ops import launch

        self._metrics, self._launch = metrics, launch
        self._clear = metrics.reset
        self.carried: dict = {}

    def _carry_and_clear(self) -> None:
        for key, n in self._launch.launch_counts().items():
            self.carried[key] = self.carried.get(key, 0) + n
        self._clear()

    def install(self) -> "LaunchGate":
        self._metrics.reset = self._carry_and_clear
        return self

    __enter__ = install

    def __exit__(self, *exc) -> None:
        self._metrics.reset = self._clear

    def reset(self) -> None:
        self.carried.clear()
        self._launch.reset_launch_counts()

    def counts(self, *wrappers: str) -> dict:
        """The launches of each form of ``wrappers`` (of all when none is
        named) since the last :meth:`reset`."""
        return {key: n + self.carried.get(key, 0) for key, n in
                self._launch.launch_counts(*wrappers).items()}

    def expect(self, path: str, want: dict) -> None:
        """Every kernel launched exactly as often as ``want`` says since
        the last :meth:`reset`, and the kernels it leaves out never."""
        got = self.counts()
        print(f"launches on {path}: {json.dumps(got)}", flush=True)
        for name, n in got.items():
            check(n == want.get(name, 0), f"{path}: {name} launched {n} "
                                          f"times, expected "
                                          f"{want.get(name, 0)}")


def check_sharded_replays(mesh, label: str) -> None:
    """The sharded kernels' launch counters held against the card, in one
    profiled 800x1200 fused-sharded solve on ``mesh`` after a warm solve
    that captures its blocks. A replayed block adds to the wrappers'
    counters the launches counted at its capture, so each count must equal
    the profiler's count of its kernel and shards x the steps ``drive``
    ran, every block replayed; across cards every replay spans them
    (``pcg.drive.multi_card_replays``)."""
    from poisson_tpu_torch.config import FLAGSHIP
    from poisson_tpu_torch.obs import metrics
    from poisson_tpu_torch.ops import launch
    from poisson_tpu_torch.parallel import fused_sharded as fs
    from poisson_tpu_torch.solvers.pcg import CHECK_EVERY

    cards = list(dict.fromkeys(mesh.devices))
    fs.fused_cg_solve_sharded(FLAGSHIP, mesh)          # captures
    launch.reset_launch_counts()
    before = {name: metrics.get(f"pcg.drive.{name}")
              for name in ("graph_replays", "multi_card_replays",
                           "eager_steps")}
    out = []

    def solve():
        out.append(fs.fused_cg_solve_sharded(FLAGSHIP, mesh))
        for card in cards:
            torch.cuda.synchronize(card)

    seen, _ = profile_kernels(solve)
    moved = {name: metrics.get(f"pcg.drive.{name}") - value
             for name, value in before.items()}
    k = int(out[0].iterations)
    check(k == 989, f"fused-sharded {label}: {k} iterations")
    steps = driven_steps(k, FLAGSHIP.iteration_cap, CHECK_EVERY)
    check(moved == {"graph_replays": steps // CHECK_EVERY,
                    "multi_card_replays": (steps // CHECK_EVERY
                                           if len(cards) > 1 else 0),
                    "eager_steps": 0},
          f"fused-sharded {label}: drive counted {moved} for {steps} steps "
          f"on {len(cards)} card(s)")
    wrapper = sharded_counts(launch.launch_counts(*FUSED))
    for name, symbol in (("direction_and_stencil_sharded",
                          "direction_stencil_sharded"),
                         ("fused_update_sharded", "fused_update_sharded")):
        on_card = sum(n for key, (n, _) in (seen or {}).items()
                      if named(key, symbol))
        check(wrapper[name] == on_card == mesh.size * steps,
              f"fused-sharded {label}: {wrapper[name]} {name} launches "
              f"counted, {on_card} {symbol} seen by the profiler, for "
              f"{mesh.size} shards x {steps} driven steps")
    recurrence = launch.launch_counts(*RECURRENCE)
    for name in RECURRENCE:
        on_card = sum(n for key, (n, _) in (seen or {}).items()
                      if named(key, f"{name}_kernel"))
        check(recurrence[name] == on_card == steps,
              f"fused-sharded {label}: {recurrence[name]} {name} launches "
              f"counted, {on_card} seen by the profiler, for {steps} "
              "driven steps on the lead card")
    print(f"replayed launches on the fused-sharded path, {label}: "
          f"{json.dumps({**wrapper, **recurrence})} (the profiler: "
          f"{mesh.size} shards x {steps} steps), drive: {json.dumps(moved)}",
          flush=True)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def solve_line(name: str, problem, r, seconds: float, l2, extra=None):
    iters = int(r.iterations)
    rec = {"iterations": iters, "diff": float(r.diff), "l2_error": l2,
           "seconds": seconds, "us_per_iter": seconds / iters * 1e6,
           "mlups": problem.interior_points * iters / seconds / 1e6}
    rec.update(extra or {})
    print(f"solve {name} {problem.M}x{problem.N}: {json.dumps(rec)}",
          flush=True)


def member_gap(got, want) -> tuple[bool, float]:
    """(bit for bit, max abs difference) of two iterates."""
    return bool(torch.equal(got, want)), float((got.double()
                                                - want.double()).abs().max())


def check_batched(bt, lanes, ps_mesh, flagship, mid, fp64, pcg_solve,
                  metrics, card: str) -> dict:
    """The batched phase (no kernel of the port): ``solve_batched`` at
    800x1200 against the sequential solves, fp64 golden members, a ragged
    bucket, a wide batch, a batch on the 2x2 mesh of the card against the
    unsharded batch, and a ``LaneBatch`` interleaving against solo solves.
    Returns what the profile section needs."""
    f32, f64 = torch.float32, torch.float64
    gates = [1.0 + i / BATCH for i in range(BATCH)]
    run16 = lambda: bt.solve_batched(flagship, rhs_gates=gates, dtype=f32)
    run16()                                            # first call
    torch.cuda.reset_peak_memory_stats()
    r16, sec = timed(run16)
    peak = torch.cuda.max_memory_allocated()
    seq, seq_sec = timed(lambda: [pcg_solve(flagship, dtype=f32, rhs_gate=g)
                                  for g in gates])
    iters = r16.iterations.tolist()
    bits, worst = True, 0.0
    for i, s in enumerate(seq):
        check(iters[i] == int(s.iterations) and int(r16.flag[i]) ==
              int(s.flag) == 1, f"batched member {i}: {iters[i]} iterations "
                                f"(flag {int(r16.flag[i])}), sequential "
                                f"{int(s.iterations)} ({int(s.flag)})")
        same, gap = member_gap(r16.w[i], s.w)
        bits, worst = bits and same, max(worst, gap)
    check(worst <= BATCH_MEMBER_TOL, f"batched members {worst} from their "
                                     "sequential solves")
    _, vs64 = member_gap(r16.w[0], fp64[flagship].w)
    check(vs64 <= ITERATE_TOL, f"batched member 0: {vs64} from fp64")
    k = int(r16.max_iterations)
    print(f"batched fp32 800x1200 B={BATCH} [{card}]: " + json.dumps({
        "batch_seconds": sec, "solves_per_sec": BATCH / sec,
        "max_iterations": k, "us_per_batched_iteration": sec / k * 1e6,
        "sequential_seconds": seq_sec, "speedup_vs_sequential": seq_sec / sec,
        "max_memory_allocated_bytes": peak, "iterations": iters,
        "bit_for_bit_with_sequential": bits, "max_member_gap": worst,
        "member0_vs_fp64": vs64}), flush=True)

    r64d, sec64d = timed(lambda: bt.solve_batched(
        flagship, rhs_gates=[1.0] * BATCH_FP64, dtype=f64))
    bits64 = all(torch.equal(w, fp64[flagship].w) for w in r64d.w)
    gap64 = max(member_gap(w, fp64[flagship].w)[1] for w in r64d.w)
    check(r64d.iterations.tolist() == [989] * BATCH_FP64
          and r64d.flag.tolist() == [1] * BATCH_FP64,
          f"batched fp64: {r64d.iterations.tolist()} iterations")
    check(gap64 <= SHARDED_FP64_TOL, f"batched fp64: {gap64} from pcg_solve")
    print(f"batched fp64 800x1200 B={BATCH_FP64} [{card}]: " + json.dumps({
        "seconds": sec64d, "iterations": r64d.iterations.tolist(),
        "bit_for_bit_with_sequential": bits64, "max_member_gap": gap64}),
        flush=True)

    # Ragged: 13 members at their own size, then padded to a pinned bucket
    # of 16 (what the padding costs). The full bucket's result is read
    # where solve_batched slices it.
    ids13 = [f"m{i}" for i in range(BATCH_RAGGED)]
    re, sec13 = timed(lambda: bt.solve_batched(
        flagship, rhs_gates=gates[:BATCH_RAGGED], dtype=f32,
        member_ids=ids13))
    full = {}
    sliced = bt.sliced
    bt.sliced = lambda result, n, origin: (
        full.setdefault("r", result), sliced(result, n, origin))[1]
    pad0 = metrics.get("batched.padding_members")
    try:
        rr, sec13p = timed(lambda: bt.solve_batched(
            flagship, rhs_gates=gates[:BATCH_RAGGED], dtype=f32,
            member_ids=ids13, bucket=BATCH))
    finally:
        bt.sliced = sliced
    pad = full["r"]
    padding = metrics.get("batched.padding_members") - pad0
    check(tuple(pad.w.shape[:1]) == (BATCH,) and rr.w.shape[0] == BATCH_RAGGED
          and padding == BATCH - BATCH_RAGGED,
          f"ragged: bucket {tuple(pad.w.shape)}, {padding} padding members")
    check(pad.iterations[BATCH_RAGGED:].tolist() == [1] * padding
          and pad.flag[BATCH_RAGGED:].tolist() == [2] * padding,
          f"ragged: padding members stopped at "
          f"{pad.iterations[BATCH_RAGGED:].tolist()} with flags "
          f"{pad.flag[BATCH_RAGGED:].tolist()}, expected breakdown at 1")
    check(all(r.iterations.tolist() == iters[:BATCH_RAGGED]
              and all(torch.equal(r.w[i], r16.w[i])
                      for i in range(BATCH_RAGGED))
              and r.origin == tuple(ids13) for r in (re, rr)),
          "ragged: the members differ from the full batch's")
    print(f"batched ragged 800x1200 B={BATCH_RAGGED} bucket {BATCH} [{card}]: "
          + json.dumps({"seconds": sec13, "seconds_padded": sec13p,
                        "padding_members": padding,
                        "padding_iterations":
                            pad.iterations[BATCH_RAGGED:].tolist(),
                        "padding_flags": pad.flag[BATCH_RAGGED:].tolist()}),
          flush=True)

    wide_gates = [1.0 + i / BATCH_WIDE for i in range(BATCH_WIDE)]
    torch.cuda.reset_peak_memory_stats()
    rw, secw = timed(lambda: bt.solve_batched(flagship, rhs_gates=wide_gates,
                                              dtype=f32))
    peakw = torch.cuda.max_memory_allocated()
    check(int(rw.iterations[0]) == 989 and set(rw.flag.tolist()) == {1},
          f"batched B={BATCH_WIDE}: member 0 {int(rw.iterations[0])} "
          f"iterations, flags {set(rw.flag.tolist())}")
    kw = int(rw.max_iterations)
    print(f"batched fp32 800x1200 B={BATCH_WIDE} [{card}]: " + json.dumps({
        "batch_seconds": secw, "solves_per_sec": BATCH_WIDE / secw,
        "max_iterations": kw, "us_per_batched_iteration": secw / kw * 1e6,
        "max_memory_allocated_bytes": peakw}), flush=True)

    # The 2x2 mesh of the one card against the unsharded batch.
    one = [1.0] * BATCH_MESH
    flat = bt.solve_batched(mid, rhs_gates=one, dtype=f64)
    rm, secm = timed(lambda: bt.solve_batched(mid, rhs_gates=one, dtype=f64,
                                              mesh=ps_mesh))
    gapm = float((rm.w - flat.w).abs().max())
    check(rm.iterations.tolist() == flat.iterations.tolist()
          == [546] * BATCH_MESH and rm.flag.tolist() == [1] * BATCH_MESH,
          f"batched mesh: {rm.iterations.tolist()} iterations, unsharded "
          f"{flat.iterations.tolist()}")
    check(gapm <= SHARDED_FP64_TOL, f"batched mesh: {gapm} from unsharded")
    print(f"batched fp64 400x600 B={BATCH_MESH} mesh 2x2 [{card}]: "
          + json.dumps({"seconds": secm, "iterations":
                        rm.iterations.tolist(), "max_diff_vs_unsharded":
                        gapm}), flush=True)

    # Lanes: a fixed interleaving; splices at most two a step.
    lane_gates = {f"r{i}": 1.0 + i / LANE_MEMBERS for i in range(LANE_MEMBERS)}
    table = lanes.LaneBatch(mid, LANE_BUCKET, dtype=f32, chunk=LANE_CHUNK)
    queue, done = list(lane_gates), {}
    t0 = time.perf_counter()
    for mid_ in queue[:5]:
        table.splice(mid_, lane_gates[mid_])
    queue = queue[5:]
    while len(done) < LANE_MEMBERS:
        check(table.steps < 200, "lanes: the schedule did not drain")
        table.step()
        for view in table.lane_view():
            if view["member_id"] is not None and view["done"]:
                res = table.retire(view["lane"])
                done[res.member_id] = res
        for mid_ in queue[:2]:
            if table.free_lanes():
                table.splice(mid_, lane_gates[mid_])
                queue.remove(mid_)
    torch.cuda.synchronize()
    lane_sec = time.perf_counter() - t0
    # Each retired member against its solo solve: the first and the last
    # by pcg_solve itself, every one by its member of one batched solve
    # (member i of a batch is pcg_solve(rhs_gate=g_i), checked above).
    ids = list(lane_gates)
    solo = bt.solve_batched(mid, rhs_gates=list(lane_gates.values()),
                            dtype=f32, member_ids=ids)
    for i in (0, LANE_MEMBERS - 1):
        one = pcg_solve(mid, dtype=f32, rhs_gate=lane_gates[ids[i]])
        check(torch.equal(one.w, solo.w[i]) and int(one.iterations)
              == int(solo.iterations[i]), f"lanes: member {ids[i]}'s "
                                          "pcg_solve differs from its batch")
    lbits, lworst = True, 0.0
    for i, mid_ in enumerate(ids):
        res = done[mid_]
        check(res.iterations == int(solo.iterations[i]) and res.flag == 1,
              f"lane {mid_}: {res.iterations} iterations, solo "
              f"{int(solo.iterations[i])}")
        same, gap = member_gap(res.w, solo.w[i])
        lbits, lworst = lbits and same, max(lworst, gap)
    check(lworst <= BATCH_MEMBER_TOL, f"lanes: {lworst} from solo solves")
    print(f"lanes fp32 400x600 bucket {LANE_BUCKET} [{card}]: " + json.dumps({
        "members": LANE_MEMBERS, "chunk": LANE_CHUNK, "steps": table.steps,
        "idle_lane_steps": table.idle_lane_steps, "seconds": lane_sec,
        "iterations": {m: done[m].iterations for m in ids},
        "bit_for_bit_with_solo": lbits, "max_member_gap": lworst}),
        flush=True)
    return {"gates": gates}


def check_mg(mg, bt, lanes, ck, pcg_solve, fp64: dict, figures: dict,
             card: str) -> None:
    """The MG phase (no kernel of the port): ``pcg_solve(preconditioner=
    "mg")`` in fp64 and fp32 at each grid of MG_GRIDS, timed beside the
    plain Jacobi solve and the kernel paths' figures of this run, then a
    batch against its sequential solves, a lane interleaving, a chunked
    solve and a checkpoint drill, each bit for bit where it should be."""
    from poisson_tpu_torch.config import Problem

    f32, f64 = torch.float32, torch.float64
    flag_mg = {}
    for M, N, want64, want32, jax32 in MG_GRIDS:
        p = Problem(M=M, N=N)
        tag = f"{M}x{N}"
        hier64, build64 = timed(lambda: mg.device_hierarchy(
            p, "float64", False, device="cuda"))
        r64, sec64 = timed(lambda: pcg_solve(p, dtype=f64,
                                             preconditioner="mg"))
        k64 = int(r64.iterations)
        check(k64 == want64 and int(r64.flag) == 1,
              f"MG fp64 {tag}: {k64} iterations (flag {int(r64.flag)}), "
              f"expected {want64}")
        _, build32 = timed(lambda: mg.device_hierarchy(
            p, "float32", True, device="cuda"))
        run32 = lambda: pcg_solve(p, dtype=f32, preconditioner="mg")
        run32()                                        # warm-up
        each = []
        for _ in range(REPEATS):
            r32, s = timed(run32)
            each.append(s)
        k32 = int(r32.iterations)
        check(int(r32.flag) == 1 and float(r32.diff) < p.delta,
              f"MG fp32 {tag}: flag {int(r32.flag)}, diff {float(r32.diff)}")
        check(want32 is None or k32 == want32,
              f"MG fp32 {tag}: {k32} iterations, expected {want32}")
        gap32 = float((r32.w.double() - r64.w).abs().max())
        check(gap32 <= MG_FP32_TOL, f"MG fp32 {tag}: {gap32} from fp64 MG")
        jac, jac_sec = timed(lambda: pcg_solve(p, dtype=f32))
        best = min(each)
        rec = {
            "levels": len(hier64.levels),
            "coarse_dense": hier64.coarse_inv is not None,
            "hierarchy_build_s": {"float64": build64, "float32": build32},
            "fp64": {"iterations": k64, "seconds": sec64},
            "fp32": {"iterations": k32, "jax_iterations": jax32,
                     "seconds": best, "seconds_each": each,
                     "us_per_iter": best / k32 * 1e6,
                     "max_diff_vs_fp64_mg": gap32},
            "jacobi_fp32": {"iterations": int(jac.iterations),
                            "seconds": jac_sec,
                            "us_per_iter": jac_sec / int(jac.iterations)
                            * 1e6},
            **figures.get(tag, {})}
        if p in fp64:
            rec["fp64"]["max_diff_vs_fp64_jacobi"] = float(
                (r64.w - fp64[p].w).abs().max())
        if tag in MG_TIGHT:
            tight = pcg_solve(p.with_(delta=MG_TIGHT_DELTA), dtype=f64)
            gap = float((r64.w - tight.w).abs().max())
            check(gap <= MG_JACOBI_TOL, f"MG fp64 {tag}: {gap} from the "
                                        "converged fp64 Jacobi solve")
            rec["fp64"]["max_diff_vs_converged_jacobi"] = gap
            rec["fp64"]["converged_jacobi"] = {
                "delta": MG_TIGHT_DELTA, "iterations": int(tight.iterations)}
        print(f"mg {tag} [{card}]: {json.dumps(rec)}", flush=True)
        flag_mg[tag] = r32

    flagship = Problem(*MG_FLAGSHIP)
    ftag = "x".join(map(str, MG_FLAGSHIP))
    one = flag_mg[ftag]
    gates = [1.0 + i / MG_BATCH for i in range(MG_BATCH)]
    run = lambda: bt.solve_batched(flagship, rhs_gates=gates, dtype=f32,
                                   preconditioner="mg")
    run()                                              # first call
    rb, sec = timed(run)
    seq, seq_sec = timed(lambda: [pcg_solve(flagship, dtype=f32, rhs_gate=g,
                                            preconditioner="mg")
                                  for g in gates])
    for i, sq in enumerate(seq):
        check(int(rb.iterations[i]) == int(sq.iterations)
              and int(rb.flag[i]) == int(sq.flag) == 1
              and torch.equal(rb.w[i], sq.w),
              f"MG batched member {i}: {int(rb.iterations[i])} iterations "
              f"(flag {int(rb.flag[i])}), sequential {int(sq.iterations)} "
              f"({int(sq.flag)}), bits equal {torch.equal(rb.w[i], sq.w)}")
    print(f"mg batched fp32 {ftag} B={MG_BATCH} [{card}]: " + json.dumps({
        "batch_seconds": sec, "solves_per_sec": MG_BATCH / sec,
        "max_iterations": int(rb.max_iterations),
        "iterations": rb.iterations.tolist(), "sequential_seconds": seq_sec,
        "speedup_vs_sequential": seq_sec / sec,
        "bit_for_bit_with_sequential": True}), flush=True)

    mid = Problem(*MG_MID)
    bucket, members, chunk = MG_LANES
    lane_gates = {f"m{i}": 1.0 + i / members for i in range(members)}
    table = lanes.LaneBatch(mid, bucket, dtype=f32, chunk=chunk,
                            preconditioner="mg")
    queue, done = list(lane_gates), {}
    while len(done) < members:
        check(table.steps < 100, "MG lanes: the schedule did not drain")
        for mid_ in queue[:len(table.free_lanes())]:
            table.splice(mid_, lane_gates[mid_])
            queue.remove(mid_)
        table.step()
        for view in table.lane_view():
            if view["member_id"] is not None and view["done"]:
                res = table.retire(view["lane"])
                done[res.member_id] = res
    for mid_, g in lane_gates.items():
        solo = pcg_solve(mid, dtype=f32, rhs_gate=g, preconditioner="mg")
        res = done[mid_]
        check(res.iterations == int(solo.iterations) and res.flag == 1
              and torch.equal(res.w, solo.w),
              f"MG lane {mid_}: {res.iterations} iterations, solo "
              f"{int(solo.iterations)}, bits equal "
              f"{torch.equal(res.w, solo.w)}")
    print(f"mg lanes fp32 {mid.M}x{mid.N} bucket {bucket} [{card}]: "
          + json.dumps({
        "members": members, "chunk": chunk, "steps": table.steps,
        "iterations": {m: r.iterations for m, r in done.items()},
        "bit_for_bit_with_solo": True}), flush=True)

    chunked = ck.pcg_solve_chunked(flagship, chunk=MG_CHUNK, dtype=f32,
                                   preconditioner="mg")
    check(int(chunked.iterations) == int(one.iterations)
          and torch.equal(chunked.w, one.w),
          f"MG chunked: {int(chunked.iterations)} iterations, one-shot "
          f"{int(one.iterations)}, bits equal {torch.equal(chunked.w, one.w)}")
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_mg_",
                                     dir=root) as ckdir:
        path = os.path.join(ckdir, "mg.npz")
        capped = ck.pcg_solve_checkpointed(
            flagship.with_(max_iter=MG_CAP), path, chunk=MG_CHUNK,
            dtype=f32, preconditioner="mg")
        kept = os.path.exists(path)
        check(int(capped.iterations) == MG_CAP and kept,
              f"MG checkpoint: capped run {int(capped.iterations)} "
              f"iterations, file kept {kept}")
        resumed = ck.pcg_solve_checkpointed(flagship, path, chunk=MG_CHUNK,
                                            dtype=f32, preconditioner="mg")
        check(int(resumed.iterations) == int(one.iterations)
              and int(resumed.flag) == 1 and not os.path.exists(path),
              f"MG checkpoint: resumed to {int(resumed.iterations)} "
              f"iterations (flag {int(resumed.flag)}), one-shot "
              f"{int(one.iterations)}")
    print(f"mg chunked and checkpointed fp32 {ftag} chunk {MG_CHUNK} "
          f"[{card}]: " + json.dumps({
              "chunked_iterations": int(chunked.iterations),
              "chunked_bit_for_bit": True, "capped_at": MG_CAP,
              "resumed_iterations": int(resumed.iterations),
              "resumed_bit_for_bit": torch.equal(resumed.w, one.w)}),
          flush=True)


def check_geometry(pcg_solve, metrics, card: str) -> None:
    """The geometry phase (no kernel of the port): the flagship canvases of
    every family (host build seconds, the cache across a repeat, the
    default spec against the reference fields), fp64 and fp32 solves of
    each beside the reference ellipse's, the manufactured gate, a mixed
    batch and multi-geometry lanes bit for bit with their solo solves, an
    MG, a verified and a chunked geometry solve, and shape gradients."""
    from poisson_tpu_torch.config import Problem
    from poisson_tpu_torch.geometry import (
        DEFAULT_ELLIPSE,
        Ellipse,
        canvas,
        geometry_setup,
        reset_geometry_cache,
    )
    from poisson_tpu_torch.geometry.manufactured import (
        case_by_name,
        cases,
        manufactured_error,
    )
    from poisson_tpu_torch.mg.hierarchy import device_hierarchy
    from poisson_tpu_torch.solvers import adjoint
    from poisson_tpu_torch.solvers.batched import solve_batched
    from poisson_tpu_torch.solvers.checkpoint import pcg_solve_chunked
    from poisson_tpu_torch.solvers.lanes import LaneBatch
    from poisson_tpu_torch.solvers.pcg import host_fields64

    started = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    flagship = Problem(*GEOM_FLAGSHIP)
    ftag = "x".join(map(str, GEOM_FLAGSHIP))
    specs = {c.name: c.spec for c in cases()}

    # Canvases: the host fp64 builds, each timed (the sampled families in
    # blocks of faces on threads); then the cache across a repeat.
    reset_geometry_cache()
    build_s = {}
    for name, spec in specs.items():
        t0 = time.perf_counter()
        canvas.host_fields(flagship, spec)
        build_s[name] = time.perf_counter() - t0
    for dtype, scaled in (("float64", False), ("float32", True)):
        got = geometry_setup(flagship, DEFAULT_ELLIPSE, dtype, scaled,
                             device="cuda")
        want = host_fields64(flagship, scaled)
        for name, g, w in zip(("a", "b", "rhs", "aux"), got, want):
            ref = torch.tensor(w, dtype=getattr(torch, dtype), device="cuda")
            check(torch.equal(g, ref), f"geometry canvases: the default "
                                       f"spec's {name} ({dtype}) is not the "
                                       "reference field cast once")
    reset_geometry_cache()
    for name in specs:             # the host builds stay: a device miss
        canvas.host_fields(flagship, specs[name])
    misses, hits = [], []
    for _ in range(2):
        m0 = metrics.get("geom.cache.misses") or 0
        h0 = metrics.get("geom.cache.hits") or 0
        for spec in specs.values():
            geometry_setup(flagship, spec, "float32", True, device="cuda")
        misses.append((metrics.get("geom.cache.misses") or 0) - m0)
        hits.append((metrics.get("geom.cache.hits") or 0) - h0)
    check(misses == [len(specs), 0] and hits == [0, len(specs)],
          f"geometry cache across a repeat: misses {misses}, hits {hits}")
    print(f"geometry canvases {ftag} [{card}]: " + json.dumps({
        "host_build_s": build_s,
        "sampler_threads": canvas.SAMPLE_WORKERS, "cache_misses": misses,
        "cache_hits": hits,
        "default_spec_is_reference_fields": True}), flush=True)

    # Solves: fp64 at JAX's count, fp32 within GEOM_FP32_TOL of it, beside
    # the reference ellipse's plain solve of this call.
    ref32, ref32_s = timed(lambda: pcg_solve(flagship, dtype=f32))
    ref64, ref64_s = timed(lambda: pcg_solve(flagship, dtype=f64))
    fp32 = {}
    for name, spec in specs.items():
        r64, s64 = timed(lambda: pcg_solve(flagship, dtype=f64,
                                           geometry=spec))
        k64 = int(r64.iterations)
        check(k64 == GEOM_JAX_ITERATIONS[name] and int(r64.flag) == 1,
              f"geometry {name} fp64 {ftag}: {k64} iterations (flag "
              f"{int(r64.flag)}), JAX {GEOM_JAX_ITERATIONS[name]}")
        r32, s32 = timed(lambda: pcg_solve(flagship, dtype=f32,
                                           geometry=spec))
        k32 = int(r32.iterations)
        gap = float((r32.w.double() - r64.w).abs().max())
        check(int(r32.flag) == 1 and gap <= GEOM_FP32_TOL,
              f"geometry {name} fp32 {ftag}: flag {int(r32.flag)}, "
              f"{gap} from fp64")
        fp32[name] = r32
        print(f"geometry solve {name} {ftag} [{card}]: " + json.dumps({
            "fp64": {"iterations": k64, "jax_iterations":
                     GEOM_JAX_ITERATIONS[name], "seconds": s64,
                     "us_per_iter": s64 / k64 * 1e6},
            "fp32": {"iterations": k32, "seconds": s32,
                     "us_per_iter": s32 / k32 * 1e6,
                     "max_diff_vs_fp64": gap},
            "reference_ellipse_plain": {
                "fp64_iterations": int(ref64.iterations),
                "fp64_us_per_iter": ref64_s / int(ref64.iterations) * 1e6,
                "fp32_iterations": int(ref32.iterations),
                "fp32_us_per_iter": ref32_s / int(ref32.iterations) * 1e6},
            "host_build_s": build_s[name]}), flush=True)

    # Accuracy: every family at its floor at 64x64; the smooth boundaries
    # converge under refinement.
    acc = {}
    for case in cases():
        r = manufactured_error(case, 64, 64)
        check(r["flag"] == 1 and r["rel"] <= GEOM_FLOOR_REL[case.name],
              f"manufactured {case.name} 64x64: rel {r['rel']} (floor "
              f"{GEOM_FLOOR_REL[case.name]}), flag {r['flag']}")
        acc[case.name] = {"rel": r["rel"], "iterations": r["iterations"]}
    coarse, fine, names, ratio = GEOM_REFINE
    for name in names:
        rc = manufactured_error(case_by_name(name), *coarse)
        rf = manufactured_error(case_by_name(name), *fine)
        check(rf["rel"] < ratio * rc["rel"],
              f"manufactured {name}: {rf['rel']} at {fine} is not below "
              f"{ratio} x {rc['rel']} at {coarse}")
        acc[name]["refined"] = {"x".join(map(str, coarse)): rc["rel"],
                                "x".join(map(str, fine)): rf["rel"]}
    print(f"geometry manufactured [{card}]: {json.dumps(acc)}", flush=True)

    # The mixed batch: the families twice, gates 1 + i/16, fp32.
    names = list(specs)
    geoms = [specs[names[i % len(names)]] for i in range(GEOM_BATCH)]
    gates = [1.0 + i / GEOM_BATCH for i in range(GEOM_BATCH)]
    rb, sec = timed(lambda: solve_batched(flagship, rhs_gates=gates,
                                          geometries=geoms, dtype=f32))
    seq, seq_sec = timed(lambda: [pcg_solve(flagship, dtype=f32, geometry=g,
                                            rhs_gate=gate)
                                  for g, gate in zip(geoms, gates)])
    for i, sq in enumerate(seq):
        check(int(rb.iterations[i]) == int(sq.iterations)
              and int(rb.flag[i]) == int(sq.flag) == 1
              and torch.equal(rb.w[i], sq.w),
              f"geometry batch member {i}: {int(rb.iterations[i])} "
              f"iterations, solo {int(sq.iterations)}, bits equal "
              f"{torch.equal(rb.w[i], sq.w)}")
    print(f"geometry batched fp32 {ftag} B={GEOM_BATCH} [{card}]: "
          + json.dumps({
              "batch_seconds": sec, "solves_per_sec": GEOM_BATCH / sec,
              "max_iterations": int(rb.max_iterations),
              "iterations": rb.iterations.tolist(),
              "sequential_seconds": seq_sec,
              "speedup_vs_sequential": seq_sec / sec,
              "bit_for_bit_with_solo": True}), flush=True)

    # Multi-geometry lanes: new families spliced into freed lanes.
    mid = Problem(400, 600)
    bucket, chunk, first, later = GEOM_LANES
    table = LaneBatch(mid, bucket, dtype=f32, chunk=chunk,
                      multi_geometry=True)
    for name in first:
        table.splice(name, 1.0, geometry=specs[name])
    queue, done, reused = list(later), {}, []
    while table.occupied():
        check(table.steps < 100, "geometry lanes: the schedule did not "
                                 "drain")
        table.step()
        for view in table.lane_view():
            if view["member_id"] is not None and view["done"]:
                res = table.retire(view["lane"])
                done[res.member_id] = res
                if queue:
                    name = queue.pop(0)
                    table.splice(name, 1.0, geometry=specs[name],
                                 lane=view["lane"])
                    reused.append((name, view["lane"]))
    check(not queue and len(reused) == len(later),
          f"geometry lanes: spliced {reused}, left {queue}")
    for name, res in done.items():
        solo = pcg_solve(mid, dtype=f32, geometry=specs[name])
        check(res.iterations == int(solo.iterations) and res.flag == 1
              and torch.equal(res.w, solo.w),
              f"geometry lane {name}: {res.iterations} iterations, solo "
              f"{int(solo.iterations)}, bits equal "
              f"{torch.equal(res.w, solo.w)}")
    print(f"geometry lanes fp32 {mid.M}x{mid.N} bucket {bucket} [{card}]: "
          + json.dumps({
              "chunk": chunk, "steps": table.steps,
              "spliced_into_freed_lanes": reused,
              "iterations": {m: r.iterations for m, r in done.items()},
              "bit_for_bit_with_solo": True}), flush=True)

    # MG with a geometry (fp64, JAX's count), and the verified and chunked
    # geometry solves bit for bit with the plain one.
    spec = specs[GEOM_MG_CASE]
    _, hier_s = timed(lambda: device_hierarchy(flagship, "float64", False,
                                               geometry=spec,
                                               device="cuda"))
    rmg, mg_s = timed(lambda: pcg_solve(flagship, dtype=f64, geometry=spec,
                                        preconditioner="mg"))
    check(int(rmg.iterations) == GEOM_MG_JAX_ITERATIONS
          and int(rmg.flag) == 1,
          f"geometry MG {GEOM_MG_CASE} fp64: {int(rmg.iterations)} "
          f"iterations (flag {int(rmg.flag)}), JAX "
          f"{GEOM_MG_JAX_ITERATIONS}")
    one = fp32[GEOM_SOLO_CASE]
    solo_spec = specs[GEOM_SOLO_CASE]
    ver, ver_s = timed(lambda: pcg_solve(flagship, dtype=f32,
                                         geometry=solo_spec,
                                         verify_every=GEOM_VERIFY))
    chk, chk_s = timed(lambda: pcg_solve_chunked(flagship, chunk=GEOM_CHUNK,
                                                 dtype=f32,
                                                 geometry=solo_spec))
    for label, r in (("verified", ver), ("chunked", chk)):
        check(int(r.iterations) == int(one.iterations) and int(r.flag) == 1
              and torch.equal(r.w, one.w),
              f"geometry {label} {GEOM_SOLO_CASE}: {int(r.iterations)} "
              f"iterations (flag {int(r.flag)}), plain "
              f"{int(one.iterations)}, bits equal {torch.equal(r.w, one.w)}")
    print(f"geometry composed {ftag} [{card}]: " + json.dumps({
        "mg": {"case": GEOM_MG_CASE, "dtype": "float64",
               "iterations": int(rmg.iterations),
               "jax_iterations": GEOM_MG_JAX_ITERATIONS,
               "hierarchy_build_s": hier_s, "seconds": mg_s},
        "verified": {"case": GEOM_SOLO_CASE, "verify_every": GEOM_VERIFY,
                     "iterations": int(ver.iterations), "seconds": ver_s,
                     "bit_for_bit_with_plain": True},
        "chunked": {"case": GEOM_SOLO_CASE, "chunk": GEOM_CHUNK,
                    "iterations": int(chk.iterations), "seconds": chk_s,
                    "bit_for_bit_with_one_shot": True}}), flush=True)

    # Shape gradients (fp64).
    spec_fn = lambda q: Ellipse(cx=0.0, cy=0.0, rx=q[0], ry=q[1])
    params = list(GEOM_ADJOINT_PARAMS)
    for grid in GEOM_ADJOINT:
        p = Problem(*grid, delta=GEOM_ADJOINT_DELTA)
        tag = "x".join(map(str, grid))
        jax_loss = lambda w: w[1:-1, 1:-1].sum() * p.h1 * p.h2

        def value(q, loss):
            return float(loss(adjoint.differentiable_geometry_solve(
                p, spec_fn(torch.tensor(q, dtype=f64, device="cuda")))))

        def central(loss):
            out = []
            for k in range(len(params)):
                hi, lo = list(params), list(params)
                hi[k] += GEOM_FD_STEP
                lo[k] -= GEOM_FD_STEP
                out.append((value(hi, loss) - value(lo, loss))
                           / (2 * GEOM_FD_STEP))
            return out

        (val, grad), grad_s = timed(lambda: adjoint.shape_gradient(
            p, spec_fn, params, jax_loss))
        grad = grad.tolist()
        fd = central(jax_loss)
        for g, want in zip(grad, GEOM_ADJOINT_JAX[grid]):
            check(abs(g - want) <= max(1e-12, GEOM_ADJOINT_JAX_TOL
                                       * abs(want)),
                  f"shape gradient {tag}: {grad}, JAX "
                  f"{GEOM_ADJOINT_JAX[grid]}")
        rec = {"delta": GEOM_ADJOINT_DELTA, "params": params,
               "loss": float(val), "grad": grad,
               "jax_grad": list(GEOM_ADJOINT_JAX[grid]),
               "central_differences": fd, "fd_step": GEOM_FD_STEP,
               "forward_and_adjoint_s": grad_s}
        if grid == (32, 32):
            for g, f in zip(grad, fd):
                check(abs(g - f) <= GEOM_FD_TOL * abs(f),
                      f"shape gradient {tag}: {grad}, central differences "
                      f"{fd}")
        else:
            # The unscaled loss: reverse mode against forward mode.
            plain = lambda w: w[1:-1, 1:-1].sum()
            (_, rev), rev_s = timed(lambda: adjoint.shape_gradient(
                p, spec_fn, params, plain))
            _, fwd_s = timed(lambda: value(params, plain))
            import torch.autograd.forward_ad as fwAD

            tangents = []
            for k in range(len(params)):
                t = torch.zeros(len(params), dtype=f64, device="cuda")
                t[k] = 1.0
                with fwAD.dual_level():
                    q = fwAD.make_dual(torch.tensor(params, dtype=f64,
                                                    device="cuda"), t)
                    w = adjoint.differentiable_geometry_solve(p, spec_fn(q))
                    tangents.append(float(fwAD.unpack_dual(
                        plain(w)).tangent))
            rev = rev.tolist()
            for g, f in zip(rev, tangents):
                check(abs(g - f) <= GEOM_MODES_TOL * abs(f),
                      f"shape gradient {tag} (loss sum w): reverse {rev}, "
                      f"forward {tangents}")
            rec["sum_loss"] = {
                "reverse": rev, "forward": tangents,
                "forward_and_adjoint_s": rev_s, "forward_solve_s": fwd_s,
                "ratio": rev_s / fwd_s}
        print(f"geometry shape gradient {tag} fp64 [{card}]: "
              f"{json.dumps(rec)}", flush=True)
    print(f"geometry phase [{card}]: "
          f"{time.perf_counter() - started:.1f} s", flush=True)


def _sync_count(fn) -> tuple:
    """(fn's result, host synchronizations it made), counted by CUDA's
    sync debug mode (one warning per synchronizing call)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def check_krylov(pcg_solve, metrics, card: str) -> None:
    """The Krylov phase (no kernel of the port): block CG on a clustered
    B = 16 flagship batch against the independent batch and a rank-deficient
    block; deflation recycling at the flagship (fp32) and at 400x600
    (fp64); warm, cold and fallback session steps, implicit-Euler heat
    steps and a design step; the chunked ``rhs_gate`` and bf16 repairs."""
    import warnings

    from poisson_tpu_torch.config import Problem
    from poisson_tpu_torch.geometry.dsl import Ellipse, Rectangle
    from poisson_tpu_torch.krylov import KrylovPolicy, block, recycle
    from poisson_tpu_torch.solvers import session
    from poisson_tpu_torch.solvers.batched import solve_batched
    from poisson_tpu_torch.solvers.checkpoint import pcg_solve_chunked
    from poisson_tpu_torch.solvers.pcg import solve_fields
    from poisson_tpu_torch.solvers.resilient import pcg_solve_resilient
    from poisson_tpu_torch.utils.platform import resolve_device

    started = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    flagship = Problem(*KRY_FLAGSHIP)
    ftag = "x".join(map(str, KRY_FLAGSHIP))

    # Block CG: the clustered B = 16 batch, block against independent.
    fs, us, inside = block.clustered_ellipse_stack(flagship, KRY_BLOCK_B)
    ri, ind_s = timed(lambda: solve_batched(flagship, rhs_stack=fs,
                                            dtype=f32))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rb, blk_s = timed(lambda: solve_batched(flagship, rhs_stack=fs,
                                            dtype=f32, mode="block"))
    peak = torch.cuda.max_memory_allocated() - base
    check(bool((rb.flag == 1).all()) and bool((ri.flag == 1).all()),
          f"block {ftag}: flags {rb.flag.tolist()}, independent "
          f"{ri.flag.tolist()}")
    kb = int(rb.max_iterations)
    ind_total, blk_total = int(ri.iterations.sum()), KRY_BLOCK_B * kb
    l2_i = block.block_l2_errors(flagship, ri, us, inside)
    l2_b = block.block_l2_errors(flagship, rb, us, inside)
    check(all(b <= KRY_L2_RATIO * i + 1e-12 for b, i in zip(l2_b, l2_i)),
          f"block {ftag}: member L2 {l2_b} against independent {l2_i}")
    check(abs(kb - KRY_BLOCK_JAX_MAX) <= KRY_BLOCK_ALLOWANCE
          * KRY_BLOCK_JAX_MAX,
          f"block {ftag}: {kb} block iterations, JAX {KRY_BLOCK_JAX_MAX}")
    capped = flagship.with_(max_iter=KRY_PROFILE_ITERS)
    _, syncs = _sync_count(lambda: solve_batched(capped, rhs_stack=fs,
                                                 dtype=f32, mode="block"))
    print(f"krylov block fp32 {ftag} B={KRY_BLOCK_B} [{card}]: "
          + json.dumps({
              "block_max_iterations": kb,
              "jax_block_max_iterations": KRY_BLOCK_JAX_MAX,
              "block_iterations": rb.iterations.tolist(),
              "independent_iterations": ri.iterations.tolist(),
              "block_total": blk_total, "independent_total": ind_total,
              "cut_percent": 100.0 * (1.0 - blk_total / ind_total),
              "block_seconds": blk_s, "independent_seconds": ind_s,
              "us_per_block_iteration": blk_s / kb * 1e6,
              "host_syncs_per_block_iteration": syncs / KRY_PROFILE_ITERS,
              "eigh_per_block_iteration": 2,
              "peak_memory_bytes_over_start": peak,
              "deficient": bool(rb.deficient),
              "max_l2_block": max(l2_b), "max_l2_independent": max(l2_i)}),
          flush=True)

    # A rank-deficient block: three rescalings of one forcing.
    solo = int(pcg_solve(flagship, dtype=f32).iterations)
    rd, rd_s = timed(lambda: solve_batched(
        flagship, rhs_gates=list(KRY_DEFICIENT_GATES), dtype=f32,
        mode="block"))
    kd = int(rd.max_iterations)
    check(bool(rd.deficient) and bool((rd.flag == 1).all())
          and abs(kd - KRY_DEFICIENT_JAX_MAX) <= KRY_BLOCK_ALLOWANCE
          * KRY_DEFICIENT_JAX_MAX,
          f"rank-deficient block {ftag}: deficient {bool(rd.deficient)}, "
          f"flags {rd.flag.tolist()}, {kd} iterations, JAX "
          f"{KRY_DEFICIENT_JAX_MAX}")
    print(f"krylov block rank-deficient fp32 {ftag} [{card}]: " + json.dumps({
        "gates": list(KRY_DEFICIENT_GATES), "iterations": rd.iterations
        .tolist(), "max_iterations": kd,
        "jax_max_iterations": KRY_DEFICIENT_JAX_MAX, "solo": solo,
        "within_solo_plus_5": kd <= solo + 5, "deficient": True,
        "seconds": rd_s}), flush=True)

    # Recycling at the flagship, fp32: the harvest and the basis build
    # timed apart first (no counter moves), then the counted sequence.
    a, b, rhs, aux = solve_fields(flagship, "float32", True,
                                  resolve_device(None))
    kp = KrylovPolicy(deflation=True)
    (cold_r, y_w, ring), harvest_s = timed(
        lambda: recycle._solve_harvest(flagship, True, kp.harvest, a, b,
                                       rhs, aux))
    basis, build_s = timed(lambda: recycle.build_basis(
        flagship, True, a, b, aux, y_w, ring, int(cold_r.iterations), kp))
    check(basis is not None, f"recycle {ftag}: no basis from the harvest")
    recycle.reset_krylov_cache()
    names = ("krylov.cache.hits", "krylov.cache.misses",
             "krylov.cache.evictions", "krylov.cache.invalidations",
             "krylov.harvests", "krylov.warm_solves", "krylov.fallbacks",
             "krylov.iterations_saved")
    before = {n: metrics.get(n) or 0 for n in names}
    plain, plain_s = timed(lambda: pcg_solve(flagship, dtype=f32))
    cold, cold_s = timed(lambda: recycle.solve_recycled(flagship,
                                                        dtype=f32))
    check(int(cold.iterations) == int(plain.iterations) == 989
          and torch.equal(cold.w, plain.w),
          f"recycle {ftag}: cold harvest {int(cold.iterations)} iterations, "
          f"plain {int(plain.iterations)}, bits equal "
          f"{torch.equal(cold.w, plain.w)}")
    warm, warm_s = timed(lambda: recycle.solve_recycled(
        flagship, dtype=f32, rhs_gate=KRY_WARM_GATE))
    check(int(warm.flag) == 1 and int(warm.iterations) < int(cold.iterations),
          f"recycle {ftag}: warm {int(warm.iterations)} iterations (flag "
          f"{int(warm.flag)}), cold {int(cold.iterations)}")
    stats = recycle.cache_stats()
    recycle.poison_basis()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        back, back_s = timed(lambda: recycle.solve_recycled(
            flagship, dtype=f32, rhs_gate=0.8))
    check(int(back.flag) == 1 and bool(torch.isfinite(back.w).all()),
          f"recycle {ftag}: the poisoned basis's fallback gave flag "
          f"{int(back.flag)}")
    again = recycle.solve_recycled(flagship, dtype=f32, rhs_gate=1.2)
    moved = {n: (metrics.get(n) or 0) - before[n] for n in names}
    # Each warm solve saves its entry's cold count: the first harvest's,
    # then the fallback's re-harvest.
    saved = (int(cold.iterations) - int(warm.iterations)
             + int(back.iterations) - int(again.iterations))
    want = {"krylov.cache.hits": 3, "krylov.cache.misses": 1,
            "krylov.cache.evictions": 0, "krylov.cache.invalidations": 1,
            "krylov.harvests": 2, "krylov.warm_solves": 2,
            "krylov.fallbacks": 1, "krylov.iterations_saved": saved}
    check(moved == want, f"recycle {ftag} counters {moved}, the CPU "
                         f"sequence's {want}")
    ring_bytes = ring.numel() * ring.element_size()
    print(f"krylov recycle fp32 {ftag} [{card}]: " + json.dumps({
        "cold_iterations": int(cold.iterations), "cold_seconds": cold_s,
        "plain_seconds": plain_s, "cold_bit_for_bit_with_plain": True,
        "harvest_seconds": harvest_s, "basis_build_seconds": build_s,
        "warm_gate": KRY_WARM_GATE, "warm_iterations": int(warm.iterations),
        "warm_seconds": warm_s, "basis_vectors": int(basis[0].shape[0]),
        "basis_bytes": stats["bytes"], "ring_bytes": ring_bytes,
        "bases_within_budget": kp.budget_bytes // max(stats["bytes"], 1),
        "poisoned_fallback_iterations": int(back.iterations),
        "poisoned_fallback_seconds": back_s,
        "second_warm_iterations": int(again.iterations),
        "counters": moved}), flush=True)

    # Recycling at 400x600, fp64, against JAX's counts.
    mid = Problem(*KRY_RECYCLE64)
    recycle.reset_krylov_cache()
    c64 = recycle.solve_recycled(mid, dtype=f64)
    w64 = recycle.solve_recycled(mid, dtype=f64, rhs_gate=KRY_WARM_GATE)
    got64 = (int(c64.iterations), int(w64.iterations))
    check(got64 == KRY_RECYCLE64_JAX,
          f"recycle fp64 {mid.M}x{mid.N}: (cold, warm) {got64}, JAX "
          f"{KRY_RECYCLE64_JAX}")
    recycle.reset_krylov_cache()

    # Session steps at the flagship, fp32.
    ell = Ellipse()
    s_cold, info = session.session_step_solve(flagship, dtype=f32,
                                              geometry=ell)
    ref = pcg_solve(flagship, dtype=f32, geometry=ell)
    check(not info["warm_used"] and torch.equal(s_cold.w, ref.w),
          f"session cold step {ftag}: {info}, bits equal "
          f"{torch.equal(s_cold.w, ref.w)}")
    # A moved boundary: JAX's gate (residual within 100x ‖B‖) turns the
    # cx = 5e-4 warm start away at 400x600 and up, in fp32 and fp64, in
    # both packages (the 1/ε edge coefficients that moved dominate the
    # residual: JAX's ratio 900 here in fp32, on the CPU). The same
    # domain with a 10% larger RHS passes and cuts the count.
    moved_ell = Ellipse(cx=5e-4)
    _, moved = session.session_step_solve(flagship, dtype=f32,
                                          geometry=moved_ell, warm=s_cold.w,
                                          warm_geometry=ell)
    check(moved == {"warm_used": False, "fallback": "residual"},
          f"session moved-boundary step {ftag}: {moved}, JAX's is a "
          "residual fallback")
    (s_warm, info), sw_s = timed(lambda: session.session_step_solve(
        flagship, dtype=f32, geometry=ell, warm=s_cold.w, warm_geometry=ell,
        rhs_gate=KRY_SESSION_GATE))
    s_ref, sr_s = timed(lambda: pcg_solve(flagship, dtype=f32, geometry=ell,
                                          rhs_gate=KRY_SESSION_GATE))
    gap_cold = float((s_warm.w.double() - s_ref.w.double()).abs().max())
    check(info["warm_used"] and int(s_warm.flag) == 1
          and int(s_warm.iterations) == KRY_SESSION_JAX[0]
          and abs(gap_cold - KRY_SESSION_JAX[1]) <= KRY_SESSION_GAP_TOL,
          f"session warm step {ftag}: {info}, {int(s_warm.iterations)} "
          f"iterations, {gap_cold} from the cold solve; JAX "
          f"{KRY_SESSION_JAX}")
    falls = {}
    i, j = np.indices(tuple(s_cold.w.shape))
    garbage = torch.tensor(np.where((i + j) % 2 == 0, 1e12, -1e12),
                           dtype=f32, device=s_cold.w.device)
    for reason, warm_in, prev in (
            ("drift", s_cold.w, Ellipse(cx=0.9)),
            ("family", s_cold.w, Rectangle(-0.5, -0.3, 0.5, 0.3)),
            ("residual", garbage, ell)):
        r, info = session.session_step_solve(flagship, dtype=f32,
                                             geometry=ell, warm=warm_in,
                                             warm_geometry=prev)
        check(info == {"warm_used": False, "fallback": reason}
              and torch.equal(r.w, ref.w),
              f"session fallback {reason} {ftag}: {info}")
        falls[reason] = int(r.iterations)
    print(f"session fp32 {ftag} [{card}]: " + json.dumps({
        "cold_iterations": int(s_cold.iterations),
        "cold_bit_for_bit_with_pcg_solve": True,
        "moved_boundary_cx_5e-4": moved,
        "warm_rhs_gate": KRY_SESSION_GATE,
        "warm_iterations": int(s_warm.iterations), "warm_seconds": sw_s,
        "warm_max_diff_vs_cold": gap_cold,
        "jax_warm": {"iterations": KRY_SESSION_JAX[0],
                     "max_diff_vs_cold": KRY_SESSION_JAX[1]},
        "cold_iterations_at_gate": int(s_ref.iterations),
        "cold_seconds_at_gate": sr_s, "fallbacks": falls}), flush=True)

    # Heat: six implicit-Euler steps at 400x600, fp64.
    heat = Problem(*KRY_HEAT)
    steady = pcg_solve(heat, dtype=f64, geometry=ell).w
    u, errs, counts = None, [], []
    heat_s = 0.0
    for _ in range(KRY_HEAT_STEPS):
        (r, info), dt = timed(lambda: session.session_step_solve(
            heat, dtype=f64, geometry=ell, mass_shift=1.0, rhs_gate=1.0,
            warm=u, warm_geometry=ell if u is not None else None,
            u_prev=u))
        check(int(r.flag) == 1, f"heat step {len(counts)}: flag "
                                f"{int(r.flag)}")
        heat_s += dt
        u = r.w
        counts.append(int(r.iterations))
        errs.append(float(torch.linalg.norm(u - steady)))
    check(tuple(counts) == KRY_HEAT_JAX_ITERATIONS
          and all(b < a for a, b in zip(errs, errs[1:]))
          and all(abs(e - j) <= KRY_HEAT_TOL * j
                  for e, j in zip(errs, KRY_HEAT_JAX_ERRORS)),
          f"heat {heat.M}x{heat.N}: counts {counts}, errors {errs}; JAX "
          f"{KRY_HEAT_JAX_ITERATIONS}, {KRY_HEAT_JAX_ERRORS}")
    print(f"session heat fp64 {heat.M}x{heat.N} [{card}]: " + json.dumps({
        "iterations": counts, "jax_iterations": KRY_HEAT_JAX_ITERATIONS,
        "errors_to_steady_state": errs,
        "jax_errors": KRY_HEAT_JAX_ERRORS, "seconds": heat_s}), flush=True)

    # The design step, fp64, against JAX's.
    dp = Problem(*KRY_DESIGN)
    target = pcg_solve(dp, dtype=f64).w
    (new, loss, grads), d_s = timed(lambda: session.design_step(
        dp, dict(KRY_DESIGN_PARAMS), target, KRY_DESIGN_LR, dtype=f64))
    check(all(abs(new[k] - v) <= KRY_DESIGN_TOL * abs(v)
              for k, v in KRY_DESIGN_JAX_PARAMS.items())
          and abs(loss - KRY_DESIGN_JAX_LOSS)
          <= KRY_DESIGN_TOL * KRY_DESIGN_JAX_LOSS,
          f"design step {dp.M}x{dp.N}: {new}, loss {loss}; JAX "
          f"{KRY_DESIGN_JAX_PARAMS}, {KRY_DESIGN_JAX_LOSS}")
    print(f"session design fp64 {dp.M}x{dp.N} [{card}]: " + json.dumps({
        "params": new, "jax_params": KRY_DESIGN_JAX_PARAMS, "loss": loss,
        "grads": grads, "seconds": d_s}), flush=True)

    # The repairs: the gated chunked solve and bf16.
    gated = pcg_solve(flagship, dtype=f32, rhs_gate=0.5)
    chunked, ch_s = timed(lambda: pcg_solve_chunked(
        flagship, chunk=KRY_CHUNK, dtype=f32, rhs_gate=0.5))
    check(int(chunked.iterations) == int(gated.iterations)
          and int(chunked.flag) == 1 and torch.equal(chunked.w, gated.w),
          f"chunked rhs_gate {ftag}: {int(chunked.iterations)} iterations, "
          f"one-shot {int(gated.iterations)}, bits equal "
          f"{torch.equal(chunked.w, gated.w)}")
    bp = Problem(*KRY_BF16)
    bf, bf_s = timed(lambda: pcg_solve(bp.with_(
        max_iter=4 * KRY_BF16_JAX_ITERATIONS), dtype=torch.bfloat16))
    ref64 = pcg_solve(bp, dtype=f64).w
    gap = float((bf.w.double() - ref64).abs().max())
    kbf = int(bf.iterations)
    check(int(bf.flag) == 1 and abs(kbf - KRY_BF16_JAX_ITERATIONS)
          <= KRY_BF16_ALLOWANCE * KRY_BF16_JAX_ITERATIONS
          and gap <= 2 * KRY_BF16_JAX_GAP,
          f"bf16 {bp.M}x{bp.N}: {kbf} iterations (flag {int(bf.flag)}), "
          f"JAX {KRY_BF16_JAX_ITERATIONS}; {gap} from fp64")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rr, rr_s = timed(lambda: pcg_solve_resilient(
            bp, dtype=torch.bfloat16))
    hist = [tuple(h) for h in rr.recovery_history]
    check(int(rr.flag) == 1 and rr.w.dtype == f32
          and [h[1:] for h in hist]
          == [h[1:] for h in KRY_BF16_JAX_HISTORY],
          f"bf16 resilient {bp.M}x{bp.N}: {hist} (flag {int(rr.flag)}, "
          f"{rr.w.dtype}); JAX {KRY_BF16_JAX_HISTORY}")
    print(f"repairs [{card}]: " + json.dumps({
        "chunked_rhs_gate": {"grid": ftag, "chunk": KRY_CHUNK,
                             "iterations": int(chunked.iterations),
                             "seconds": ch_s,
                             "bit_for_bit_with_one_shot": True},
        "bf16_plain": {"grid": f"{bp.M}x{bp.N}", "iterations": kbf,
                       "jax_iterations": KRY_BF16_JAX_ITERATIONS,
                       "max_diff_vs_fp64": gap, "seconds": bf_s,
                       "us_per_iter": bf_s / kbf * 1e6},
        "bf16_resilient": {"iterations": int(rr.iterations),
                           "history": hist,
                           "jax_history": KRY_BF16_JAX_HISTORY,
                           "final_dtype": str(rr.w.dtype),
                           "seconds": rr_s}}), flush=True)
    print(f"krylov phase [{card}]: "
          f"{time.perf_counter() - started:.1f} s", flush=True)


def check_resilience(pcg_solve, metrics, card: str) -> None:
    """The resilience phase (no kernel of the port): verified solves bit
    for bit with the plain one, the NaN, bitflip and escalation drills of
    the resilient driver, the watchdog's heartbeat and stall, the stream,
    the history solve and an MG verified resilient solve; then µs per
    iteration with the probe at each stride of RES_VERIFY, a clean
    resilient solve and a streamed one beside the plain solve."""
    import warnings

    from poisson_tpu_torch.config import FLAGSHIP, Problem
    from poisson_tpu_torch.obs import stream
    from poisson_tpu_torch.parallel.watchdog import SolveTimeout, Watchdog
    from poisson_tpu_torch.solvers.history import pcg_solve_history
    from poisson_tpu_torch.solvers.resilient import pcg_solve_resilient
    from poisson_tpu_torch.testing import faults

    f32, f64 = torch.float32, torch.float64
    p = FLAGSHIP
    delta = p.delta
    integrity = ("integrity.checks", "integrity.detections",
                 "integrity.verified_restarts", "integrity.false_alarms",
                 "resilient.restarts", "resilient.escalations")

    def counters() -> dict:
        return {k: metrics.get(k) for k in integrity}

    def quiet(fn):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
        return out, [str(w.message) for w in seen]

    plain = pcg_solve(p, dtype=f32)
    k_plain = int(plain.iterations)
    for every in RES_VERIFY[1:3]:
        metrics.reset()
        ver = pcg_solve(p, dtype=f32, verify_every=every)
        same = torch.equal(ver.w, plain.w) and torch.equal(ver.diff,
                                                           plain.diff)
        check(int(ver.iterations) == k_plain == 989 and int(ver.flag) == 1
              and same and metrics.get("integrity.false_alarms") == 0,
              f"verified solve verify_every={every}: "
              f"{int(ver.iterations)} iterations (flag {int(ver.flag)}), "
              f"plain {k_plain}, bits equal {same}")
    print(f"resilience verified 800x1200 [{card}]: " + json.dumps({
        "verify_every": list(RES_VERIFY[1:3]), "iterations": k_plain,
        "bit_for_bit_with_plain": True}), flush=True)

    from poisson_tpu_torch.analysis import l2_error_host
    from poisson_tpu_torch.solvers.resilient import (
        DivergenceError,
        RecoveryPolicy,
    )

    l2_clean = l2_error_host(p, plain.w)

    def recovered_near_clean(name, gap, l2, jax_gap):
        check(l2 <= RES_L2_RATIO * l2_clean
              and gap <= RES_L2_RATIO * jax_gap,
              f"{name} window 0: L2 error {l2} against the clean "
              f"{l2_clean} (at most {RES_L2_RATIO}x), {gap} from the "
              f"clean iterate against JAX's {jax_gap} (at most "
              f"{RES_L2_RATIO}x)")

    nan_rec = {}
    for window, want in RES_NAN_HISTORY.items():
        metrics.reset()
        nan, msgs = quiet(lambda: pcg_solve_resilient(
            p, dtype=f32, chunk=RES_CHUNK,
            policy=RecoveryPolicy(stagnation_window=window),
            on_chunk=faults.chunk_hook(
                faults.FaultPlan(nan_at_iteration=RES_NAN_AT))))
        got = [tuple(h) for h in nan.recovery_history]
        check(int(nan.flag) == 1 and float(nan.diff) < delta
              and got == want and nan.restarts == len(want),
              f"NaN drill window {window}: flag {int(nan.flag)}, history "
              f"{got}, JAX's {want}")
        gap = float((nan.w - plain.w).abs().max())
        l2 = l2_error_host(p, nan.w)
        if window == 0:
            recovered_near_clean("NaN drill", gap, l2, RES_NAN_MAX_DIFF)
        nan_rec[f"window_{window}"] = {
            "iterations": int(nan.iterations),
            "jax_cpu_iterations": RES_NAN_JAX_ITERATIONS[window],
            "restarts": nan.restarts, "history": got,
            "max_diff_vs_clean": gap,
            "jax_cpu_max_diff_vs_clean": (RES_NAN_MAX_DIFF if window == 0
                                          else None),
            "l2_error": l2, "l2_error_clean": l2_clean,
            "warnings": msgs, **counters()}
    print(f"resilience nan drill 800x1200 at {RES_NAN_AT} chunk "
          f"{RES_CHUNK} [{card}]: " + json.dumps(nan_rec), flush=True)

    drill = {}
    for (window, buffer), want in RES_FLIP_HISTORY.items():
        metrics.reset()
        try:
            res, msgs = quiet(lambda: pcg_solve_resilient(
                p, dtype=f32, chunk=min(RES_CHUNK, RES_FLIP_AT),
                verify_every=RES_FLIP_VERIFY,
                policy=RecoveryPolicy(stagnation_window=window),
                on_chunk=faults.bitflip_hook(RES_FLIP_AT, buffer=buffer)))
        except DivergenceError as e:
            res, got = None, [tuple(h) for h in e.diagnostics["history"]]
        else:
            got = [tuple(h) for h in res.recovery_history]
        c = counters()
        flipped = any(v == "integrity" for _, v, _ in want)
        check(got == want and c["resilient.escalations"]
              == sum("escalate" in a for _, _, a in want)
              and c["integrity.false_alarms"] == 0
              and (c["integrity.detections"] >= 1
                   and c["integrity.verified_restarts"] >= 1) == flipped
              and (res is None) == (window != 0)
              and (res is None or int(res.flag) == 1),
              f"bitflip drill {buffer} window {window}: history {got}, "
              f"JAX's {want}, {c}")
        rec = {"history": got, **c}
        if res is not None:
            gap = float((res.w - plain.w).abs().max())
            l2 = l2_error_host(p, res.w)
            recovered_near_clean(f"bitflip drill {buffer}", gap, l2,
                                 RES_FLIP_MAX_DIFF)
            rec.update(iterations=int(res.iterations),
                       jax_cpu_iterations=RES_FLIP_JAX_ITERATIONS,
                       max_diff_vs_clean=gap,
                       jax_cpu_max_diff_vs_clean=RES_FLIP_MAX_DIFF,
                       l2_error=l2, l2_error_clean=l2_clean)
        drill[f"{buffer} window {window}"] = rec
    print(f"resilience bitflip drill 800x1200 verify_every "
          f"{RES_FLIP_VERIFY} at {RES_FLIP_AT} [{card}]: "
          + json.dumps(drill), flush=True)

    small = Problem(*RES_ESCALATE)
    fired = {"n": 0}

    def two_nans(state, chunks_done):
        if fired["n"] < 2 and int(state.k) >= RES_ESCALATE_AT:
            fired["n"] += 1
            return faults.inject_nan(state)
        return None

    metrics.reset()
    esc, msgs = quiet(lambda: pcg_solve_resilient(
        small, dtype=f32, chunk=RES_ESCALATE_AT, on_chunk=two_nans,
        policy=RecoveryPolicy(stagnation_window=0)))
    got = [tuple(h) for h in esc.recovery_history]
    check(int(esc.flag) == 1 and esc.w.dtype == f64
          and got == RES_ESCALATE_HISTORY
          and any("restart@float32" in m for m in msgs)
          and any("escalate->float64" in m for m in msgs),
          f"escalation drill: flag {int(esc.flag)}, dtype {esc.w.dtype}, "
          f"history {got}, {msgs}")
    print(f"resilience escalation 400x600 [{card}]: " + json.dumps({
        "iterations": int(esc.iterations),
        "jax_cpu_iterations": RES_ESCALATE_JAX_ITERATIONS,
        "dtype": str(esc.w.dtype), "history": got, **counters()}),
        flush=True)

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_wd_",
                                     dir=root) as wdir:
        hb = os.path.join(wdir, "hb.json")
        beats = []
        wd = Watchdog(heartbeat_path=hb, timeout=300.0)
        res = pcg_solve_resilient(
            p, dtype=f32, chunk=RES_CHUNK, watchdog=wd,
            on_chunk=lambda st, n: beats.append(
                json.load(open(hb))["beats"]))
        chunks = -(-int(res.iterations) // RES_CHUNK)
        last = json.load(open(hb))
        check(int(res.flag) == 1 and last["beats"] == chunks
              and beats == list(range(1, chunks))
              and last["k"] == int(res.iterations),
              f"watchdog heartbeat: {last['beats']} beats for {chunks} "
              f"chunks ({beats}), k {last['k']}")
        timeout, nap = RES_STALL
        stall = Watchdog(heartbeat_path=hb, timeout=timeout,
                         poll_interval=0.05)
        diag = None
        t0 = time.perf_counter()
        try:
            pcg_solve_resilient(p, dtype=f32, chunk=RES_CHUNK,
                                watchdog=stall,
                                on_chunk=lambda st, n: time.sleep(nap))
        except SolveTimeout as e:
            diag = e.diagnostics
        stalled = time.perf_counter() - t0
        check(diag is not None and diag.get("timeout_seconds") == timeout
              and diag.get("elapsed_seconds", 0) >= timeout
              and os.path.exists(hb + ".stalled.json"),
              f"watchdog stall: diagnostics {diag}")
    print(f"resilience watchdog 800x1200 [{card}]: " + json.dumps({
        "chunks": chunks, "beats": last["beats"],
        "heartbeat_keys": sorted(last),
        "stall_raised_after_s": stalled,
        "stall_diagnostics": {k: diag[k] for k in (
            "elapsed_seconds", "timeout_seconds", "beats",
            "last_progress")}}), flush=True)

    sink = stream.StreamSink()
    stream.set_sink(sink)
    try:
        streamed = pcg_solve(p, dtype=f32, stream_every=RES_STREAM)
    finally:
        stream.set_sink(None)
    ks = [k for k, _ in sink.samples]
    want = list(range(RES_STREAM, k_plain + 1, RES_STREAM))
    check(ks == want and torch.equal(streamed.w, plain.w)
          and int(streamed.iterations) == k_plain,
          f"stream: samples {ks[:3]}..{ks[-3:]}, want {want[:3]}.."
          f"{want[-3:]}; iterate bits equal "
          f"{torch.equal(streamed.w, plain.w)}")
    print(f"resilience stream 800x1200 every {RES_STREAM} [{card}]: "
          + json.dumps({"samples": len(ks), "first": sink.samples[0],
                        "last": sink.samples[-1],
                        "bit_for_bit_with_plain": True}), flush=True)

    M, N, budget = RES_HISTORY
    hp = Problem(M=M, N=N)
    ref = pcg_solve(hp, dtype=f64)
    hist, hist_s = timed(lambda: pcg_solve_history(hp, budget, dtype=f64))
    k_ref = int(ref.iterations)
    check(int(hist.iterations) == k_ref == 546
          and float(hist.diffs[-1]) == float(ref.diff)
          and float(hist.diffs[k_ref - 1]) == float(ref.diff),
          f"history: {int(hist.iterations)} iterations, last diff "
          f"{float(hist.diffs[-1])}, pcg_solve {k_ref} {float(ref.diff)}")
    print(f"resilience history fp64 {M}x{N} budget {budget} [{card}]: "
          + json.dumps({"iterations": int(hist.iterations),
                        "seconds": hist_s,
                        "last_diff": float(hist.diffs[-1]),
                        "last_l2_error": float(hist.l2_errors[-1])}),
          flush=True)

    every, chunk = RES_MG
    metrics.reset()
    mgr, msgs = quiet(lambda: pcg_solve_resilient(
        p, dtype=f32, chunk=chunk, verify_every=every,
        preconditioner="mg"))
    c = counters()
    check(int(mgr.iterations) == 15 and int(mgr.flag) == 1
          and mgr.restarts == 0 and c["integrity.false_alarms"] == 0
          and c["integrity.detections"] == 0,
          f"MG verified resilient: {int(mgr.iterations)} iterations "
          f"(flag {int(mgr.flag)}), restarts {mgr.restarts}, {c}")
    print(f"resilience mg verified 800x1200 verify_every {every} chunk "
          f"{chunk} [{card}]: " + json.dumps({
              "iterations": int(mgr.iterations), **c}), flush=True)

    # Times, in turns so that the host's drift is shared: the plain solve
    # with each probe stride, a clean resilient solve, a streamed one.
    runs = {f"verify_every_{v}": (lambda v=v: pcg_solve(
        p, dtype=f32, verify_every=v)) for v in RES_VERIFY}
    runs["resilient_chunk_200"] = lambda: pcg_solve_resilient(
        p, dtype=f32, chunk=RES_CHUNK)
    runs[f"stream_every_{RES_STREAM}"] = lambda: pcg_solve(
        p, dtype=f32, stream_every=RES_STREAM)
    each = {name: [] for name in runs}
    for _ in range(REPEATS):
        for name, run in runs.items():
            r, sec = timed(run)
            check(int(r.iterations) == k_plain,
                  f"timed {name}: {int(r.iterations)} iterations")
            each[name].append(sec)
    base = min(each["verify_every_0"])
    print(f"resilience times 800x1200 fp32 [{card}]: " + json.dumps({
        name: {"seconds": min(secs), "seconds_each": secs,
               "us_per_iter": min(secs) / k_plain * 1e6,
               "vs_plain": min(secs) / base}
        for name, secs in each.items()}), flush=True)


def ab_bytes(fc, problem) -> tuple[int, int]:
    """Kernels A + B's bytes per iteration at ``problem``'s flagship canvas:
    (from ``obs.costs``, the smoke's own formula on ``KERNELS``)."""
    from poisson_tpu_torch.obs import costs

    cv = fc.canvas_spec(problem)
    points = band_points(fc, cv)
    names = ("direction_stencil", "fused_update")
    return (sum(costs.kernel_bytes(n, points, cv.cols) for n in names),
            sum((KERNELS[n].passes * points + KERNELS[n].extra_rows
                 * cv.cols) * 4 for n in names))


def check_front_door(fc, pcg_solve, fp64: dict, card: str) -> int:
    """The measurement phase's timed part, before any profiler session:
    the bench's flagship record (kernels A and B) and its ``--batch``,
    ``--preconditioner mg`` and ``--verify-every`` records, the native
    oracle on the card's host, and the history seam's cost. Returns the
    launches of A and B it drove."""
    from poisson_tpu_torch import bench
    from poisson_tpu_torch.config import FLAGSHIP, Problem
    from poisson_tpu_torch.native import build, has_openmp, native_solve
    from poisson_tpu_torch.obs import forecast
    from poisson_tpu_torch.solvers.pcg import CHECK_EVERY

    dev = torch.device("cuda")
    rec = bench.flagship_record(FLAGSHIP, dev)
    print(f"bench record flagship [{card}]: {json.dumps(rec)}", flush=True)
    det = rec["detail"]
    check(det["iterations"] == 989,
          f"bench flagship: {det['iterations']} iterations, expected 989")
    check(det["platform_fallback"] is False and det["platform"] == "gpu"
          and det["backend"] == "fused",
          f"bench flagship: platform/backend {det}")
    roof = (rec.get("costs") or {}).get("roofline")
    check(roof is not None, "bench flagship: no costs.roofline block")
    model, formula = ab_bytes(fc, FLAGSHIP)
    check(model == formula, f"obs.costs A + B bytes {model} != the smoke's "
                            f"formula {formula}")
    check(roof["bytes_per_iter_model"] == model,
          f"bench flagship: bytes model {roof['bytes_per_iter_model']}, "
          f"A + B move {model}")
    frac = roof["fraction"]
    check(frac is not None and 0.0 < frac <= FRACTION_MAX,
          f"bench flagship: roofline fraction {frac} outside (0, "
          f"{FRACTION_MAX}]")
    launches = (1 + bench.REPEATS) * driven_steps(989, FLAGSHIP.iteration_cap,
                                                  CHECK_EVERY)
    mid = Problem(*bench.MODE_GRID)
    for mode, record in (
            (f"--batch {MEAS_BATCH}",
             lambda: bench.batched_record(mid, MEAS_BATCH, dev)),
            ("--preconditioner mg",
             lambda: bench.preconditioner_record(mid, "mg", dev)),
            (f"--verify-every {MEAS_VERIFY}",
             lambda: bench.verify_record(mid, MEAS_VERIFY, dev))):
        rec = record()
        print(f"bench record {mode} [{card}]: {json.dumps(rec)}", flush=True)
        d = rec["detail"]
        check(d["platform_fallback"] is False and d["platform"] == "gpu",
              f"bench {mode}: platform {d['platform']}")
        if "batch" in d:
            check(d["iterations"] == 546 and d["iterations_match_sequential"]
                  and d["converged"] == MEAS_BATCH,
                  f"bench {mode}: {d}")
        elif "preconditioner_ab" in d:
            ab = d["preconditioner_ab"]
            check(ab["jacobi"]["iterations"] == 546
                  and ab["mg"]["iterations"] == 14,
                  f"bench {mode}: counts {ab}")
        else:
            check(d["iterations"] == d["iterations_baseline"] == 546,
                  f"bench {mode}: counts {d}")

    # The fp64 oracle on the card's host, against the card's fp64 plain
    # solve.
    M, N, golden = MEAS_NATIVE
    p = Problem(M=M, N=N)
    t0 = time.perf_counter()
    build()
    build_s = time.perf_counter() - t0
    one, one_s = timed(lambda: native_solve(p, num_threads=1))
    team, team_s = timed(lambda: native_solve(p))
    want = fp64[p].w.double().cpu().numpy()
    gap = float(np.abs(one.w - want).max())
    print(f"native {M}x{N} [{card}]: " + json.dumps({
        "build_seconds": build_s, "has_openmp": has_openmp(),
        "threads_1": {"iterations": one.iterations, "seconds": one_s},
        "default_team": {"iterations": team.iterations, "seconds": team_s,
                         "threads": os.cpu_count()},
        "max_diff_vs_card_fp64": gap}), flush=True)
    check(one.iterations == golden, f"native {M}x{N}: {one.iterations} "
                                    f"iterations, expected {golden}")
    check(abs(team.iterations - golden) <= 1,
          f"native {M}x{N} default team: {team.iterations} iterations")
    check(gap <= MEAS_NATIVE_TOL, f"native {M}x{N}: iterate {gap} from the "
                                  "card's fp64 plain solve")

    # The history seam on the flagship fp32 plain solve: bit for bit with it
    # off, seconds of each, and the forecast at the halfway sample.
    buf = forecast.HistoryBuffer()
    prev = forecast.set_history(buf)
    try:
        runs = {}
        for every in (0, MEAS_HISTORY) * 3:                 # in turns
            buf.samples.clear()
            runs.setdefault(every, []).append(timed(lambda: pcg_solve(
                FLAGSHIP, dtype=torch.float32, history_every=every)))
        samples = list(buf.samples)
    finally:
        forecast.set_history(prev)
    off, on = runs[0][-1][0], runs[MEAS_HISTORY][-1][0]
    k = int(on.iterations)
    check(k == int(off.iterations) == 989 and torch.equal(on.w, off.w),
          "history_every: the solve is not bit for bit with it off")
    check([s[0] for s in samples]
          == list(range(MEAS_HISTORY, k + 1, MEAS_HISTORY)),
          f"history_every={MEAS_HISTORY}: samples at {samples}")
    half = next(i for i, s in enumerate(samples) if s[0] >= k / 2)
    slope = forecast.log_residual_slope(samples[:half + 1])
    k_half, d_half = samples[half]
    left = forecast.remaining_iterations(d_half, FLAGSHIP.delta, slope)
    print(f"history flagship fp32 every {MEAS_HISTORY} [{card}]: "
          + json.dumps({
              "us_per_iter_off": min(s for _, s in runs[0]) / k * 1e6,
              "us_per_iter_on": min(s for _, s in runs[MEAS_HISTORY])
              / k * 1e6,
              "samples": len(samples), "halfway_k": k_half,
              "slope": slope, "remaining_forecast": left,
              "remaining_true": k - k_half}), flush=True)
    check(left is not None and left > 0, f"no forecast at k = {k_half}")
    return launches


def check_capture(fc, pcg_solve, metrics, card: str, root: str) -> int:
    """The measurement phase's profiled part, after the other profiles:
    ``obs.profile`` around one fused flagship solve (its trace must name
    kernels A and B), the history seam's launches per iteration, and the
    run's registry through ``obs.export`` (the textfile parses back, the
    endpoint serves it) and the ``top`` scoreboard. Returns the launches
    of A and B it drove."""
    import urllib.request

    from poisson_tpu_torch.config import FLAGSHIP
    from poisson_tpu_torch.obs import export, forecast, profile
    from poisson_tpu_torch.solvers.pcg import CHECK_EVERY

    tmp = tempfile.mkdtemp(prefix=".chip_smoke_obs_", dir=root)
    try:
        with profile.capture("bench.solve", profile_dir=tmp) as out:
            r = fc.fused_cg_solve(FLAGSHIP)
        check(int(r.iterations) == 989, "profiled fused solve: "
                                        f"{int(r.iterations)} iterations")
        path = os.path.join(out, profile.TRACE_FILE)
        check(os.path.exists(path), f"obs.profile wrote no {path}")
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f).get(
                "traceEvents", [])}
        found = {sym: any(named(n, sym) for n in names)
                 for sym in ("direction_stencil_kernel",
                             "fused_update_kernel")}
        print(f"profile capture fused 800x1200 [{card}]: " + json.dumps({
            "trace_bytes": os.path.getsize(path), "events": len(names),
            "kernels_named": found,
            "captures": metrics.get("profile.captures")}), flush=True)
        check(all(found.values()), f"the capture's trace misses {found}")

        capped = FLAGSHIP.with_(max_iter=MEAS_HISTORY_ITERS)
        per_iter = {}
        for every in (0, MEAS_HISTORY):
            prof, wall = profile_kernels(lambda: pcg_solve(
                capped, dtype=torch.float32, history_every=every))
            if prof is not None:
                per_iter[f"history_every_{every}"] = {
                    "launches_per_iter": sum(n for n, _ in prof.values())
                    / MEAS_HISTORY_ITERS,
                    "device_us_per_iter": sum(us for _, us in prof.values())
                    / MEAS_HISTORY_ITERS,
                    "wall_us_per_iter": wall / MEAS_HISTORY_ITERS * 1e6}
        print(f"profile history fp32 800x1200 ({MEAS_HISTORY_ITERS} "
              f"iterations) [{card}]: " + json.dumps(per_iter), flush=True)

        snap = metrics.snapshot()
        prom = os.path.join(tmp, "metrics.prom")
        export.write_textfile(prom, snap)
        with open(prom) as f:
            parsed = export.parse_text(f.read())
        numeric = {export.metric_name(k): float(v)
                   for section in ("counters", "gauges")
                   for k, v in snap[section].items()
                   if isinstance(v, (int, float)) and not isinstance(v, bool)}
        bad = {k: v for k, v in numeric.items()
               if parsed.get(k, {}).get("value") != v}
        check(numeric and not bad, f"prometheus textfile: {len(bad)} values "
                                   f"not read back, e.g. "
                                   f"{list(bad.items())[:3]}")
        server = export.start_http_server(0)
        try:
            url = f"http://127.0.0.1:{server.server_port}/metrics"
            with urllib.request.urlopen(url, timeout=10) as resp:
                live = export.parse_text(resp.read().decode())
        finally:
            export.stop_http_server(server)
        missing = sorted(set(numeric) - set(live))
        check(not missing, f"/metrics misses {missing[:5]}")
        board = forecast.build_scoreboard(parsed)
        print(f"prometheus [{card}]: " + json.dumps({
            "textfile_samples": len(parsed), "numeric_metrics": len(numeric),
            "endpoint_samples": len(live)}), flush=True)
        print("top:\n" + forecast.render_scoreboard(board), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return driven_steps(989, FLAGSHIP.iteration_cap, CHECK_EVERY)


def check_serve(pcg_solve, metrics, card: str) -> None:
    """The service phase: drain, continuous, deadline and fleet runs of
    the solve service at 800x1200 on the card, then the chaos campaign
    there. Every outcome is typed and the ledger closes in each run."""
    from poisson_tpu_torch.config import Problem
    from poisson_tpu_torch.serve import (OUTCOME_RESULT, OUTCOME_SHED,
                                         SCHED_CONTINUOUS, FleetPolicy,
                                         ServicePolicy, SolveRequest,
                                         SolveService)
    from poisson_tpu_torch.solvers.batched import solve_batched
    from poisson_tpu_torch.testing import chaos
    from poisson_tpu_torch.testing.faults import kill_worker_at

    problem = Problem(M=800, N=1200)
    tag = "800x1200"
    gates = [1.0 + i / SERVE_REQUESTS for i in range(SERVE_REQUESTS)]

    def ledger(name: str) -> dict:
        c = metrics.snapshot()["counters"]
        inv = {"admitted": c.get("serve.admitted", 0),
               "terminated": c.get("serve.completed", 0)
               + c.get("serve.errors", 0) + c.get("serve.shed", 0)}
        check(inv["admitted"] == inv["terminated"] > 0,
              f"serve {name}: the ledger does not close {inv}")
        return inv

    def serve_run(name: str, policy, n: int = SERVE_REQUESTS, **kw):
        metrics.reset()
        svc = SolveService(policy, device="cuda", **kw)
        t0 = time.perf_counter()
        for i in range(n):
            svc.submit(SolveRequest(request_id=i, problem=problem,
                                    rhs_gate=gates[i], dtype="float32"))
        outs = svc.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        inv = ledger(name)
        check(len(outs) == n and svc.stats()["lost"] == 0,
              f"serve {name}: {len(outs)} outcomes for {n} requests")
        return svc, {o.request_id: o for o in outs}, wall, inv

    def straight() -> float:
        # The yardstick: the same gates straight through solve_batched in
        # two batches (the batched phase has run this bucket at this grid).
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for half in (gates[:SERVE_BATCH], gates[SERVE_BATCH:]):
            solve_batched(problem, rhs_gates=half, dtype="float32",
                          device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # 1. drain, timed against the yardstick in alternating pairs (straight,
    # drain, drain, straight, ...); the first drain's outcomes are checked.
    policy = ServicePolicy(capacity=4 * SERVE_REQUESTS,
                           max_batch=SERVE_BATCH)
    straights, walls, runs = [], [], []
    for k in range(SERVE_PAIRS):
        if k % 2 == 0:
            straights.append(straight())
        runs.append(serve_run("drain", policy))
        walls.append(runs[-1][2])
        if k % 2 == 1:
            straights.append(straight())
    svc, drain, _, inv = runs[0]
    wall = statistics.median(walls)
    overheads = [w - s for w, s in zip(walls, straights)]
    check(all(o.kind == OUTCOME_RESULT and o.converged
              for o in drain.values()),
          "serve drain: not every request converged")
    for _, again, _, _ in runs[1:]:
        check(all((again[i].iterations, again[i].flag, again[i].diff)
                  == (drain[i].iterations, drain[i].flag, drain[i].diff)
                  for i in drain),
              "serve drain: a repeated drain differs from the first")
    solo_s = []
    for i in SERVE_CHECKED:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = pcg_solve(problem, rhs_gate=gates[i], dtype="float32",
                        device="cuda")
        torch.cuda.synchronize()
        solo_s.append(time.perf_counter() - t0)
        o = drain[i]
        check(o.iterations == int(ref.iterations) and o.flag == "converged"
              and int(ref.flag) == 1 and o.diff == float(ref.diff),
              f"serve drain member {i}: {o.iterations} {o.flag} {o.diff} "
              f"against pcg_solve {int(ref.iterations)} {float(ref.diff)}")
    lat = svc.stats()["latency_seconds"]
    print(f"serve drain fp32 {tag} [{card}]: " + json.dumps({
        "requests": SERVE_REQUESTS, "max_batch": SERVE_BATCH,
        "wall_s": wall, "wall_s_runs": walls,
        "solves_per_s": SERVE_REQUESTS / wall,
        "p50_s": lat["p50"], "p99_s": lat["p99"],
        "solve_batched_two_batches_s": statistics.median(straights),
        "solve_batched_two_batches_s_runs": straights,
        "pcg_solve_s": min(solo_s),
        "overhead_s": statistics.median(overheads),
        "overhead_s_pairs": overheads, "ledger": inv,
        "iterations": sorted({o.iterations for o in drain.values()}),
        "checked_members": list(SERVE_CHECKED)}), flush=True)

    # 2. continuous
    policy = ServicePolicy(capacity=4 * SERVE_REQUESTS,
                           max_batch=SERVE_BATCH,
                           scheduling=SCHED_CONTINUOUS,
                           refill_chunk=SERVE_REFILL)
    svc, cont, wall, inv = serve_run("continuous", policy)
    differ = [i for i in drain
              if (cont[i].iterations, cont[i].flag, cont[i].diff)
              != (drain[i].iterations, drain[i].flag, drain[i].diff)]
    check(not differ, f"serve continuous: requests {differ} differ from "
                      "the drain run")
    lat = svc.stats()["latency_seconds"]
    print(f"serve continuous fp32 {tag} [{card}]: " + json.dumps({
        "requests": SERVE_REQUESTS, "refill_chunk": SERVE_REFILL,
        "wall_s": wall, "solves_per_s": SERVE_REQUESTS / wall,
        "p50_s": lat["p50"], "p99_s": lat["p99"], "ledger": inv,
        "same_as_drain": SERVE_REQUESTS - len(differ)}), flush=True)

    # 3. a deadline shorter than the solve
    metrics.reset()
    svc = SolveService(ServicePolicy(), device="cuda")
    share, chunk = SERVE_DEADLINE
    seconds = share * min(solo_s)
    t0 = time.perf_counter()
    svc.submit(SolveRequest(request_id="late", problem=problem,
                            dtype="float32", deadline_seconds=seconds,
                            chunk=chunk))
    outs = svc.drain()
    wall = time.perf_counter() - t0
    inv = ledger("deadline")
    check(len(outs) == 1, f"serve deadline: {len(outs)} outcomes")
    o = outs[0]
    typed = ((o.kind == OUTCOME_RESULT and o.partial
              and o.flag == "deadline")
             or (o.kind == OUTCOME_SHED
                 and o.shed_reason == "deadline_expired"))
    check(typed, f"serve deadline: not a typed deadline outcome: {o}")
    print(f"serve deadline fp32 {tag} [{card}]: " + json.dumps({
        "deadline_s": seconds, "solve_s": min(solo_s), "chunk": chunk,
        "kind": o.kind,
        "flag": o.flag, "shed_reason": o.shed_reason,
        "iterations": o.iterations, "wall_s": wall, "ledger": inv}),
        flush=True)

    # 4. the fleet: two workers on two slots of the card, the worker
    # holding the second dispatch killed
    workers, n, batch = SERVE_FLEET
    dispatches = {"n": 0}
    kill = kill_worker_at(1, lambda: dispatches["n"])

    def fault(worker_id, requests, attempts):
        try:
            kill(worker_id, requests, attempts)
        finally:
            dispatches["n"] += 1

    policy = ServicePolicy(capacity=4 * SERVE_REQUESTS, max_batch=batch,
                           fleet=FleetPolicy(workers=workers,
                                             devices=workers))
    svc, fleet, wall, inv = serve_run("fleet", policy, n=n,
                                      worker_fault=fault)
    recovered = metrics.get("serve.fleet.recovered_requests")
    retried = sorted(i for i, o in fleet.items() if o.attempts > 1)
    check(kill.state["kills"] == 1 and recovered >= 1 and retried,
          f"serve fleet: kills {kill.state}, recovered {recovered}")
    check(all(o.converged and o.iterations == drain[i].iterations
              for i, o in fleet.items()),
          "serve fleet: a request finished off the drain run's count")
    print(f"serve fleet fp32 {tag} [{card}]: " + json.dumps({
        "workers": workers, "slots": workers, "requests": n,
        "max_batch": batch, "wall_s": wall, "ledger": inv,
        "recovered_requests": recovered, "retried": retried,
        "quarantines": metrics.get("serve.fleet.quarantines"),
        "bindings": {str(k): v for k, v in
                     svc.stats()["placement"]["bindings"].items()}}),
        flush=True)

    # 5. the chaos campaign on the card
    t0 = time.perf_counter()
    report = chaos.run_campaign(seed=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = {r["scenario"]: [k for k, v in r["checks"].items() if not v]
           for r in report["scenarios"]
           if not r["ok"] or r["invariant"]["lost"] != 0}
    print(f"serve chaos [{card}]: " + json.dumps({
        "scenarios": len(report["scenarios"]), "seconds": wall,
        "admitted": sum(r["invariant"]["admitted"]
                        for r in report["scenarios"]),
        "failed": bad}), flush=True)
    check(len(report["scenarios"]) == 35 and not bad and report["ok"],
          f"serve chaos: scenarios not green: {bad}")


def _child_env(root: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def check_tooling(pcg_solve, metrics, card: str, root: str) -> int:
    """The tooling phase: the bench's serve, Krylov-block and session
    records on the card, each loaded into a ``regress.py`` cohort of its
    own; the contract gate and the telemetry selfcheck as their commands
    run them; and the solve command's ``--save-solution`` (fused, kernels A
    and B) and ``--categories``. Returns the launches of A and B it
    drove."""
    from benchmarks import regress
    from poisson_tpu_torch import bench, cli
    from poisson_tpu_torch.config import FLAGSHIP, Problem
    from poisson_tpu_torch.ops.fused_cg import fused_cg_solve
    from poisson_tpu_torch.solvers.pcg import CHECK_EVERY

    dev = torch.device("cuda")
    mid = Problem(*bench.MODE_GRID)
    t_phase = time.perf_counter()
    records = {}

    def record(name: str, run):
        metrics.reset()
        t0 = time.perf_counter()
        rec, ok = run()
        torch.cuda.synchronize()
        records[name] = rec
        print(f"bench record {name} [{card}]: {json.dumps(rec)}", flush=True)
        print(f"elapsed in {name}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        check(ok, f"bench {name}: the run failed its own check")
        check(rec["detail"]["platform"] == "gpu"
              and rec["detail"]["platform_fallback"] is False,
              f"bench {name}: platform {rec['detail']['platform']}")
        return rec

    # --serve 32 --arrival-rate 4 at 800x1200: both engines, every request
    # accounted, the same counts in both, each a solo solve's.
    requests, rate = TOOL_OPENLOOP
    keep = {}
    rec = record(f"--serve {requests} --arrival-rate {rate:g}",
                 lambda: bench.serve_openloop_record(FLAGSHIP, requests,
                                                     rate, dev, keep=keep))
    outs = {mode: {o.request_id: o for o in keep[mode].outcomes()}
            for mode in ("drain", "continuous")}
    for mode, got in outs.items():
        check(sorted(got) == list(range(requests))
              and all(o.converged for o in got.values()),
              f"--serve open loop {mode}: {len(got)} outcomes, not all "
              "converged")
    check(all((outs["drain"][i].iterations, outs["drain"][i].flag)
              == (outs["continuous"][i].iterations,
                  outs["continuous"][i].flag) for i in range(requests)),
          "--serve open loop: the engines' counts differ")
    gates = {rid: gate for _, rid, gate in
             bench._poisson_schedule(requests, rate)}
    for i in TOOL_CHECKED:
        ref = pcg_solve(FLAGSHIP, rhs_gate=gates[i], dtype="float32",
                        device="cuda")
        check(outs["drain"][i].iterations == int(ref.iterations),
              f"--serve open loop request {i}: {outs['drain'][i].iterations}"
              f" iterations, its pcg_solve {int(ref.iterations)}")

    # --serve 16 (fault load): the poisoned request isolated.
    keep = {}
    rec = record(f"--serve {TOOL_SERVE}",
                 lambda: bench.serve_record(mid, TOOL_SERVE, dev, keep=keep))
    # The burst fills the queue (capacity = requests), so the degradation
    # ladder may cap a clean request's iterations: a partial result is
    # still a result.
    outs = {o.request_id: o for o in keep["service"].outcomes()}
    poisoned = set(range(max(1, TOOL_SERVE // 16)))
    check(len(outs) == TOOL_SERVE
          and all(o.kind == "result" for i, o in outs.items()
                  if i not in poisoned)
          and all(outs[i].kind == "error" for i in poisoned),
          f"--serve {TOOL_SERVE}: outcomes {[o.kind for o in outs.values()]}")
    print(f"serve fault load 400x600 [{card}]: " + json.dumps({
        "p99_s": rec["value"], "poisoned": {
            i: outs[i].kind for i in sorted(poisoned)},
        "clean_converged": sum(o.converged for i, o in outs.items()
                               if i not in poisoned),
        "clean_partial": sum(o.partial for i, o in outs.items()
                             if i not in poisoned)}), flush=True)

    # --serve 16 --workers 2 --devices 2 --kill-device-at 1.
    rec = record(f"--serve {TOOL_SERVE} --workers 2 --devices 2 "
                 f"--kill-device-at {TOOL_KILL_DEVICE_AT:g}",
                 lambda: bench.serve_fleet_record(
                     mid, TOOL_SERVE, 2, dev, fleet_devices=2,
                     kill_device_at=TOOL_KILL_DEVICE_AT))
    check(rec["detail"]["lost"] == 0
          and rec["detail"]["device_topology"] == "2xcuda",
          f"--serve fleet: {rec['detail']['lost']} lost, topology "
          f"{rec['detail']['device_topology']}")

    # --serve 16 --repeat-fingerprint 3: repeats served off the cache.
    rec = record(f"--serve {TOOL_SERVE} --repeat-fingerprint "
                 f"{TOOL_FAMILIES}",
                 lambda: bench.serve_repeat_fp_record(
                     mid, TOOL_SERVE, TOOL_FAMILIES, dev))
    check(rec["detail"]["krylov_hit_rate"] > 0,
          f"--repeat-fingerprint: hit rate {rec['detail']['krylov_hit_rate']}")

    # --geometry-mix 3, --tenants a:1,b:4, --router: records build and load.
    record(f"--serve {TOOL_SERVE} --geometry-mix {TOOL_FAMILIES}",
           lambda: bench.serve_geometry_mix_record(mid, TOOL_SERVE,
                                                   TOOL_FAMILIES, dev))
    record(f"--serve {TOOL_SERVE} --tenants "
           f"{bench._tenant_mix_string(TOOL_TENANTS)}",
           lambda: bench.serve_tenants_record(mid, TOOL_SERVE, TOOL_TENANTS,
                                              dev))
    rec = record(f"--serve {TOOL_ROUTER} --router",
                 lambda: bench.serve_record(mid, TOOL_ROUTER, dev,
                                            router=True))
    check(rec["detail"]["routed_backend"] == "auto"
          and rec["detail"]["router"]["decisions"] > 0,
          f"--router: {rec['detail']['router']}")

    # --krylov-block 16 at 400x600: fewer member iterations, same floor.
    rec = record(f"--krylov-block {TOOL_BLOCK}",
                 lambda: bench.krylov_block_record(mid, TOOL_BLOCK, dev))
    ab = rec["detail"]["krylov_block_ab"]
    check(ab["iteration_cut"] > 0 and ab["same_l2_floor"],
          f"--krylov-block: cut {ab['iteration_cut']}, same floor "
          f"{ab['same_l2_floor']}")

    # --session 20 at 300x450.
    rec = record(f"--session {TOOL_SESSION}",
                 lambda: bench.session_record(Problem(*bench.SESSION_GRID),
                                              TOOL_SESSION, dev))
    print(f"session steps/s 300x450 [{card}]: {rec['value']}", flush=True)

    # Every record in a cohort of its own.
    keys = {}
    for name, rec in records.items():
        loaded = regress.records_from_result(rec, name)
        check(loaded and loaded[0]["value"] == rec["value"],
              f"{name}: the record does not load in regress.py")
        keys[name] = regress.cohort_key(regress.record_from_result(rec,
                                                                   name))
    check(len(set(keys.values())) == len(keys),
          f"bench records share a cohort: {keys}")
    print(f"bench records cohorts: {len(keys)} records, "
          f"{len(set(keys.values()))} cohorts", flush=True)

    # The contract gate as its command runs it.
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "poisson_tpu_torch.contracts",
                          "--json"], cwd=root, env=_child_env(root),
                         capture_output=True, text=True, timeout=600)
    gate_s = time.perf_counter() - t0
    check(out.stdout.strip().startswith("{"),
          f"contracts: no report (rc {out.returncode}): "
          f"{out.stderr[-2000:]}")
    report = json.loads(out.stdout)
    problems = report["ledger"]["problems"]
    kinds = sorted({p["kind"] for p in problems})
    print(f"contracts [{card}]: " + json.dumps({
        "rc": out.returncode, "seconds": gate_s, "counts": report["counts"],
        "environment": report["ledger"]["environment"],
        "problem_kinds": kinds,
        "kernel_problems": [p for p in problems
                            if p["program"].startswith("kernels.")]}),
        flush=True)
    check(report["counts"]["findings"] == 0,
          f"contracts: lint/drift findings {report['findings']}")
    check(all(p["kind"] == "ledger-environment" for p in problems),
          f"contracts: ledger problems {problems}")
    check(out.returncode == (0 if not problems else 1),
          f"contracts: exit {out.returncode} with problems {kinds}")

    # The telemetry selfcheck on the card.
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "poisson_tpu_torch.obs.selfcheck", "--device",
                          "cuda"], cwd=root, env=_child_env(root),
                         capture_output=True, text=True, timeout=600)
    lines = [line for line in out.stdout.splitlines()
             if line.startswith("obs selfcheck")]
    print(f"selfcheck [{card}]: rc {out.returncode}, "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{lines[-1] if lines else out.stderr[-2000:]}", flush=True)
    check(out.returncode == 0, "obs.selfcheck --device cuda failed")

    # solve --backend fused --save-solution: the file is the iterate.
    ckdir = tempfile.mkdtemp(prefix="smoke-tooling-")
    try:
        path = os.path.join(ckdir, "w.npy")
        check(cli.main([str(FLAGSHIP.M), str(FLAGSHIP.N), "--backend",
                        "fused", "--json", "--save-solution", path]) == 0,
              "solve --save-solution failed")
        saved = np.load(path)
        ref = fused_cg_solve(FLAGSHIP, device="cuda")
        want = ref.w.double().cpu().numpy()
        check(saved.dtype == np.float64 and np.array_equal(saved, want),
              "--save-solution: the file is not the solve's iterate")
        print(f"save-solution fused 800x1200 [{card}]: " + json.dumps({
            "shape": list(saved.shape), "bit_for_bit": True,
            "iterations": int(ref.iterations)}), flush=True)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    # --categories (on the torch backend: the table times the plain ops
    # with CUDA events, and no kernel of the port runs).
    check(cli.main([str(FLAGSHIP.M), str(FLAGSHIP.N), "--backend", "torch",
                    "--categories"]) == 0, "solve --categories failed")
    print(f"tooling phase seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    # The CLI ran one first and one timed solve, the check one more.
    return 3 * driven_steps(989, FLAGSHIP.iteration_cap, CHECK_EVERY)


def multiprocess_worker(rank: int, coordinator: str, out: str,
                        nccl: bool) -> None:
    """One rank of the multi-process phase (``python3 chip_smoke.py --rank
    R HOST:PORT DIR [--nccl]``): joins the process group, declares its two
    shards (on ``cuda:0`` under gloo; with ``--nccl`` on its own card),
    and runs the phase's solves, writing their iterates and a report to
    DIR. Every failure raises (a non-zero exit)."""
    import torch.distributed as dist

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from poisson_tpu_torch.config import FLAGSHIP, Problem
    from poisson_tpu_torch.obs import metrics
    from poisson_tpu_torch.ops import _build, launch
    from poisson_tpu_torch.parallel import (
        ca_cg_solve_sharded_checkpointed,
        fused_cg_solve_sharded_checkpointed,
        make_solver_mesh,
        pcg_solve_sharded,
    )
    from poisson_tpu_torch.parallel.multihost import initialize_multihost
    from poisson_tpu_torch.solvers.pcg import CHECK_EVERY

    _build.load_all()        # built by the parent: this loads them
    assert initialize_multihost(coordinator=coordinator,
                                num_processes=MP_RANKS,
                                process_id=rank) == rank
    dev = f"cuda:{rank}" if nccl else "cuda:0"
    mesh = make_solver_mesh([dev] * MP_SHARDS)
    report = {"backend": dist.get_backend(), "owners": list(mesh.owners),
              "local": list(mesh.local), "grid": [mesh.px, mesh.py],
              "device": dev}
    arrays = {}

    def timed_rank(fn):
        dist.barrier()
        torch.cuda.synchronize()
        before = {k: metrics.get(k) for k in ("multihost.sent_bytes",
                                              "multihost.staged_copies")}
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        return result, sec, {k: metrics.get(k) - v
                             for k, v in before.items()}

    if not nccl:
        for M, N, _ in MP_GRIDS:
            r, sec, moved = timed_rank(lambda: pcg_solve_sharded(
                Problem(M=M, N=N), mesh, dtype=torch.float64,
                setup="device"))
            arrays[f"pcg_{M}x{N}"] = r.w.cpu().numpy()
            report[f"pcg_{M}x{N}"] = {"iterations": int(r.iterations),
                                      "flag": int(r.flag), "seconds": sec,
                                      **moved}
    capped = FLAGSHIP.with_(max_iter=MP_CAP)
    cap = FLAGSHIP.iteration_cap
    paths = [("fused-sharded", FUSED, fused_cg_solve_sharded_checkpointed,
              1)]
    if not nccl:
        paths.append(("ca-sharded", CA, ca_cg_solve_sharded_checkpointed, 2))
    for path, wrappers, solve, per_step in paths:
        tag = path.replace("-", "_")
        file = os.path.join(out, f"{tag}.npz")
        launch.reset_launch_counts()
        part = solve(capped, mesh, file, CKPT_CHUNK)
        kept = os.path.exists(file)
        resumed = solve(FLAGSHIP, mesh, file, CKPT_CHUNK)
        dist.barrier()
        left = os.path.exists(file)
        # One chunk of the whole budget: no file is written on the way.
        timed_r, sec, moved = timed_rank(lambda: solve(
            FLAGSHIP, mesh, os.path.join(out, f"{tag}_timed.npz"), cap))
        k = int(resumed.iterations)
        steps = (chunk_steps(0, MP_CAP, MP_CAP, CKPT_CHUNK, CHECK_EVERY,
                             per_step)
                 + chunk_steps(MP_CAP, k, cap, CKPT_CHUNK, CHECK_EVERY,
                               per_step)
                 + chunk_steps(0, int(timed_r.iterations), cap, cap,
                               CHECK_EVERY, per_step))
        launched = {**sharded_counts(launch.launch_counts(*wrappers)),
                    **launch.launch_counts(*RECURRENCE)}
        arrays[tag] = resumed.w.cpu().numpy()
        arrays[f"{tag}_timed"] = timed_r.w.cpu().numpy()
        report[path] = {
            "capped": int(part.iterations), "kept": kept, "iterations": k,
            "diff": float(resumed.diff), "file_left": left,
            "timed_iterations": int(timed_r.iterations), "seconds": sec,
            "steps": steps, "launches": launched, **moved}
    # The transport alone: one all-gather of two fp32 values between the
    # ranks, and one staged copy of two values from the card to the host
    # (what each mesh-wide sum costs under gloo besides its launches).
    probe = torch.zeros(MP_SHARDS, device=dev)
    staged = probe if nccl else probe.to("cpu")
    every = [torch.empty_like(staged) for _ in range(MP_RANKS)]
    for name, op in (("all_gather_us",
                      lambda: dist.all_gather(every, staged)),
                     ("staged_copy_us", lambda: probe.to("cpu"))):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MP_PROBES):
            op()
        torch.cuda.synchronize()
        report[name] = (time.perf_counter() - t0) / MP_PROBES * 1e6
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(report, fh)
    dist.barrier()
    dist.destroy_process_group()


def launch_ranks(root: str, out: str, nccl: bool) -> list:
    """Start the phase's ranks, wait for each (``MP_TIMEOUT``), kill any
    left; fails unless every rank exits 0. Returns each rank's report."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = [sys.executable, os.path.join(root, "chip_smoke.py"), "--rank"]
    procs = [subprocess.Popen(
        argv + [str(r), f"127.0.0.1:{port}", out]
        + (["--nccl"] if nccl else []), cwd=root, env=_child_env(root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(MP_RANKS)]
    done = []
    try:
        for proc in procs:
            try:
                done.append(proc.communicate(timeout=MP_TIMEOUT))
            except subprocess.TimeoutExpired:
                done.append(("", "timed out"))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    for r, (proc, (_, err)) in enumerate(zip(procs, done)):
        check(proc.returncode == 0, f"multi-process rank {r} exited "
                                    f"{proc.returncode}: {err[-3000:]}")
    return [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(MP_RANKS)]


def check_multiprocess(mesh, fs, cs_, ps, card: str, root: str) -> dict:
    """The multi-process phase: two ranks of this script under gloo, each
    with two shards of the 2x2 mesh on the one card, solve fp64 (device
    setup) and run the fused (A, B sharded) and CA (C, D sharded)
    checkpointed drivers capped at ``MP_CAP`` and resumed; every iterate
    bit for bit with ``mesh`` (the same 2x2 on the card) driven by this
    process, every rank's sharded kernels launched exactly its shards x
    driven steps. NCCL, one card per rank, where two cards are visible.
    Returns this process's sharded launches (its own references)."""
    from poisson_tpu_torch.config import FLAGSHIP, Problem
    from poisson_tpu_torch.solvers.pcg import CHECK_EVERY

    t_phase = time.perf_counter()
    cap = FLAGSHIP.iteration_cap
    capped = FLAGSHIP.with_(max_iter=MP_CAP)
    ref, single = {}, {}
    launched = {}
    out = tempfile.mkdtemp(prefix="mp_smoke_")
    try:
        for M, N, expected in MP_GRIDS:
            r, sec = timed(lambda: ps.pcg_solve_sharded(
                Problem(M=M, N=N), mesh, dtype=torch.float64,
                setup="device"))
            check(int(r.iterations) == expected,
                  f"one-process pcg {M}x{N}: {int(r.iterations)}")
            ref[f"pcg_{M}x{N}"] = r.w.cpu().numpy()
            single[f"pcg_{M}x{N}"] = sec
        for path, solve, per_step in (
                ("fused-sharded", fs.fused_cg_solve_sharded_checkpointed, 1),
                ("ca-sharded", cs_.ca_cg_solve_sharded_checkpointed, 2)):
            tag = path.replace("-", "_")
            file = os.path.join(out, f"one_{tag}.npz")
            solve(capped, mesh, file, CKPT_CHUNK)
            r = solve(FLAGSHIP, mesh, file, CKPT_CHUNK)
            ref[tag] = r.w.cpu().numpy()
            t, sec = timed(lambda: solve(FLAGSHIP, mesh,
                                         os.path.join(out, "one.npz"), cap))
            ref[f"{tag}_timed"] = t.w.cpu().numpy()
            single[path] = (sec, int(t.iterations))
            launched[path] = mesh.size * (
                chunk_steps(0, MP_CAP, MP_CAP, CKPT_CHUNK, CHECK_EVERY,
                            per_step)
                + chunk_steps(MP_CAP, int(r.iterations), cap, CKPT_CHUNK,
                              CHECK_EVERY, per_step)
                + chunk_steps(0, int(t.iterations), cap, cap, CHECK_EVERY,
                              per_step))
        runs = [("gloo", False)]
        if torch.cuda.device_count() >= MP_RANKS:
            runs.append(("nccl", True))
        else:
            print(f"multiprocess nccl [{card}]: not run "
                  f"({torch.cuda.device_count()} card visible; NCCL needs "
                  "a card per rank)", flush=True)
        for backend, nccl in runs:
            sub = os.path.join(out, backend)
            os.makedirs(sub)
            t0 = time.perf_counter()
            reports = launch_ranks(root, sub, nccl)
            wall = time.perf_counter() - t0
            arrays = [np.load(os.path.join(sub, f"rank{r}.npz"))
                      for r in range(MP_RANKS)]
            for r, rep in enumerate(reports):
                check(rep["backend"] == backend and rep["grid"] == [2, 2]
                      and rep["owners"] == [0, 0, 1, 1]
                      and rep["local"] == [2 * r, 2 * r + 1],
                      f"multi-process rank {r}: mesh {rep}")
            for key in arrays[0].files:
                for r in range(MP_RANKS):
                    check(np.array_equal(arrays[r][key], ref[key]),
                          f"multi-process {backend} rank {r} {key}: not bit "
                          "for bit with the one-process 2x2 mesh")
            lead = reports[0]
            for M, N, expected in MP_GRIDS if not nccl else ():
                rec = lead[f"pcg_{M}x{N}"]
                check(rec["iterations"] == expected and rec["flag"] == 1,
                      f"multi-process pcg {M}x{N}: {rec}")
                print(f"multiprocess {backend} pcg fp64 device {M}x{N} "
                      f"[{card}]: " + json.dumps({
                          "iterations": rec["iterations"],
                          "seconds": rec["seconds"],
                          "us_per_iter": rec["seconds"] / expected * 1e6,
                          "one_process_seconds": single[f"pcg_{M}x{N}"],
                          "bytes_sent_per_iter_per_rank":
                              rec["multihost.sent_bytes"] / expected,
                          "staged_copies_per_iter_per_rank":
                              rec["multihost.staged_copies"] / expected,
                          "bit_for_bit": True}), flush=True)
            for path, names in (("fused-sharded", ("direction_and_stencil",
                                                   "fused_update")),
                                ("ca-sharded", ("basis_sweep",
                                                "pair_update"))):
                if path not in lead:
                    continue
                for r, rep in enumerate(reports):
                    rec = rep[path]
                    check(rec["capped"] == MP_CAP and rec["kept"]
                          and not rec["file_left"]
                          and rec["iterations"] == 989
                          and rec["timed_iterations"] == 989
                          and rec["diff"] < 1e-6,
                          f"multi-process {backend} {path} rank {r}: {rec}")
                    want = MP_SHARDS * rec["steps"]
                    for name in names:
                        got = rec["launches"].get(f"{name}_sharded")
                        check(got == want, f"multi-process {backend} {path} "
                              f"rank {r}: {name}_sharded launched {got} "
                              f"times, expected {MP_SHARDS} shards x "
                              f"{rec['steps']} steps")
                    got = {name: rec["launches"].get(name)
                           for name in RECURRENCE}
                    check(got == recurrence_counts(
                        rec["steps"] if path == "fused-sharded" else 0),
                          f"multi-process {backend} {path} rank {r}: "
                          f"recurrence launches {got} for {rec['steps']} "
                          "steps")
                rec = lead[path]
                k = rec["timed_iterations"]
                one_s, one_k = single[path]
                steps = chunk_steps(0, k, cap, cap, CHECK_EVERY,
                                    1 if path == "fused-sharded" else 2)
                print(f"multiprocess {backend} {path} "
                      f"{FLAGSHIP.M}x{FLAGSHIP.N} [{card}]: " + json.dumps({
                          "iterations": k, "capped": rec["capped"],
                          "resumed": rec["iterations"],
                          "bit_for_bit": True,
                          "seconds": rec["seconds"],
                          "us_per_iter": rec["seconds"] / k * 1e6,
                          "one_process_seconds": one_s,
                          "one_process_us_per_iter": one_s / one_k * 1e6,
                          "launches_per_rank": rec["launches"],
                          "kernel_launches_per_iter_per_rank":
                              2 * MP_SHARDS * steps / k,
                          "staged_copies_per_iter_per_rank":
                              rec["multihost.staged_copies"] / k,
                          "done_reads_per_iter": steps / CHECK_EVERY / k,
                          "bytes_sent_per_iter_per_rank":
                              rec["multihost.sent_bytes"] / k}), flush=True)
            print(f"multiprocess {backend} transport [{card}]: "
                  + json.dumps({f"rank{r}": {
                      k: rep[k] for k in ("all_gather_us", "staged_copy_us")}
                      for r, rep in enumerate(reports)}), flush=True)
            print(f"multiprocess {backend} ranks wall [{card}]: "
                  f"{wall:.1f} s for {MP_RANKS} processes", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(f"multiprocess phase seconds [{card}]: "
          f"{time.perf_counter() - t_phase:.1f}", flush=True)
    return launched


def main() -> None:
    started = time.perf_counter()

    def elapsed(phase: str) -> None:
        print(f"elapsed after {phase}: "
              f"{time.perf_counter() - started:.1f} s", flush=True)

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from poisson_tpu_torch.analysis import l2_error_host
        from poisson_tpu_torch import mg
        from poisson_tpu_torch.config import FLAGSHIP, Problem
        from poisson_tpu_torch.ops import _build, ca_cg as ca
        from poisson_tpu_torch.ops import fused_cg as fc
        from poisson_tpu_torch.ops import resident as rs
        from poisson_tpu_torch.ops import serial as sr
        from poisson_tpu_torch.parallel import ca_sharded as cs_
        from poisson_tpu_torch.parallel import checkpoint_sharded as cks
        from poisson_tpu_torch.parallel import fused_sharded as fs
        from poisson_tpu_torch.parallel import pcg_sharded as ps
        from poisson_tpu_torch.parallel.mesh import make_solver_mesh
        from poisson_tpu_torch.obs import costs, metrics
        from poisson_tpu_torch.solvers import batched as bt
        from poisson_tpu_torch.solvers import checkpoint as ck
        from poisson_tpu_torch.solvers import lanes
        from poisson_tpu_torch.solvers.pcg import (
            CHECK_EVERY,
            init_state,
            pcg_solve,
        )
        from poisson_tpu_torch.solvers.refine import refined_solve
    except ImportError as e:
        fail(f"cannot import the port (run from a checkout): {e}")
    gate = LaunchGate().install()       # for the rest of this process

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    libs = _build.load_all()
    wall = time.perf_counter() - t0
    print(f"build: {len(libs)} libraries for sm_90a, build+load {wall:.2f} s "
          "(one nvcc per source, in parallel)", flush=True)
    for name, kernels in libs.items():
        print(f"build: {kernels.path.name} from {_build.source(name).name}: "
              f"nvcc {kernels.build_seconds:.2f} s", flush=True)
        for line in kernels.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    for name, symbols in REDESIGNED.items():
        for symbol in symbols:
            if not libs[name].log:
                print(f"ptxas redesign {symbol}: not reported (an existing "
                      "build was loaded)", flush=True)
                continue
            rec = ptxas_report(libs[name].log, symbol)
            check(rec is not None and "registers" in rec,
                  f"no ptxas report for {symbol} in the {name} build")
            print(f"ptxas redesign {symbol}: {json.dumps(rec)}", flush=True)
            if symbol in NO_SPILL:
                check(rec.get("spill_store_bytes", 0) == 0
                      and rec.get("spill_load_bytes", 0) == 0
                      and rec.get("stack_frame_bytes", 0) == 0,
                      f"{symbol} spills registers: {rec}")

    results: dict = {}
    errors: dict = {}
    # The sharded paths' mesh: 2×2, its four shards all on the one card.
    mesh = make_solver_mesh(["cuda:0"] * (SHARD_GRID[0] * SHARD_GRID[1]),
                            grid=SHARD_GRID)
    timers = [t for M, N in GRIDS
              for t in check_kernels(M, N, fc, ca, sr, results, errors)]
    timers += [t for M, N in GRIDS
               for t in check_sharded_kernels(M, N, fc, ca, fs, sr, mesh,
                                              results, errors)]
    # A′ and B′ on the 2400×3200 canvas with bn=1024 and on the wide
    # probe's auto-blocked canvas; A and B on the wide probe's full width.
    wide = Problem(**WIDE)
    setup: dict = {}
    for p, bn in ((Problem(M=2400, N=3200), 1024), (wide, None), (wide, 0)):
        timers += check_sweeps(p, bn, fc, sr, results, errors, setup)
    counts: dict = {}

    def no_serial(path: str) -> None:
        """A path that is not in the serial-reduce mode launches no S."""
        n = gate.counts(*SERIAL)["serial_sum"]
        check(n == 0, f"{path}: kernel S launched {n} times outside the "
                      "serial-reduce mode")

    for kw in RESIDENT_FALLBACKS:
        check_resident_fallback(Problem(**kw), fc, rs, errors)
    elapsed("kernels vs plain")
    # --- the fused path (kernels A, B). Counts zeroed just before, read
    # just after.
    big = Problem(M=2400, N=3200)
    fc.build_canvases(big, "cuda")          # set-up, outside the timed solve
    gate.reset()
    fused = fc.fused_cg_solve(FLAGSHIP)     # warm-up solve
    flag_times = []
    for _ in range(REPEATS):
        fused, s = timed(lambda: fc.fused_cg_solve(FLAGSHIP))
        flag_times.append(s)
    big_r, big_s = timed(lambda: fc.fused_cg_solve(big))
    counts.update(single_counts(gate.counts(*FUSED)))
    no_serial("fused")
    check(gate.counts(*RECURRENCE)
          == recurrence_counts(counts["direction_and_stencil"]),
          f"fused: recurrence launches {gate.counts(*RECURRENCE)}, expected "
          f"one of each per launch of A ({counts['direction_and_stencil']})")
    check(not any(blocked_counts(gate.counts(*FUSED)).values()),
          "fused: a column-blocked kernel was launched at full width")

    iters = int(fused.iterations)
    diff = float(fused.diff)
    check(iters == 989, f"800x1200: {iters} iterations, expected 989")
    check(diff < 1e-6, f"800x1200: diff {diff} not below 1e-6")
    w64 = pcg_solve(FLAGSHIP, dtype=torch.float64, device="cuda")
    check(int(w64.iterations) == 989,
          f"plain fp64 solve: {int(w64.iterations)} iterations")
    gap = float((fused.w.double() - w64.w).abs().max())
    check(gap <= ITERATE_TOL, f"800x1200: iterate {gap} from fp64 solve")
    l2 = l2_error_host(FLAGSHIP, fused.w)
    check(np.isfinite(l2) and l2 < 1e-3, f"800x1200: L2 error {l2}")
    flag_s = min(flag_times)
    bytes_per_iter, formula = ab_bytes(fc, FLAGSHIP)
    check(bytes_per_iter == formula == costs.iteration_bytes(FLAGSHIP,
                                                             "fused"),
          f"fused 800x1200: bytes models disagree ({bytes_per_iter}, "
          f"{formula})")
    solve_line("fused", FLAGSHIP, fused, flag_s, l2, {
        "max_diff_vs_fp64": gap, "seconds_each": flag_times,
        "achieved_gbps": bytes_per_iter * iters / flag_s / 1e9})
    big_iters = int(big_r.iterations)
    check(abs(big_iters - 2449) <= 1,
          f"2400x3200: {big_iters} iterations, expected 2449 +- 1")
    check(float(big_r.diff) < 1e-6, f"2400x3200: diff {float(big_r.diff)}")
    big_l2 = l2_error_host(big, big_r.w)
    check(np.isfinite(big_l2), "2400x3200: non-finite iterate")
    big_bytes = costs.iteration_bytes(big, "fused")
    solve_line("fused", big, big_r, big_s, big_l2, {
        "achieved_gbps": big_bytes * big_iters / big_s / 1e9})
    total_iters = (1 + REPEATS) * iters + big_iters
    for name in ("direction_and_stencil", "fused_update"):
        check(counts[name] >= total_iters,
              f"{name}: {counts[name]} launches on the fused path, fewer "
              f"than the {total_iters} iterations")
    print(f"launches on the fused path: {json.dumps(gate.counts(*FUSED))} "
          f"for {total_iters} iterations", flush=True)
    # A replayed block adds to the counters the launches measured while it
    # was captured: hold them against the kernels the profiler saw.
    gate.reset()
    seen, _ = profile_kernels(lambda: fc.fused_cg_solve(FLAGSHIP))
    steps = driven_steps(iters, FLAGSHIP.iteration_cap, CHECK_EVERY)
    wrapper = single_counts(gate.counts(*FUSED))
    for name, symbol in (("direction_and_stencil", "direction_stencil_kernel"),
                         ("fused_update", "fused_update_kernel")):
        on_card = sum(n for k, (n, _) in (seen or {}).items()
                      if named(k, symbol))
        check(wrapper[name] == on_card == steps,
              f"{name}: {wrapper[name]} launches counted, {on_card} "
              f"{symbol} seen by the profiler, for {steps} driven steps")
    recurrence = gate.counts(*RECURRENCE)
    for name in RECURRENCE:
        on_card = sum(n for k, (n, _) in (seen or {}).items()
                      if named(k, f"{name}_kernel"))
        check(recurrence[name] == on_card == steps,
              f"{name}: {recurrence[name]} launches counted, {on_card} seen "
              f"by the profiler, for {steps} driven steps")
    check_recurrence(card)

    elapsed("fused")
    # --- the resident path (kernel R): one launch per solve.
    fp64 = {FLAGSHIP: w64}
    for M, N, _ in RESIDENT_GRIDS:
        p = Problem(M=M, N=N)
        fc.build_canvases(p, "cuda")
        if p not in fp64:
            fp64[p] = pcg_solve(p, dtype=torch.float64, device="cuda")
    gate.reset()
    res_runs, res_iters = {}, {}
    for M, N, _ in RESIDENT_GRIDS:
        p = Problem(M=M, N=N)
        rs.resident_cg_solve(p)                       # warm-up
        res_runs[p] = [timed(lambda: rs.resident_cg_solve(p))
                       for _ in range(REPEATS)]
    counts.update(gate.counts(*RESIDENT))
    no_serial("resident")
    check(counts["resident_solve"] == (1 + REPEATS) * len(RESIDENT_GRIDS),
          f"resident_solve: {counts['resident_solve']} launches, expected "
          "one per solve")
    for M, N, expected in RESIDENT_GRIDS:
        p = Problem(M=M, N=N)
        r, s = min(res_runs[p], key=lambda rs_: rs_[1])
        k = int(r.iterations)
        check(k == expected, f"resident {M}x{N}: {k} iterations, expected "
                             f"{expected}")
        check(float(r.diff) < 1e-6, f"resident {M}x{N}: diff {float(r.diff)}")
        cv, cs, cw, g, rhs, sc2, sc_int = fc.build_canvases(p, "cuda")
        wp, kp, _, _ = rs.resident_solve_plain(p, cv, cs, cw, g, rhs, sc2)
        plain_w = torch.nn.functional.pad(
            wp[fc.HALO : fc.HALO + M - 1, 1:N] * sc_int, (1, 1, 1, 1))
        check(int(kp) == k, f"resident {M}x{N}: plain version gives "
                            f"{int(kp)} iterations, kernel {k}")
        vs_plain = float((r.w - plain_w).abs().max())
        vs_fp64 = float((r.w.double() - fp64[p].w).abs().max())
        check(vs_plain <= PLAIN_TOL,
              f"resident {M}x{N}: iterate {vs_plain} from its plain version")
        check(vs_fp64 <= ITERATE_TOL,
              f"resident {M}x{N}: iterate {vs_fp64} from the fp64 solve")
        record_err(errors, "resident_solve", vs_plain)
        solve_line("resident", p, r, s, l2_error_host(p, r.w), {
            "seconds_each": [t for _, t in res_runs[p]],
            "max_diff_vs_plain": vs_plain, "max_diff_vs_fp64": vs_fp64})
        lay = rs.resident_layout(cv, *rs.card_geometry(0))
        sms = rs.card_geometry(0)[0]
        print(f"resident geometry {M}x{N}: " + json.dumps({
            "sms": sms, "blocks": lay.blocks, "rows_per_block": lay.rmax,
            "smem_bytes": lay.smem_bytes,
            "fields_in_device_memory": [
                f for f, o in zip(rs.FIELDS, lay.offsets) if o < 0],
            "points_per_thread": lay.points_per_thread,
            "points_in_registers": lay.reg_points}), flush=True)
        check(lay.blocks == min(sms, cv.rows - 2 * fc.HALO),
              f"resident {M}x{N}: {lay.blocks} blocks on {sms} SMs")
        res_iters[f"{M}x{N}"] = (k, s / k * 1e6)
        points = band_points(fc, cv)
        timers.append(timer(
            results, "resident_solve", f"{M}x{N}",
            lambda p=p, cv=cv, cs=cs, cw=cw, g=g, rhs=rhs, sc2=sc2:
                rs.resident_solve(p, cv, cs, cw, g, rhs, sc2),
            lambda p=p, cv=cv, cs=cs, cw=cw, g=g, rhs=rhs, sc2=sc2:
                rs.resident_solve_plain(p, cv, cs, cw, g, rhs, sc2),
            10, 1, points, k))
    print("launches on the resident path: "
          f"{json.dumps(gate.counts(*RESIDENT))} "
          f"for {(1 + REPEATS) * len(RESIDENT_GRIDS)} solves", flush=True)

    elapsed("resident")
    # --- the communication-avoiding path (kernels C, D).
    mid = Problem(M=400, N=600)
    gate.reset()
    ca_runs = {}
    for p in (mid, FLAGSHIP):
        ca.ca_cg_solve(p)                              # warm-up
        ca_runs[p] = [timed(lambda: ca.ca_cg_solve(p))
                      for _ in range(REPEATS)]
    ca_big, ca_big_s = timed(lambda: ca.ca_cg_solve(big))
    counts.update(single_counts(gate.counts(*CA)))
    no_serial("ca")
    pairs = 0
    for p, expected in ((mid, 546), (FLAGSHIP, 989)):
        r, s = min(ca_runs[p], key=lambda rs_: rs_[1])
        k = int(r.iterations)
        check(k == expected, f"ca {p.M}x{p.N}: {k} iterations, expected "
                             f"{expected}")
        check(float(r.diff) < 1e-6, f"ca {p.M}x{p.N}: diff {float(r.diff)}")
        vs_fp64 = float((r.w.double() - fp64[p].w).abs().max())
        check(vs_fp64 <= ITERATE_TOL,
              f"ca {p.M}x{p.N}: iterate {vs_fp64} from the fp64 solve")
        nbytes = costs.iteration_bytes(p, "ca")
        solve_line("ca", p, r, s, l2_error_host(p, r.w), {
            "seconds_each": [t for _, t in ca_runs[p]],
            "max_diff_vs_fp64": vs_fp64,
            "achieved_gbps": nbytes * k / s / 1e9})
        pairs += (1 + REPEATS) * ((k + 1) // 2)
    big_k = int(ca_big.iterations)
    check(abs(big_k - 2449) <= 1,
          f"ca 2400x3200: {big_k} iterations, expected 2449 +- 1")
    check(float(ca_big.diff) < 1e-6, f"ca 2400x3200: diff "
                                     f"{float(ca_big.diff)}")
    ca_big_l2 = l2_error_host(big, ca_big.w)
    check(np.isfinite(ca_big_l2), "ca 2400x3200: non-finite iterate")
    nbytes = costs.iteration_bytes(big, "ca")
    solve_line("ca", big, ca_big, ca_big_s, ca_big_l2, {
        "achieved_gbps": nbytes * big_k / ca_big_s / 1e9})
    pairs += (big_k + 1) // 2
    for name in ("basis_sweep", "pair_update"):
        check(counts[name] >= pairs,
              f"{name}: {counts[name]} launches on the CA path, fewer than "
              f"its {pairs} pairs")
    print(f"launches on the CA path: {json.dumps(gate.counts(*CA))} for "
          f"{pairs} pairs", flush=True)

    elapsed("ca")
    # --- the sharded paths on the 2×2 mesh of one card: kernels A and B's
    # sharded forms (fused-sharded), C and D's (ca-sharded). Counts zeroed
    # just before each path, read just after; each shard launches each form
    # once per step that ``drive`` runs.
    shards = mesh.size
    for p in (mid, FLAGSHIP, big):       # set-up, outside the timed solves
        fs.shard_canvases(p, mesh, 1)
        fs.shard_canvases(p, mesh, cs_.RING)
    mesh_oneshot = {}    # the flagship iterate of each sharded path
    # (path, its kernels' wrappers, solve, iterations per step)
    for path, wrappers, solve, per_step in (
            ("fused-sharded", FUSED, fs.fused_cg_solve_sharded, 1),
            ("ca-sharded", CA, cs_.ca_cg_solve_sharded, 2)):
        gate.reset()
        steps = 0
        for M, N, expected, allowance in SHARDED_EXPECTED:
            p = Problem(M=M, N=N)
            runs = 1 if p == big else REPEATS
            if p != big:
                solve(p, mesh)                          # warm-up
            times = [timed(lambda: solve(p, mesh)) for _ in range(runs)]
            r, sec = min(times, key=lambda rs_: rs_[1])
            k = int(r.iterations)
            check(abs(k - expected) <= allowance,
                  f"{path} {M}x{N}: {k} iterations, expected {expected}"
                  + (f" +- {allowance}" if allowance else ""))
            check(float(r.diff) < 1e-6, f"{path} {M}x{N}: diff "
                                        f"{float(r.diff)}")
            extra = {"mesh": f"{mesh.px}x{mesh.py}",
                     "seconds_each": [t for _, t in times]}
            if p in fp64:
                gap = float((r.w.double() - fp64[p].w).abs().max())
                check(gap <= ITERATE_TOL,
                      f"{path} {M}x{N}: iterate {gap} from the fp64 solve")
                extra["max_diff_vs_fp64"] = gap
            l2 = l2_error_host(p, r.w)
            check(np.isfinite(l2), f"{path} {M}x{N}: non-finite iterate")
            nbytes = costs.iteration_bytes(p, path,
                                           mesh_shape=(mesh.px, mesh.py))
            extra["achieved_gbps"] = nbytes * k / sec / 1e9
            solve_line(path, p, r, sec, l2, extra)
            if p == FLAGSHIP:
                mesh_oneshot[path] = r.w
            cap_steps = (p.iteration_cap + per_step - 1) // per_step
            steps += (runs + (p != big)) * driven_steps(
                -(-k // per_step), cap_steps, CHECK_EVERY)
        launched = gate.counts(*wrappers)
        no_serial(path)
        print(f"launches on the {path} path: {json.dumps(launched)} for "
              f"{steps} steps on {shards} shards", flush=True)
        check(not any(single_counts(launched).values()),
              f"{path}: a single-device kernel form was launched")
        for name, n in sharded_counts(launched).items():
            check(n == shards * steps,
                  f"{path}: {name} launched {n} times, expected "
                  f"{shards} shards x {steps} steps")
        check(gate.counts(*RECURRENCE) == recurrence_counts(
            steps if path == "fused-sharded" else 0),
              f"{path}: recurrence launches {gate.counts(*RECURRENCE)} "
              f"for {steps} steps")
        counts.update(sharded_counts(launched))
    check_sharded_replays(mesh, "2x2 on one card")

    # A mesh across two cards, where the machine has them.
    if torch.cuda.device_count() > 1:
        pair_mesh = make_solver_mesh(["cuda:0", "cuda:1"], grid=(2, 1))
        for path, solve in (("fused-sharded", fs.fused_cg_solve_sharded),
                            ("ca-sharded", cs_.ca_cg_solve_sharded)):
            r, sec = timed(lambda: solve(FLAGSHIP, pair_mesh))
            k = int(r.iterations)
            check(k == 989, f"{path} 2x1 on two cards: {k} iterations")
            gap = float((r.w.double() - w64.w).abs().max())
            check(gap <= ITERATE_TOL, f"{path} 2x1: iterate {gap} from fp64")
            solve_line(path, FLAGSHIP, r, sec, l2_error_host(FLAGSHIP, r.w),
                       {"mesh": "2x1", "devices": ["cuda:0", "cuda:1"],
                        "max_diff_vs_fp64": gap})
        check_sharded_replays(pair_mesh, "2x1 on two cards")
    else:
        print("sharded 2x1 across two cards: not run "
              f"({torch.cuda.device_count()} card visible)", flush=True)

    elapsed("sharded")
    # --- the plain sharded solve (``parallel.pcg_sharded``, the JAX CLI's
    # ``sharded`` backend: plain PyTorch, no kernel of the port) on the 2×2
    # mesh: fp64 Jacobi and fp32 scaled with host setup, and fp64 with
    # device setup, whose fields equal the host's bit for bit (fp32 device
    # setup solves a perturbed problem in both packages: ROADMAP Queue 3).
    # Counts zeroed before, every kernel's read after: none may launch.
    gate.reset()
    for M, N, expected in PLAIN_SHARDED:
        p = Problem(M=M, N=N)
        ps.pcg_solve_sharded(p, mesh)                   # warm-up
        host_k = {}
        for dtype, fields_on in (("float64", "host"), ("float32", "host"),
                                 ("float64", "device")):
            r, sec = timed(lambda: ps.pcg_solve_sharded(
                p, mesh, dtype=getattr(torch, dtype), setup=fields_on))
            k, label = int(r.iterations), f"sharded {dtype} {fields_on}"
            check(k == expected and int(r.flag) == 1,
                  f"{label} {M}x{N}: {k} iterations (flag {int(r.flag)}), "
                  f"expected {expected}")
            gap = float((r.w.double() - fp64[p].w).abs().max())
            tol = SHARDED_FP64_TOL if dtype == "float64" else ITERATE_TOL
            check(gap <= tol, f"{label} {M}x{N}: iterate {gap} from the "
                              f"plain fp64 solve (tol {tol})")
            if fields_on == "host":
                host_k[dtype] = k
            else:
                check(k == host_k[dtype], f"{label} {M}x{N}: {k} iterations,"
                                          f" host setup {host_k[dtype]}")
            solve_line(label, p, r, sec, l2_error_host(p, r.w),
                       {"mesh": f"{mesh.px}x{mesh.py}",
                        "max_diff_vs_fp64": gap})
            if p == FLAGSHIP and (dtype, fields_on) == ("float64", "host"):
                mesh_oneshot["sharded"] = r.w
    gate.expect("the plain sharded path", {})

    elapsed("plain sharded")
    # --- mixed-precision refinement to the fp64 floor at 400×600, over the
    # fused backend (kernels A, B) and the resident one (kernel R, one
    # launch per inner solve). Its own counts, zeroed just before.
    for backend, wrappers in (("fused", FUSED), ("resident", RESIDENT)):
        gate.reset()
        ref, ref_s = timed(lambda: refined_solve(mid, tol=REFINE_TOL,
                                                 backend=backend))
        launched = single_counts(gate.counts(*wrappers))
        no_serial(f"refine {backend}")
        inner = list(ref.inner_iterations)
        norms = list(ref.residual_norms)
        print(f"refine {backend} 400x600: " + json.dumps({
            "seconds": ref_s, "inner_iterations": inner,
            "relative_residual": ref.relative_residual,
            "residual_norms": norms, "launches": launched}), flush=True)
        check(ref.converged and ref.relative_residual <= REFINE_TOL,
              f"refine {backend}: relative residual "
              f"{ref.relative_residual} above {REFINE_TOL}")
        check(inner[0] == 546, f"refine {backend}: first inner solve "
                               f"{inner[0]} iterations, expected 546")
        check(all(b < a for a, b in zip(norms, norms[1:])),
              f"refine {backend}: residuals not decreasing: {norms}")
        least = len(inner) if backend == "resident" else sum(inner)
        for name, n in launched.items():
            check(n >= least, f"refine {backend}: {name} launched {n} "
                              f"times, fewer than {least}")

    elapsed("refine")
    # --- the column-blocked fused path (kernels A′, B′): A and B never run.
    full = ("direction_and_stencil", "fused_update")
    blk = ("direction_and_stencil_blocked", "fused_update_blocked")
    cd = ("basis_sweep", "pair_update")
    steps = 0
    for M, N, bn, *_ in BLOCKED_EXPECTED:       # set-up, outside the timing
        fc.build_canvases(Problem(M=M, N=N), "cuda", bn=bn)
    gate.reset()
    for M, N, bn, expected, allowance, runs in BLOCKED_EXPECTED:
        p = Problem(M=M, N=N)
        if runs > 1:
            fc.fused_cg_solve(p, bn=bn)                 # warm-up
        times = [timed(lambda: fc.fused_cg_solve(p, bn=bn))
                 for _ in range(runs)]
        r, sec = min(times, key=lambda rs_: rs_[1])
        k = int(r.iterations)
        check(abs(k - expected) <= allowance,
              f"blocked {M}x{N} bn={bn}: {k} iterations, expected {expected}"
              + (f" +- {allowance}" if allowance else ""))
        check(float(r.diff) < 1e-6, f"blocked {M}x{N}: diff {float(r.diff)}")
        cv = fc.canvas_spec(p, bn=bn)
        extra = {"bn": bn, "ncb": cv.ncb, "canvas": [cv.rows, cv.cols],
                 "seconds_each": [t for _, t in times]}
        if p in fp64:
            gap = float((r.w.double() - fp64[p].w).abs().max())
            check(gap <= ITERATE_TOL,
                  f"blocked {M}x{N}: iterate {gap} from the fp64 solve")
            extra["max_diff_vs_fp64"] = gap
        l2 = l2_error_host(p, r.w)
        check(np.isfinite(l2), f"blocked {M}x{N}: non-finite iterate")
        extra["achieved_gbps"] = (costs.iteration_bytes(p, "fused", bn=bn)
                                  * k / sec / 1e9)
        solve_line("blocked", p, r, sec, l2, extra)
        steps += (runs + (runs > 1)) * driven_steps(k, p.iteration_cap,
                                                    CHECK_EVERY)
    gate.expect(f"the blocked path ({steps} steps)",
                  {**{name: steps for name in blk},
                   **recurrence_counts(steps)})
    counts.update({name: steps for name in blk})

    elapsed("blocked")
    # --- the serial-reduce mode (kernel S) at 800×1200 on five paths, every
    # count zeroed just before each and checked exactly just after. S sums
    # A's partials in one launch and B's two in another, per step and per
    # shard; C's twelve and D's one per pair.
    steps = driven_steps(989, FLAGSHIP.iteration_cap, CHECK_EVERY)
    pair_steps = driven_steps(-(-989 // 2), (FLAGSHIP.iteration_cap + 1) // 2,
                              CHECK_EVERY)
    counts["serial_sum"] = 0
    serial_oneshot = {}
    for path, solve, names, n, rec_n in (
            ("fused", lambda: fc.fused_cg_solve(FLAGSHIP, serial=True), full,
             steps, steps),
            ("blocked bn=256", lambda: fc.fused_cg_solve(FLAGSHIP, bn=256,
                                                         serial=True), blk,
             steps, steps),
            ("ca", lambda: ca.ca_cg_solve(FLAGSHIP, serial=True), cd,
             pair_steps, 0),
            ("fused-sharded", lambda: fs.fused_cg_solve_sharded(
                FLAGSHIP, mesh, serial=True),
             tuple(f"{k}_sharded" for k in full), shards * steps, steps),
            ("ca-sharded", lambda: cs_.ca_cg_solve_sharded(
                FLAGSHIP, mesh, serial=True),
             tuple(f"{k}_sharded" for k in cd), shards * pair_steps, 0)):
        gate.reset()
        r, sec = timed(solve)
        k = int(r.iterations)
        check(k == 989, f"serial {path} 800x1200: {k} iterations")
        check(float(r.diff) < 1e-6, f"serial {path}: diff {float(r.diff)}")
        gap = float((r.w.double() - w64.w).abs().max())
        check(gap <= ITERATE_TOL, f"serial {path}: iterate {gap} from fp64")
        gate.expect(f"the serial {path} path",
                      {**{name: n for name in names}, "serial_sum": 2 * n,
                       **recurrence_counts(rec_n)})
        counts["serial_sum"] += 2 * n
        solve_line(f"serial {path}", FLAGSHIP, r, sec,
                   l2_error_host(FLAGSHIP, r.w),
                   {"max_diff_vs_fp64": gap, "serial_sum_launches": 2 * n})
        serial_oneshot[path] = r.w

    elapsed("serial")
    # --- the wide probe: 200 iterations at 1024×16384 on the auto-blocked
    # canvas (A′, B′) and at full width (A, B).
    probe = {}
    for label, bn in (("blocked", None), ("full-width", 0)):
        cv = fc.canvas_spec(wide, bn=bn)
        fc.build_canvases(wide, "cuda", bn=bn)     # set-up, outside the timing
        fc.fused_cg_solve(wide, bn=bn)              # warm-up
        gate.reset()
        r, sec = timed(lambda: fc.fused_cg_solve(wide, bn=bn))
        k = int(r.iterations)
        check(k == WIDE["max_iter"], f"wide {label}: {k} iterations")
        check(bool(torch.isfinite(r.w).all()), f"wide {label}: non-finite")
        gate.expect(f"the wide probe {label}",
                      {**{name: k for name in (blk if cv.cg else full)},
                       **recurrence_counts(k)})
        probe[label] = (r, {
            "canvas": [cv.rows, cv.cols], "bn": cv.bn, "ncb": cv.ncb,
            "seconds": sec, "us_per_iter": sec / k * 1e6,
            "setup_s": setup[(wide, bn)]})
    (wb, rec_b), (wf, rec_f) = probe["blocked"], probe["full-width"]
    rel = float((wb.w - wf.w).abs().max() / wf.w.abs().max())
    print("wide probe 1024x16384: " + json.dumps({
        "blocked": rec_b, "full_width": rec_f,
        "blocked_over_full_width": rec_b["us_per_iter"] / rec_f["us_per_iter"],
        "iterate_rel_diff": rel}), flush=True)
    check(rel <= WIDE_TOL, f"wide probe: iterates differ by {rel} relative")

    elapsed("wide probe")
    # --- checkpoint drills at 800×1200, in a directory of the checkout
    # that is removed afterwards.
    ckdir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=root)
    try:
        capped = dataclasses.replace(FLAGSHIP, max_iter=CKPT_CAP)

        def path_of(name: str) -> str:
            return os.path.join(ckdir, f"{name}.npz")

        def counted(label: str, solve, problem, names, start: int = 0,
                    per_step: int = 1):
            """``solve(problem, path, chunk)`` with every count zeroed just
            before it; each of ``names`` must be launched exactly once per
            step its chunks drive from iteration ``start``, and nothing
            else."""
            gate.reset()
            r = solve(problem, path_of(label.split()[0]), chunk=CKPT_CHUNK)
            n = chunk_steps(start, int(r.iterations), problem.iteration_cap,
                            CKPT_CHUNK, CHECK_EVERY, per_step)
            gate.expect(f"drill {label}", {name: n for name in names})
            return r

        def capped_write(name: str, solve, names, per_step: int = 1) -> None:
            part = counted(f"{name} write", solve, capped, names,
                           per_step=per_step)
            check(int(part.iterations) == CKPT_CAP
                  and os.path.exists(path_of(name)),
                  f"drill {name}: capped run gave {int(part.iterations)} "
                  "iterations or left no file")

        def resume(name: str):
            return counted(f"{name} resume", fc.fused_cg_solve_checkpointed,
                           FLAGSHIP, full + RECURRENCE, CKPT_CAP)

        drills = {}
        one = counted("chunks", fc.fused_cg_solve_checkpointed, FLAGSHIP,
                      full + RECURRENCE)
        drills["chunks"] = (one, torch.equal(one.w, fused.w))
        capped_write("resume", fc.fused_cg_solve_checkpointed,
                     full + RECURRENCE)
        got = resume("resume")
        drills["resume"] = (got, torch.equal(got.w, fused.w))
        capped_write("blocked", lambda p, f, chunk:
                     fc.fused_cg_solve_checkpointed(p, f, chunk, bn=256),
                     blk + RECURRENCE)
        drills["blocked_to_full_width"] = (resume("blocked"), None)
        capped_write("ca", ca.ca_cg_solve_checkpointed, cd, per_step=2)
        drills["ca_to_fused"] = (resume("ca"), None)
        for name, (r, bitwise) in drills.items():
            k = int(r.iterations)
            gap = float((r.w.double() - w64.w).abs().max())
            print(f"checkpoint drill {name} 800x1200: " + json.dumps({
                "iterations": k, "bitwise_vs_one_shot": bitwise,
                "max_diff_vs_fp64": gap}), flush=True)
            check(k == 989, f"drill {name}: {k} iterations")
            check(bitwise is not False,
                  f"drill {name}: iterate differs from the one-shot solve")
            check(gap <= ITERATE_TOL, f"drill {name}: iterate {gap} from fp64")
        leftovers = sorted(f for f in os.listdir(ckdir)
                           if f.split(".")[0] in ("chunks", "resume"))
        check(not leftovers, f"converged drills left files: {leftovers}")
        # One checkpoint write at 2400×3200: the device→host copy of the
        # portable state and the sealed, atomic .npz write.
        cv, *_, rhs, _, _ = fc.build_canvases(big, "cuda")
        state = fc._fused_init(big, cv, rhs)
        fp = ck._fingerprint(big, "float32", True)
        writes = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save_state(path_of("big"), fc._fused_to_pcg_state(big, cv,
                                                                  state), fp)
            writes.append(time.perf_counter() - t0)
        check(ck.load_state(path_of("big"), fp) is not None,
              "2400x3200 checkpoint does not read back")
        print("checkpoint write 2400x3200: " + json.dumps({
            "seconds_each": writes,
            "file_bytes": os.path.getsize(path_of("big"))}), flush=True)

        # --- the sharded checkpoint drills at 800×1200 on the 2×2 mesh:
        # the plain sharded driver (fp64; fp32 to resume a fused file),
        # fused-sharded and ca-sharded (also in the serial mode). Every
        # count zeroed before each solve, read after: each sharded kernel
        # form once per shard and driven step, S twice per shard and step
        # in the serial mode, nothing else.
        def plain_ck(problem, f, chunk, serial=False, dtype=None):
            return cks.pcg_solve_sharded_checkpointed(problem, mesh, f,
                                                      chunk=chunk,
                                                      dtype=dtype)

        mesh_drills = (
            ("sharded", plain_ck, (), 1),
            ("fused-sharded", lambda problem, f, chunk, serial=False:
             fs.fused_cg_solve_sharded_checkpointed(problem, mesh, f, chunk,
                                                    serial=serial),
             tuple(f"{k}_sharded" for k in full), 1),
            ("ca-sharded", lambda problem, f, chunk, serial=False:
             cs_.ca_cg_solve_sharded_checkpointed(problem, mesh, f, chunk,
                                                  serial=serial),
             tuple(f"{k}_sharded" for k in cd), 2))
        for path, solve_ck, names, per_step in mesh_drills:
            def drill(label, problem, file, start=0, serial=False, **kw):
                gate.reset()
                r = solve_ck(problem, path_of(file), CKPT_CHUNK, serial,
                             **kw)
                n = shards * chunk_steps(start, int(r.iterations),
                                         problem.iteration_cap, CKPT_CHUNK,
                                         CHECK_EVERY, per_step)
                want = {name: n for name in names}
                if serial:
                    want["serial_sum"] = 2 * n
                if path == "fused-sharded":
                    want.update(recurrence_counts(n // shards))
                gate.expect(f"mesh drill {path} {label} ({n} shard steps)",
                              want)
                return r

            tag = path.replace("-", "_")
            got = {"chunks": drill("chunks", FLAGSHIP, f"{tag}_chunks")}
            bitwise = {"chunks": torch.equal(got["chunks"].w,
                                             mesh_oneshot[path])}
            part = drill("write", capped, f"{tag}_resume")
            check(int(part.iterations) == CKPT_CAP
                  and os.path.exists(path_of(f"{tag}_resume")),
                  f"mesh drill {path}: capped run gave "
                  f"{int(part.iterations)} iterations or left no file")
            got["resume"] = drill("resume", FLAGSHIP, f"{tag}_resume",
                                  CKPT_CAP)
            # The fused driver resumes from the stored direction itself;
            # the CA and plain drivers re-form it (one ulp): counts only.
            bitwise["resume"] = (torch.equal(got["resume"].w,
                                             mesh_oneshot[path])
                                 if path == "fused-sharded" else None)
            gate.reset()
            fc.fused_cg_solve_checkpointed(capped, path_of(f"{tag}_fused"),
                                           CKPT_CHUNK)
            kw = {"dtype": torch.float32} if path == "sharded" else {}
            got["from_single_device_fused"] = drill(
                "from fused", FLAGSHIP, f"{tag}_fused", CKPT_CAP, **kw)
            bitwise["from_single_device_fused"] = None
            if path != "sharded":
                got["serial_chunks"] = drill("serial chunks", FLAGSHIP,
                                             f"{tag}_serial", serial=True)
                bitwise["serial_chunks"] = torch.equal(
                    got["serial_chunks"].w, serial_oneshot[path])
                counts["serial_sum"] += 2 * shards * chunk_steps(
                    0, 989, FLAGSHIP.iteration_cap, CKPT_CHUNK, CHECK_EVERY,
                    per_step)
            for name, r in got.items():
                k = int(r.iterations)
                gap = float((r.w.double() - w64.w).abs().max())
                print(f"checkpoint drill {path} {name} 800x1200: " +
                      json.dumps({"iterations": k, "mesh": "2x2",
                                  "bitwise_vs_one_shot": bitwise[name],
                                  "max_diff_vs_fp64": gap}), flush=True)
                check(k == 989, f"mesh drill {path} {name}: {k} iterations")
                check(bitwise[name] is not False,
                      f"mesh drill {path} {name}: iterate differs from the "
                      "one-shot solve")
                check(gap <= ITERATE_TOL,
                      f"mesh drill {path} {name}: iterate {gap} from fp64")

        # One checkpoint write per sharded backend at 800×1200: gathering
        # the shards' owned points and the sealed, atomic .npz write.
        spec1, sh1 = fs.shard_canvases(FLAGSHIP, mesh, 1)
        spec2, sh2 = fs.shard_canvases(FLAGSHIP, mesh, cs_.RING)
        fused_st = fs._sharded_init(FLAGSHIP, spec1, mesh, sh1, sh1.rhs)
        ca_st = cs_._ca_sharded_init(FLAGSHIP, spec2, mesh, sh2, sh2.rhs)
        geo = ps.geometry(FLAGSHIP, mesh)
        fields = ps.sharded_fields(FLAGSHIP, mesh, geo, "float64", False)
        plain_st = init_state(ps.sharded_ops(FLAGSHIP, mesh, geo, fields,
                                             False), fields.rhs)
        fp32 = ck._fingerprint(FLAGSHIP, "float32", True)
        for path, portable, fp in (
                ("sharded", lambda: cks.portable_state(FLAGSHIP, mesh, geo,
                                                       plain_st),
                 ck._fingerprint(FLAGSHIP, "float64", False)),
                ("fused-sharded", lambda: fs.sharded_portable(
                    FLAGSHIP, spec1, mesh, k=fused_st.k, done=fused_st.done,
                    sol=fused_st.w, r=fused_st.r, pend=fused_st.p,
                    beta=fused_st.beta, zr=fused_st.zr, diff=fused_st.diff),
                 fp32),
                ("ca-sharded", lambda: fs.sharded_portable(
                    FLAGSHIP, spec2, mesh, k=ca_st.k, done=ca_st.done,
                    sol=ca_st.x, r=ca_st.r, pend=ca_st.pprev,
                    beta=ca_st.beta, zr=ca_st.rr, diff=ca_st.diff), fp32)):
            file = path_of(f"{path.replace('-', '_')}_write")
            writes = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ck.save_state(file, portable(), fp)
                writes.append(time.perf_counter() - t0)
            check(ck.load_state(file, fp) is not None,
                  f"{path} checkpoint does not read back")
            print(f"checkpoint write {path} 800x1200 2x2: " + json.dumps({
                "seconds_each": writes,
                "file_bytes": os.path.getsize(file)}), flush=True)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    elapsed("checkpoint drills")
    # --- the batched phase: plain PyTorch, no kernel of the port. Counts
    # zeroed before, every kernel's read after: none may launch.
    gate.reset()
    batch = check_batched(bt, lanes, mesh, FLAGSHIP, mid, fp64, pcg_solve,
                          metrics, card)
    gate.expect("the batched phase", {})

    elapsed("batched")
    # --- the MG phase: plain PyTorch, no kernel of the port, beside the
    # kernel paths' figures from this run (µs per iteration).
    figures = {"800x1200": {"fused_us_per_iter": flag_s / iters * 1e6},
               "2400x3200": {"fused_us_per_iter":
                             big_s / big_iters * 1e6}}
    for tag, (_, solve_us) in res_iters.items():
        figures.setdefault(tag, {})["resident_us_per_iter"] = solve_us
    gate.reset()
    check_mg(mg, bt, lanes, ck, pcg_solve, fp64, figures, card)
    gate.expect("the MG phase", {})

    elapsed("mg")
    # --- the resilience phase: plain PyTorch, no kernel of the port.
    gate.reset()
    check_resilience(pcg_solve, metrics, card)
    gate.expect("the resilience phase", {})

    elapsed("resilience")
    # --- the geometry phase: plain PyTorch, no kernel of the port.
    gate.reset()
    check_geometry(pcg_solve, metrics, card)
    gate.expect("the geometry phase", {})

    elapsed("geometry")
    # --- the Krylov phase: plain PyTorch, no kernel of the port.
    gate.reset()
    check_krylov(pcg_solve, metrics, card)
    gate.expect("the Krylov phase", {})

    elapsed("krylov")
    # --- the measurement phase, timed part: the bench's records (its
    # flagship drives kernels A and B), the native oracle, the history seam.
    gate.reset()
    ab = check_front_door(fc, pcg_solve, fp64, card)
    gate.expect("the measurement phase",
                  {"direction_and_stencil": ab, "fused_update": ab,
                   **recurrence_counts(ab)})

    elapsed("measurement")
    # --- the service phase: the solve service on the card and the chaos
    # campaign; the plain solves, no kernel of the port.
    gate.reset()
    check_serve(pcg_solve, metrics, card)
    gate.expect("the service phase", {})

    elapsed("service")
    # --- the tooling phase: the bench's remaining modes, the contract gate,
    # the selfcheck, and the solve command's last flags; kernels A and B on
    # the --save-solution solves only.
    gate.reset()
    ab = check_tooling(pcg_solve, metrics, card, root)
    gate.expect("the tooling phase",
                  {"direction_and_stencil": ab, "fused_update": ab,
                   **recurrence_counts(ab)})

    elapsed("tooling")
    # --- the multi-process phase: two ranks of this script, each driving
    # two shards of the 2x2 mesh across a process boundary (kernels A-D
    # sharded), against the same mesh driven by this process.
    gate.reset()
    mp = check_multiprocess(mesh, fs, cs_, ps, card, root)
    gate.expect("the multi-process phase (this process's references)", {
        "direction_and_stencil_sharded": mp["fused-sharded"],
        "fused_update_sharded": mp["fused-sharded"],
        "basis_sweep_sharded": mp["ca-sharded"],
        "pair_update_sharded": mp["ca-sharded"],
        **recurrence_counts(mp["fused-sharded"] // mesh.size)})

    elapsed("multiprocess")
    for time_it in timers:
        time_it()

    # Kernel R per iteration (device time of the whole launch over its
    # count) beside its solve's, and kernel C's two forms against their
    # bound at both grids and both shard sizes.
    print("resident per iteration (us): " + json.dumps({
        tag: {"kernel": results["resident_solve"][tag]["ms"] * 1e3 / k,
              "solve": solve_us}
        for tag, (k, solve_us) in res_iters.items()}), flush=True)
    print("basis sweep share of bound: " + json.dumps({
        f"{name} {tag}": {"us": rec["ms"] * 1e3,
                          "bound_us": rec["bound_ms"] * 1e3,
                          "share": rec["bound_ms"] / rec["ms"]}
        for name in ("basis_sweep", "basis_sweep_sharded")
        for tag, rec in results[name].items()}), flush=True)
    # Kernel S beside torch.sum over the same partials (A's one vector, C's
    # twelve against torch.sum(dim=0)), device µs per launch, both timed
    # by the profiler in this run, beside S's chain latency bound; the
    # target is S no slower.
    print("serial_sum vs torch.sum (device us per launch): " + json.dumps({
        tag: {"serial_sum": rec["ms"] * 1e3,
              "torch_sum": rec["library_ms"] * 1e3,
              "no_slower": rec["ms"] <= rec["library_ms"],
              **results["serial_chain"][tag]}
        for tag, rec in results["serial_sum"].items()}), flush=True)
    # A′ and B′ against A and B at the wide probe (device µs per launch).
    wide_us = {name: results[name]["1024x16384"]["ms"] * 1e3
               for name in ("direction_stencil", "fused_update",
                            "direction_stencil_blocked",
                            "fused_update_blocked")}
    print(f"wide probe kernels 1024x16384 (device us per launch): "
          f"{json.dumps(wide_us)}", flush=True)

    # Where one flagship solve's time goes: device time by kernel against
    # the host's wall clock (profiled, so the wall includes its overhead).
    for path, solve in (
            ("fused", fc.fused_cg_solve),
            ("blocked", lambda p: fc.fused_cg_solve(p, bn=256)),
            ("ca", ca.ca_cg_solve),
            ("fused-sharded", lambda p: fs.fused_cg_solve_sharded(p, mesh)),
            ("ca-sharded", lambda p: cs_.ca_cg_solve_sharded(p, mesh))):
        prof, prof_wall = profile_kernels(lambda: solve(FLAGSHIP))
        if prof is None:
            print(f"profile {path} 800x1200: the profiler recorded no device "
                  "activity", flush=True)
            continue
        busy_us = sum(us for _, us in prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:8]
        print(f"profile {path} 800x1200: " + json.dumps({
            "wall_s": prof_wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall,
            "launches_per_iter": sum(n for n, _ in prof.values()) / iters,
            "top_kernels": [{"name": k[:80], "count": n, "us": us}
                            for k, (n, us) in top],
        }), flush=True)

    # One batched solve (B=16), capped: launches and device time per
    # batched iteration.
    prof, prof_wall = profile_kernels(lambda: bt.solve_batched(
        dataclasses.replace(FLAGSHIP, max_iter=BATCH_PROFILE_ITERS),
        rhs_gates=batch["gates"], dtype=torch.float32))
    if prof is None:
        print("profile batched 800x1200: the profiler recorded no device "
              "activity", flush=True)
    else:
        k = BATCH_PROFILE_ITERS
        busy_us = sum(us for _, us in prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:8]
        print(f"profile batched fp32 800x1200 B={BATCH} ({k} iterations) "
              f"[{card}]: " + json.dumps({
                  "wall_s": prof_wall, "device_busy_s": busy_us / 1e6,
                  "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall,
                  "launches_per_batched_iteration":
                      sum(n for n, _ in prof.values()) / k,
                  "device_us_per_batched_iteration": busy_us / k,
                  "top_kernels": [{"name": name[:80], "count": n, "us": us}
                                  for name, (n, us) in top]}), flush=True)

    # One MG solve at 800x1200 (fp32, no kernel of the port): launches and
    # device time per iteration, and the device's idle share.
    mg_out = {}
    prof, prof_wall = profile_kernels(lambda: mg_out.setdefault(
        "r", pcg_solve(FLAGSHIP, dtype=torch.float32, preconditioner="mg")))
    if prof is None:
        print("profile mg 800x1200: the profiler recorded no device "
              "activity", flush=True)
    else:
        k = int(mg_out["r"].iterations)
        busy_us = sum(us for _, us in prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:8]
        print(f"profile mg fp32 800x1200 ({k} iterations) [{card}]: "
              + json.dumps({
                  "wall_s": prof_wall, "device_busy_s": busy_us / 1e6,
                  "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall,
                  "launches_per_iter": sum(n for n, _ in prof.values()) / k,
                  "device_us_per_iter": busy_us / k,
                  "wall_us_per_iter": prof_wall / k * 1e6,
                  "top_kernels": [{"name": name[:80], "count": n, "us": us}
                                  for name, (n, us) in top]}), flush=True)

    # One capped fp32 block solve (B = 16, no kernel of the port): device
    # time per block iteration by kind (matrix products, eigensolves, the
    # rest) against its wall clock.
    from poisson_tpu_torch.krylov.block import clustered_ellipse_stack

    kry = FLAGSHIP.with_(max_iter=KRY_PROFILE_ITERS)
    stack = clustered_ellipse_stack(kry, KRY_BLOCK_B)[0]
    bt.solve_batched(kry, rhs_stack=stack, dtype=torch.float32,
                     mode="block")                 # warm-up
    prof, prof_wall = profile_kernels(lambda: bt.solve_batched(
        kry, rhs_stack=stack, dtype=torch.float32, mode="block"))
    if prof is None:
        print("profile krylov block 800x1200: the profiler recorded no "
              "device activity", flush=True)
    else:
        k = KRY_PROFILE_ITERS
        kinds = {"gemm": 0.0, "eigh": 0.0, "other": 0.0}
        for name, (_, us) in prof.items():
            low = name.lower()
            kind = ("gemm" if any(k in low for k in ("gemm", "cutlass",
                                                        "xmma")) else
                    "eigh" if any(k in low for k in (
                        "syev", "sytrd", "steqr", "stedc", "laed", "ormqr",
                        "ormtr", "sterf")) else "other")
            kinds[kind] += us
        busy_us = sum(us for _, us in prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:8]
        print(f"profile krylov block fp32 800x1200 B={KRY_BLOCK_B} ({k} "
              f"block iterations) [{card}]: " + json.dumps({
                  "wall_s": prof_wall, "device_busy_s": busy_us / 1e6,
                  "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall,
                  "wall_us_per_block_iteration": prof_wall / k * 1e6,
                  "device_us_per_block_iteration": {
                      kind: us / k for kind, us in kinds.items()},
                  "launches_per_block_iteration":
                      sum(n for n, _ in prof.values()) / k,
                  "top_kernels": [{"name": name[:80], "count": n, "us": us}
                                  for name, (n, us) in top]}), flush=True)

    # Launches per iteration of the capped fp32 flagship solve with the
    # probe and the stream off and on (no kernel of the port).
    capped = FLAGSHIP.with_(max_iter=RES_PROFILE_ITERS)
    per_iter = {}
    for name, kwargs in (("plain", {}), ("verify_every_5",
                                          {"verify_every": 5}),
                         (f"stream_every_{RES_STREAM}",
                          {"stream_every": RES_STREAM})):
        prof, prof_wall = profile_kernels(
            lambda: pcg_solve(capped, dtype=torch.float32, **kwargs))
        if prof is not None:
            per_iter[name] = {
                "launches_per_iter": sum(n for n, _ in prof.values())
                / RES_PROFILE_ITERS,
                "device_us_per_iter": sum(us for _, us in prof.values())
                / RES_PROFILE_ITERS,
                "wall_us_per_iter": prof_wall / RES_PROFILE_ITERS * 1e6}
    print(f"profile resilience fp32 800x1200 ({RES_PROFILE_ITERS} "
          f"iterations) [{card}]: " + json.dumps(per_iter), flush=True)

    # --- the measurement phase, profiled part: obs.profile around one
    # fused solve (kernels A and B), the history seam's launches, and the
    # run's registry through obs.export.
    gate.reset()
    ab = check_capture(fc, pcg_solve, metrics, card, root)
    gate.expect("the measurement capture",
                  {"direction_and_stencil": ab, "fused_update": ab,
                   **recurrence_counts(ab)})

    elapsed("timers and profiles")
    line = []
    for name, kernel in KERNELS.items():
        rec = results[name]
        tags = [kernel.main] + [t for t in rec if t != kernel.main]
        main_rec = rec[tags[0]]
        entry = {
            "name": name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces,
            "launches": counts[kernel.wrapper],
            "max_abs_err": errors[name],
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "timing": main_rec["timing"], "shape": tags[0],
        }
        for tag in tags[1:]:
            for key in ("ms", "plain_ms", "bound_ms"):
                entry[f"{key}_{tag}"] = rec[tag][key]
        line.append(entry)
    for entry in line:
        check(entry["launches"] > 0, f"{entry['name']}: no launch on its "
                                     "path")
    check(not any(m.split(".")[0] in ("jax", "jaxlib", "poisson_tpu")
                  for m in sys.modules), "the JAX package was imported")
    print(f"nvidia-smi: {card}", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        multiprocess_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                            "--nccl" in sys.argv[5:])
    else:
        main()
