"""Lane stepping for continuous batching: the resumable batched PCG
(counterpart of ``poisson_tpu/solvers/lanes.py``).

``solvers.batched`` runs a bucket to completion: a member that converges
early holds its lane until the slowest stops. A :class:`LaneBatch` steps
the same batched body a chunk at a time and returns to the host, where
done lanes are retired and new right-hand sides spliced into the freed
slots, with no restart of the members in flight.

Three facts make a splice sound, as in the JAX package:

1. **Per-member independence.** Every sum of the ops bundle is per member
   (``ops.stencil.member_sums``) and every other step elementwise, so lane
   i's trajectory depends on lane i's state alone: writing a member into
   lane j changes no bit of lane i.
2. **Chunk invariance.** A step freezes each lane at its own
   ``stop_at = min(k + chunk, cap)`` (``batched.step_members``); stepping
   on from the carried state continues the same sequence.
3. **Identity.** ``origin[lane]`` carries the member id through every
   splice and retire; an EMPTY lane (``origin[lane] is None``) is a zero
   member, already stopped, that the loop never advances.

The lane state lives on an explicit ``device`` (default ``cuda``): fields
(bucket, M+1, N+1), member scalars (bucket, 1, 1). Splice and retire
write and read one slot in place.

``preconditioner="mg"`` steps every lane with one V-cycle per iteration
on one shared hierarchy (``poisson_tpu_torch.mg``); a spliced member is
the MG solve's ``init_state``, so it still equals its solo solve. As in
the JAX package, MG lanes carry no per-lane geometries.

``multi_geometry=True`` gives every lane its own canvases: a, b and aux
are (bucket, M+1, N+1) stacks beside the state, seeded with the reference
ellipse's, and ``splice(..., geometry=spec)`` copies the spec's
fingerprint-cached canvases into the lane's slot in place, so the stepping
of the other lanes is unchanged and the spliced member equals
``pcg_solve(problem, geometry=spec, rhs_gate=…)`` bit for bit.

``verify_every`` > 0 arms the integrity probe per lane: a verified table
carries each lane's own right-hand side beside the state (written at
splice), so a flipped bit in one lane stops that lane alone with
FLAG_INTEGRITY (``testing.faults.bitflip_lane`` is the drill).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.mg.hierarchy import (
    mg_config_for,
    resolve_preconditioner,
)
from poisson_tpu_torch.mg.preconditioner import mg_solve_setup
from poisson_tpu_torch.solvers.batched import (
    member_rhs,
    step_members,
)
from poisson_tpu_torch.solvers.pcg import (
    FLAG_NAMES,
    PCGState,
    gate_rhs,
    init_state,
    make_pcg_body,
    resolve_verify_tol,
    setup_from_fields,
    solve_fields,
    solve_setup,
)


class LaneResult(NamedTuple):
    """One retired lane's attributed outcome (host-side values)."""

    member_id: object         # the id given at splice time — never None
    lane: int
    w: torch.Tensor           # solution grid, scaling already undone
    iterations: int
    diff: float
    residual_dot: float
    flag: int                 # solvers.pcg FLAG_* verdict at retirement

    @property
    def flag_name(self) -> str:
        return FLAG_NAMES.get(self.flag, str(self.flag))


class LaneBatch:
    """A fixed-width bucket of solve lanes driven chunk by chunk.

    ``splice(member_id, rhs_gate)`` loads a member into a free lane (the
    problem's RHS times ``rhs_gate``: the member then reproduces
    ``pcg_solve(problem, rhs_gate=rhs_gate)`` bit for bit); ``step()``
    advances every lane by at most ``chunk`` of its own iterations;
    ``lane_view()`` reads each lane's (k, done, flag, diff); ``retire(lane)``
    takes the attributed result out and empties the lane. The caller owns
    the schedule; any interleaving keeps identities and trajectories.
    ``preconditioner="mg"`` (with ``mg_config``) runs the V-cycle in every
    lane; ``verify_every`` > 0 (``verify_tol``, default by dtype) arms the
    per-lane integrity probe; ``multi_geometry`` carries per-lane canvases
    (``splice(..., geometry=)``), which MG lanes do not."""

    def __init__(self, problem: Problem, bucket: int, *, dtype=None,
                 scaled=None, chunk: int = 50, multi_geometry: bool = False,
                 verify_every: int = 0, verify_tol=None,
                 preconditioner: str = "jacobi", mg_config=None,
                 device=None):
        if bucket < 1:
            raise ValueError(f"bucket must be >= 1, got {bucket}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if multi_geometry and resolve_preconditioner(preconditioner) == "mg":
            raise ValueError(
                "preconditioner='mg' lanes do not carry per-lane "
                "geometries yet; build a jacobi table or dispatch "
                "geometry+MG requests solo")
        self._mg_config = mg_config_for(problem, preconditioner, mg_config)
        self.problem = problem
        self.bucket = int(bucket)
        self.chunk = int(chunk)
        # The operator is f_val-free; the member RHS keeps problem.f_val.
        unit = problem.with_(f_val=1.0)
        setup = (solve_setup(unit, dtype, scaled, device, members=True)
                 if self._mg_config is None else
                 mg_solve_setup(unit, dtype, scaled, device, members=True,
                                config=self._mg_config))
        self.device = setup.rhs.device
        self.dtype_name = setup.dtype_name
        self.use_scaled = setup.scaled
        self._ops, self._aux = setup.ops, setup.aux
        self._check_every = setup.check_every
        self._rhs = member_rhs(problem, problem.f_val, setup.scaled,
                               setup.rhs.dtype, self.device)
        self.multi_geometry = bool(multi_geometry)
        self._unit = unit
        if self.multi_geometry:
            # Per-lane canvases, seeded with the reference ellipse's; an
            # EMPTY lane keeps the last occupant's (it is frozen either
            # way). A splice overwrites one slot of each in place.
            self._default = solve_fields(problem, self.dtype_name,
                                         self.use_scaled, self.device)
            wide = (self.bucket,) + problem.grid_shape
            self._a_stack, self._b_stack, self._aux_stack = (
                self._default[i].expand(wide).clone() for i in (0, 1, 3))
            self._ops = setup_from_fields(
                unit, self._a_stack, self._b_stack, None, self._aux_stack,
                self.dtype_name, self.use_scaled, members=True).ops
        # Every lane starts EMPTY: a zero member, stopped. Each field gets
        # its own storage (init_state aliases p with z and r with the
        # rhs), so a slot write touches one field only.
        zeros = self._rhs.new_zeros((self.bucket,) + problem.grid_shape)
        # A verified table keeps each lane's own RHS (EMPTY lanes: zero),
        # which the probe reads; unverified, nothing is kept.
        self.verify_every = int(verify_every)
        self.verify_tol = (resolve_verify_tol(verify_tol, self.dtype_name)
                           if self.verify_every > 0 else 0.0)
        self._rhs_stack = zeros.clone() if self.verify_every > 0 else None
        self._body = make_pcg_body(
            self._ops, delta=problem.delta,
            weighted_norm=problem.weighted_norm, h1=problem.h1,
            h2=problem.h2, verify_every=self.verify_every,
            verify_tol=self.verify_tol, verify_rhs=self._rhs_stack,
            preconditioner=setup.preconditioner)
        init = init_state(self._ops, zeros)
        self.state = PCGState(*(f.clone() for f in init._replace(
            done=torch.ones_like(init.done))))
        self._blank = PCGState(*(f[0].clone() for f in self.state))
        self.origin: List[object] = [None] * self.bucket
        self.steps = 0                # chunk steps executed
        self.idle_lane_steps = 0      # Σ over steps of non-ACTIVE lanes

    # -- occupancy -----------------------------------------------------

    def free_lanes(self) -> List[int]:
        return [i for i, m in enumerate(self.origin) if m is None]

    def active_lanes(self) -> List[int]:
        return [i for i, m in enumerate(self.origin) if m is not None]

    def occupied(self) -> bool:
        return any(m is not None for m in self.origin)

    # -- the state machine ---------------------------------------------

    def _write(self, lane: int, member: PCGState) -> None:
        for full, one in zip(self.state, member):
            full[lane].copy_(one)

    def splice(self, member_id, rhs_gate: float = 1.0,
               lane: Optional[int] = None, geometry=None) -> int:
        """EMPTY → ACTIVE: load ``member_id``'s solve into a free lane
        (the first, unless ``lane`` is given): the sequential solver's
        ``init_state`` of ``rhs · rhs_gate``. ``geometry`` (multi-geometry
        tables only) puts the member's own canvases into the lane; None is
        the reference ellipse. Returns the lane."""
        if member_id is None:
            raise ValueError("member_id must not be None (None marks an "
                             "EMPTY lane)")
        if member_id in self.origin:
            raise ValueError(f"member {member_id!r} already occupies lane "
                             f"{self.origin.index(member_id)}")
        if geometry is not None and not self.multi_geometry:
            raise ValueError(
                "this LaneBatch was built single-geometry; construct it "
                "with multi_geometry=True to splice per-member domains")
        if lane is None:
            free = self.free_lanes()
            if not free:
                raise ValueError("no EMPTY lane to splice into")
            lane = free[0]
        elif self.origin[lane] is not None:
            raise ValueError(f"lane {lane} is ACTIVE (member "
                             f"{self.origin[lane]!r})")
        ops, rhs = self._ops, self._rhs
        if self.multi_geometry:
            # The member's own fields (pcg_solve(problem, geometry=)'s).
            ga, gb, rhs, gaux = (
                self._default if geometry is None else solve_fields(
                    self.problem, self.dtype_name, self.use_scaled,
                    self.device, geometry))
            for stack, field in ((self._a_stack, ga), (self._b_stack, gb),
                                 (self._aux_stack, gaux)):
                stack[lane].copy_(field)
            ops = setup_from_fields(self._unit, ga[None], gb[None], None,
                                    gaux[None], self.dtype_name,
                                    self.use_scaled, members=True).ops
        rhs = gate_rhs(rhs, rhs_gate)
        member = init_state(ops, rhs[None])
        if self._mg_config is not None:
            obs.inc("mg.solves")     # a lane splice is one MG solve
        self._write(lane, PCGState(*(f[0] for f in member)))
        if self._rhs_stack is not None:
            self._rhs_stack[lane].copy_(rhs)
        self.origin[lane] = member_id
        return lane

    def step(self) -> dict:
        """Advance every ACTIVE lane by at most ``chunk`` iterations.
        Returns ``{"active": n, "idle": n}`` for the step (idle lanes are
        EMPTY slots whose width the batch still computes)."""
        active = len(self.active_lanes())
        idle = self.bucket - active
        if active:
            s = self.state
            stop_at = torch.clamp(s.k + self.chunk,
                                  max=self.problem.iteration_cap)
            self.state = step_members(self._body, s, stop_at, self.chunk,
                                      self._check_every)
            self.steps += 1
            self.idle_lane_steps += idle
        return {"active": active, "idle": idle}

    def lane_view(self) -> List[dict]:
        """Each lane's truth after a step (EMPTY lanes included, with
        ``member_id=None``): lane, member_id, k, done, flag, diff."""
        s = self.state
        ks, dones, flags, diffs = (x.reshape(-1).tolist() for x in
                                   (s.k, s.done, s.flag, s.diff))
        return [{"lane": i, "member_id": self.origin[i], "k": int(ks[i]),
                 "done": bool(dones[i]), "flag": int(flags[i]),
                 "diff": float(diffs[i])} for i in range(self.bucket)]

    def retire(self, lane: int) -> LaneResult:
        """ACTIVE → EMPTY: the lane's attributed result (its iterate as it
        stands, whatever stopped it), and the slot cleared for the next
        splice."""
        member_id = self.origin[lane]
        if member_id is None:
            raise ValueError(f"lane {lane} is already EMPTY")
        member = PCGState(*(f[lane].clone() for f in self.state))
        self._write(lane, self._blank)
        aux = self._aux_stack[lane] if self.multi_geometry else self._aux
        w = member.w * aux if self.use_scaled else member.w
        self.origin[lane] = None
        return LaneResult(member_id=member_id, lane=lane, w=w,
                          iterations=int(member.k), diff=float(member.diff),
                          residual_dot=float(member.zr),
                          flag=int(member.flag))
