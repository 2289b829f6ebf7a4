"""mesh_gate: the gates of ``inputs/gate.py``
(one scalar gate a solve, uniform in ``gates``, from the seed), sent to a
sharded entry over a mesh of the run's devices shaped by the port's own
rule (``make_solver_mesh``: 2x2 over four),
``fn(problem, mesh, rhs_gate=g)``."""

from cellbench import program, spec


class Inputs(spec.module("inputs", "gate").Inputs):
    def bind(self, fn, problem, devices):
        from poisson_tpu_torch.parallel.mesh import make_solver_mesh

        mesh = make_solver_mesh(devices)

        def send(inp):
            return program.answer(fn(problem, mesh, rhs_gate=inp.gate))

        return send
