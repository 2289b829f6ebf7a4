"""gate: one scalar gate per solve, uniform in ``gates`` = [lo, hi], drawn
from the seed; the entry scales its own B by it,
``fn(problem, rhs_gate=g, device=)``, and the reference solves B·g with
the reference's own B."""

from __future__ import annotations

from cellbench import program
from cellbench.reference.fields import rhs
from cellbench.traffic import STREAM_GATES, Input, rng

COUNT = 1 << 16     # gates drawn up front; a longer run wraps around


class Inputs:
    def __init__(self, traffic: dict, g, seed: int):
        self.grid, self.base = g, rhs(g)
        lo, hi = traffic["gates"]
        self.gates = rng(seed, STREAM_GATES).uniform(lo, hi, COUNT)

    def input(self, i: int) -> Input:
        gate = float(self.gates[i % COUNT])
        return Input(i, ("gate", gate), None, gate)

    def reference_rhs(self, inp: Input):
        """The full fp64 right-hand side that ``inp`` stands for."""
        return self.base * inp.gate

    def bind(self, fn, problem, devices):
        def send(inp):
            return program.answer(fn(problem, rhs_gate=inp.gate,
                                     device=devices[0]))

        return send
