"""rhs: a pool of ``pool`` right-hand-side grids B·(1 + amplitude·φ), made
from the seed and sent in turn; the entry takes the grid,
``fn(problem, rhs, device=)``.

φ (:func:`cellbench.traffic.perturbation`) is a sum of ``modes`` products
of sines with seeded wavenumbers in 1..``wavenumbers`` and seeded phases,
weights summing to 1 in magnitude, so |φ| ≤ 1 and φ has no mirror or
transpose symmetry. B is the reference's own
(:mod:`cellbench.reference.fields`), never the program's.
"""

from __future__ import annotations

from cellbench import program
from cellbench.reference.fields import rhs
from cellbench.traffic import STREAM_PHI, Input, perturbation, rng


class Inputs:
    def __init__(self, traffic: dict, g, seed: int):
        self.grid, self.base = g, rhs(g)
        r = rng(seed, STREAM_PHI)
        self.pool = [self.base * (1.0 + traffic["amplitude"] * perturbation(
            g, r, traffic["modes"], traffic["wavenumbers"]))
            for _ in range(traffic["pool"])]

    def input(self, i: int) -> Input:
        slot = i % len(self.pool)
        return Input(i, ("rhs", slot), self.pool[slot], None)

    def reference_rhs(self, inp: Input):
        """The full fp64 right-hand side that ``inp`` stands for."""
        return inp.rhs

    def bind(self, fn, problem, devices):
        def send(inp):
            return program.answer(fn(problem, inp.rhs, device=devices[0]))

        return send
