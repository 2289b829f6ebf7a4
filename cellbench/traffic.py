"""The traffic of a run: a mix's parameters and the seed → what the window
sends, and what it got back.

A mix (``traffic/<name>.json``) is data. Besides its own parameters it
names three things, each found by name:

  loop     ``loops/<loop>.py``: how the window sends solves (``warm`` in
           set-up, ``run`` for the window)
  input    ``inputs/<input>.py``: its ``Inputs(traffic, grid, seed)``
           makes every input of a run from the seed before the window,
           gives the fp64 right-hand side each stands for, and ``bind`` s
           the program's entry into ``send(input) -> (w, k)``
  call     the program's entry, "module:function" of the port
  judged   how many answers of a run, sampled from the seed, are held
           against the reference

So a mix that needs another loop or another kind of input (an open loop,
a batch a call) is new files, and a mix that varies the parameters of
these is a data file alone. Every seed gives the same sizes and loop;
only the seeded values differ.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from cellbench import spec
from cellbench.reference.fields import Grid, nodes

# Independent random streams of one seed.
STREAM_PHI, STREAM_GATES, STREAM_SAMPLE = 1, 2, 3


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for ``stream`` (any whole number is a seed)."""
    return np.random.default_rng([seed & (2 ** 64 - 1), stream])


def perturbation(g: Grid, r: np.random.Generator, modes: int,
                 wavenumbers: int) -> np.ndarray:
    """φ on the full grid, |φ| ≤ 1: Σ c_m sin(π k_m ξ + θ_m) sin(π l_m η + ψ_m)
    with ξ, η the node coordinates scaled to [0, 1] and Σ |c_m| = 1."""
    x, y = nodes(g)
    xi = (x - g.x_min) / (g.x_max - g.x_min)
    eta = (y - g.y_min) / (g.y_max - g.y_min)
    k = r.integers(1, wavenumbers + 1, size=(modes, 2))
    phase = r.uniform(0.0, 2.0 * np.pi, size=(modes, 2))
    c = r.uniform(0.5, 1.0, size=modes) * r.choice((-1.0, 1.0), size=modes)
    c /= np.abs(c).sum()
    phi = np.zeros(g.shape)
    for m in range(modes):
        phi += c[m] * (np.sin(np.pi * k[m, 0] * xi + phase[m, 0])
                       * np.sin(np.pi * k[m, 1] * eta + phase[m, 1]))
    return phi


class Input(NamedTuple):
    """One solve's input: a right-hand-side grid, or a gate."""

    index: int
    key: tuple               # equal keys, equal inputs (the reference solves each once)
    rhs: np.ndarray | None
    gate: float | None


class Window(NamedTuple):
    """What a loop's window did."""

    setup_s: float
    t_start: float
    t_end: float            # end of the last solve
    latencies: tuple        # seconds from due to answer, every solve sent
    iterations: tuple       # counts of the solves that answered
    failed: int
    error: str
    kept: tuple             # the sample: (input, w, k)
    profiled: int           # solves inside the traced slice
    events: tuple           # the slice's events (traced runs)


def inputs(traffic: dict, g: Grid, seed: int, root=spec.ROOT):
    """The mix's inputs for one run: ``inputs/<input>.py``'s ``Inputs``."""
    return spec.module("inputs", traffic["input"], root).Inputs(traffic, g,
                                                                seed)


def loop(traffic: dict, root=spec.ROOT):
    """The mix's loop: ``loops/<loop>.py``."""
    return spec.module("loops", traffic["loop"], root)


class Sample:
    """A uniform sample of ``size`` answers from a stream of unknown length
    (reservoir sampling), drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.kept = size, []
        self._rng = rng(seed, STREAM_SAMPLE)

    def offer(self, i: int, item) -> None:
        if i < self.size:
            self.kept.append(item)
            return
        j = int(self._rng.integers(0, i + 1))
        if j < self.size:
            self.kept[j] = item
