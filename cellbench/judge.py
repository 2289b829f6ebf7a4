"""Whether what the timed path produced is correct: the sampled answers of
the window held against the plain reference, each compared number beside
its limit (``limits/<workload>.json``).

  w_err   the largest, over the sampled solves, of max|w − w_ref| / max|w_ref|
          on the full grid
  k_gap   the largest, over the sampled solves, of |k − k_ref|

The reference (:mod:`cellbench.reference`) solves each sampled input once,
in fp64, on the first card used, after the window has closed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cellbench.reference.pcg import Operator, solve

NUMBERS = ("w_err", "k_gap")


def reference_answers(grid, inputs, sent, device, dtype=torch.float64,
                      cap=None) -> dict:
    """key → (w_ref, k_ref) for each distinct input of ``sent``, solved
    once; ``inputs`` gives the right-hand side each stands for."""
    op = Operator(grid, device, dtype)
    out = {}
    for inp in sent:
        if inp.key not in out:
            out[inp.key] = solve(op, inputs.reference_rhs(inp), cap)
    return out


def compare(kept, reference: dict) -> dict:
    """The compared numbers over the kept (input, w, k) answers."""
    w_err = k_gap = 0.0
    for inp, w, k in kept:
        w_ref, k_ref = reference[inp.key]
        w = np.asarray(w, np.float64)
        err = (np.max(np.abs(w - w_ref)) / np.max(np.abs(w_ref))
               if w.shape == w_ref.shape else math.inf)
        w_err = max(w_err, float(err)) if not math.isnan(err) else math.nan
        k_gap = max(k_gap, float(abs(k - k_ref)))
    return {"w_err": w_err, "k_gap": k_gap}


def checks(numbers: dict, limits: dict) -> dict:
    """Each number beside its limit, in the result line's form; a number
    that could not be read (no answer, NaN) is None."""
    return {name: {"value": numbers[name] if math.isfinite(numbers[name])
                   else None, "limit": limits[name]}
            for name in NUMBERS}


def passed(check: dict) -> bool:
    """Every number read and within its limit."""
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in check.values())
