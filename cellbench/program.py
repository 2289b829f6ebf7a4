"""The program under test as a mix's ``call`` names it: its ``Problem``
from the configuration, its entry, and the entry's answer on the host.

Only ``poisson_tpu_torch`` is called, through the public entry a mix
names; nothing else of the program is read. How the entry takes an input
is the mix's input module's (``inputs/<input>.py``).
"""

from __future__ import annotations

import importlib

import numpy as np

PROGRAM = "poisson_tpu_torch"


def problem(config: dict):
    from poisson_tpu_torch.config import Problem

    dom = config["domain"]
    return Problem(M=config["grid"]["M"], N=config["grid"]["N"],
                   x_min=dom["x_min"], x_max=dom["x_max"],
                   y_min=dom["y_min"], y_max=dom["y_max"], f_val=dom["f"],
                   delta=config["delta"],
                   weighted_norm=config["weighted_norm"])


def entry(traffic: dict):
    """The entry the mix's ``call`` names, ``module:function`` of the
    program."""
    module, _, name = traffic["call"].partition(":")
    if module.split(".")[0] != PROGRAM:
        raise ValueError(f"a mix calls {PROGRAM} only, not {module!r}")
    return getattr(importlib.import_module(module), name)


def answer(out) -> tuple[np.ndarray, int]:
    """(w on the host, k) from a ``(w64, iterations)`` pair or a result
    with ``w`` and ``iterations``."""
    w, k = (out.w, out.iterations) if hasattr(out, "w") else out
    if hasattr(w, "cpu"):
        w = w.cpu().numpy()
    return np.asarray(w), int(k)
