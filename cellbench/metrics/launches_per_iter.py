"""launches_per_iter (launches; layer: loop): kernels run on the cards in
the traced slice over the iterations its solves returned. Copies and
fills are not launches. Read under the profiler, which makes each launch
dearer but does not change how many there are."""

from __future__ import annotations

from cellbench.capture import on_card


def read(cap):
    if cap.iterations <= 0:
        return None
    kernels = sum(1 for c in cap.cards for e in on_card(cap, c)
                  if e.kind == "kernel")
    if kernels == 0:
        return None
    return kernels / cap.iterations
