"""closed: a closed loop of one caller. Solve after solve, each answer on
the host before the next is sent, until the window's length has passed;
the last solve runs to its end. A solve is due when it is sent. A failed
solve ends the window and counts as infinitely late. ``--trace 1``
profiles whole solves from the window's start for at least
:data:`cellbench.capture.MIN_SLICE_S` seconds."""

from __future__ import annotations

import math
import time

from cellbench import capture
from cellbench.traffic import Window


def warm(send, inputs) -> None:
    """One solve: the kernels, the program's canvases, the allocator."""
    send(inputs.input(0))


def run(send, inputs, seconds: float, sample, cards, trace: bool,
        setup_s: float) -> Window:
    from torch.profiler import record_function

    prof = capture.start(cards) if trace else None
    latencies, iterations, failed, error = [], [], 0, ""
    profiled, events = 0, ()
    t_start = now = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while now < deadline:
        inp = inputs.input(i)
        due = now
        try:
            if prof is not None:
                with record_function(capture.ANNOTATION):
                    w, k = send(inp)
            else:
                w, k = send(inp)
        except Exception as e:
            failed, error = 1, f"{type(e).__name__}: {e}"
            latencies.append(math.inf)
            now = time.perf_counter()
            break
        now = time.perf_counter()
        latencies.append(now - due)
        iterations.append(k)
        sample.offer(i, (inp, w, k))
        i += 1
        if prof is not None and now - t_start >= capture.MIN_SLICE_S:
            profiled, events, prof = i, capture.stop(prof, cards), None
    if prof is not None:
        profiled, events = i, capture.stop(prof, cards)
    return Window(setup_s, t_start, now, tuple(latencies), tuple(iterations),
                  failed, error, tuple(sample.kept), profiled, events)
