"""peer_copy_us_per_iter (us; layer: mesh): µs in which a copy between
cards (``Memcpy PtoP``: the halo slices of ``parallel.halo``, the sums'
and scalars' moves to and from the lead card) ran on a card, the union of
them per card, clipped to the traced slice; the mean over the cards, as
``device_us_per_iter`` takes it, over the iterations its solves returned.
Nothing where no such copy ran in the slice: one card, or no mesh."""

from __future__ import annotations

from cellbench.capture import on_card

PEER = "Memcpy PtoP"


def _union_us(spans) -> float:
    total, at = 0.0, -float("inf")
    for s, t in sorted(spans):
        if t > at:
            total += t - max(s, at)
            at = t
    return total


def read(cap):
    if not cap.cards or cap.iterations <= 0:
        return None
    per_card = [[(max(e.start_us, cap.start_us), min(e.end_us, cap.end_us))
                 for e in on_card(cap, c)
                 if e.kind == "memcpy" and e.name.startswith(PEER)]
                for c in cap.cards]
    if not any(per_card):
        return None
    return (sum(_union_us(s) for s in per_card) / len(cap.cards)
            / cap.iterations)
