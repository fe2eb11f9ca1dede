"""Entanglement-map generation (reference: main.py:21-45)."""

from __future__ import annotations


def entanglement_graph(nq: int, nn: int) -> list[tuple[int, int]]:
    """Linear-with-distance entanglement map.

    For each distance ``d`` in ``1..nn``, emits the pairs ``(i, i+d)`` in two
    sub-layers: first a greedy non-overlapping layer (skipping ``i`` already
    used as a right endpoint), then the remainder.

    Reproduces main.py:21-45, with one deliberate determinism fix: the
    reference iterates a Python ``set`` of small ints for the second
    sub-layer (main.py:41), whose order follows hash-table slots and can
    deviate from ascending once values collide mod the table size; we use
    ``sorted`` instead. The resulting STATE and kernel are identical either
    way (all XXPhase terms commute and eps=1e-16), but per-gate chi/memory
    traces may order differently from the reference's for some (nq, nn).
    """
    emap: list[tuple[int, int]] = []
    for d in range(1, nn + 1):
        busy: set[int] = set()
        for i in range(nq):
            if i not in busy and i + d < nq:
                emap.append((i, i + d))
                busy.add(i + d)
        for i in sorted(busy):
            if i + d < nq:
                emap.append((i, i + d))
    return emap
