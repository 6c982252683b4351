"""The numbers ``correct`` is decided by: gaps between the program's readings and the
reference's, each a share of the reference's own scale."""

from __future__ import annotations

import statistics


def loss_gap(program: list[float], reference: list[float]) -> float:
    """The largest relative gap of the steps' losses."""
    if len(program) != len(reference):
        return float("inf")
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def worst_leaf_gap(program: list[float], reference: list[float],
                   counted: list[bool] | None = None) -> float:
    """The worst leaf's gap between the program's norm and the reference's, against the
    reference's norm of that leaf or of the median leaf, whichever is larger."""
    if len(program) != len(reference):
        return float("inf")
    idx = [i for i in range(len(reference)) if counted is None or counted[i]]
    med = statistics.median(reference[i] for i in idx)
    return max(abs(program[i] - reference[i]) / max(reference[i], med, 1e-30) for i in idx)


def median_leaf_difference(program: list, reference: list) -> float:
    """The median over leaves of the norm of the difference of two samples of a leaf,
    against the reference's sample's norm; leaves whose reference sample is all zero
    are left out."""
    import torch

    rel = [float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r))
           for p, r in zip(program, reference) if bool(r.any())]
    return statistics.median(rel) if rel else float("inf")


def moving_leaves(ref_grad_norms: list[float], floor: float = 1e-3) -> list[bool]:
    """Leaves whose reference gradient is at least ``floor`` of the median leaf's: the
    others move under Adam by round-off alone and are left out of the change."""
    med = statistics.median(ref_grad_norms)
    return [g >= floor * med for g in ref_grad_norms]


def leaf_gaps(program: list[float], reference: list[float], names: list[str],
              k: int = 5) -> list[tuple[str, float, float, float]]:
    """The ``k`` leaves of the largest gaps: (name, gap, program's norm, reference's)."""
    med = statistics.median(reference)
    rows = [(n, abs(p - r) / max(r, med, 1e-30), p, r)
            for n, p, r in zip(names, program, reference)]
    return sorted(rows, key=lambda row: -row[1])[:k]
