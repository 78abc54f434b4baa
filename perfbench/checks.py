"""The numbers that decide `correct`: each is a gap between what the
program produced and the float64 reference, read as a share of the
reference's own scale, and held to the cell's limit in `limits/<cell>.json`
(`PERF.md` gives the readings each limit was set from)."""

from __future__ import annotations

import torch

# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone, and is left out of the
# change
QUIET_LEAF = 1e-3


def loss_gap(program: list, reference: list) -> float:
    """The worst step's |loss - reference loss| / |reference loss|."""
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def _median(values) -> float:
    v = sorted(values)
    return 0.5 * (v[(len(v) - 1) // 2] + v[len(v) // 2])


def leaf_gap(program: dict, reference: dict, keep=None,
             median=False) -> float:
    """By the worst leaf (or the median one): the gap between the
    program's norm of the leaf and the reference's, against the larger of
    the reference's norm of that leaf and of the median leaf (``keep``:
    the leaves that count)."""
    p, r = _norms(program), _norms(reference)
    names = [k for k in r if keep is None or k in keep]
    floor = _median(r[k] for k in names)
    gaps = [abs(p[k] - r[k]) / max(r[k], floor) for k in names]
    return _median(gaps) if median else max(gaps)


def moving_leaves(first_grad: dict) -> set:
    """Leaves whose reference gradient is at least QUIET_LEAF of the
    median leaf's."""
    n = _norms(first_grad)
    floor = QUIET_LEAF * _median(n.values())
    return {k for k, v in n.items() if v >= floor}


def row_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The worst element's |program - reference| / (|reference| + the
    reference's root mean square): relative where values are large,
    against the batch's scale where they are near 0."""
    ref = reference.double()
    scale = ref.square().mean().sqrt()
    return float(((program.double() - ref).abs() / (ref.abs() + scale)).max())


def verdict(readings: dict, limits: dict) -> list:
    """[(name, reading, limit)] in the limits' order; a reading with no
    number (NaN, or a control that crashed) fails."""
    return [(k, readings.get(k, float("nan")), limits[k]) for k in limits]


def passed(rows) -> bool:
    return all(v == v and v <= lim for _, v, lim in rows)
