"""Linear assignment with a cost limit: the tracker's matching, as the
system defines it.

``lapjv`` with a cost limit t is the max-weight matching with weights
``t - cost`` in which any row may stay unmatched at weight 0. The system
solves it by a Bertsekas auction over the real columns plus one
dedicated zero-benefit sentinel per row: Jacobi rounds in which every
unassigned row bids for its best column, ``best - max(second best, 0) +
eps`` above its price (a row whose best value is negative settles on its
sentinel), each column goes to its highest bid (the lowest row among
equal bids), and eps starts at 3e-3 of the cost range and grows 8x every
16 rounds, for at most 16 x R (R padded to 8) rounds. The decision can
differ from the exact optimum only among alternatives within eps of each
other, so the reference runs the same auction rather than the exact
problem: a tracker step's ids depend on every match before them.
Written here from that definition for one problem, in float32, over the
rows and columns that take part."""

from __future__ import annotations

import numpy as np

EPS_REL = np.float32(3e-3)


def solve(cost: np.ndarray, thresh: float, rows_padded: int | None = None):
    """cost (R, C) over the taking-part rows and columns; pairs with cost
    > thresh stay unmatched. ``rows_padded`` is the problem's row count
    as the system sizes it (its slots), which bounds the rounds. ->
    {row: col} of the matches within the limit."""
    r, c = cost.shape
    if r == 0 or c == 0:
        return {}
    f32 = np.float32
    cost = np.clip(cost.astype(f32), f32(-1e6), f32(1e6))
    t = f32(thresh)
    lo, hi = min(cost.min(), t), max(cost.max(), t)
    benefit = (t - cost) / max(hi - lo, f32(1e-6))
    price = np.zeros(c, f32)
    owner = np.full(c, -1)
    settled = np.zeros(r, bool)
    eps = EPS_REL
    rounds = 16 * max(8, -(-(rows_padded or r) // 8) * 8)
    for k in range(rounds):
        holds = np.zeros(r, bool)
        holds[owner[owner >= 0]] = True
        free = ~settled & ~holds
        if not free.any():
            break
        if k and k % 16 == 0:
            eps = f32(eps * f32(8.0))
        bids = {}
        for i in np.flatnonzero(free):
            value = benefit[i] - price
            j = int(np.argmax(value))
            if value[j] < 0:
                settled[i] = True
                continue
            second = f32(max(np.max(np.delete(value, j)) if c > 1 else -np.inf, 0.0))
            bid = f32(benefit[i, j] - second + eps)
            if j not in bids or bid > bids[j][0]:  # rows in order: ties keep the lower
                bids[j] = (bid, i)
        for j, (bid, i) in bids.items():
            price[j] = bid
            owner[j] = i
    return {int(owner[j]): j for j in range(c)
            if owner[j] >= 0 and cost[owner[j], j] <= t + f32(1e-6)}
