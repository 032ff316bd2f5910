"""K3: the auction kernel (``csrc/auction.cu``), its wrapper, and its
plain PyTorch version :func:`auction_plain`.

Replaces ``strongsort_yolo_tpu/ops/pallas/auction_kernel.py::pallas_auction``
and follows that kernel's semantics round for round (see the note in
``csrc/auction.cu``), batched over a leading problem axis. Any (R, C)
runs: the benefit block sits in shared memory where it fits a block and
in a global scratch otherwise (:func:`shared_form`), with the same
arithmetic, so both forms equal :func:`auction_plain` bit for bit.
"""

from __future__ import annotations

import torch

from strongsort_yolo_tpu_torch.ops.cuda import _build

EPS_REL = 3e-3  # first bid increment, relative to the normalised range


def max_rounds_for(r: int) -> int:
    """Round cap of the TPU kernel: 16 times R padded to 8."""
    return 16 * max(8, -(-r // 8) * 8)


def shared_form(r: int, c: int) -> bool:
    """Whether K3 keeps an (r, c) problem's benefit block in shared
    memory (else in a global scratch): the one rule, from the block's
    bytes against what a Hopper block can use."""
    return _build.lib().ssyt_auction_smem_bytes(r, c, 1) <= _build.MAX_SMEM


def auction_plain(
    cost: torch.Tensor,  # (P, R, C)
    thresh: torch.Tensor,  # (P,)
    row_valid: torch.Tensor,  # (P, R) bool
    col_valid: torch.Tensor,  # (P, C) bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """The auction in plain PyTorch, all P problems in lockstep. A solved
    problem has no bidding row left, so further rounds leave it as it
    is, which makes lockstep equal to each problem leaving on its own."""
    return auction_rounds(cost, thresh, row_valid, col_valid)[:2]


def auction_rounds(
    cost: torch.Tensor,
    thresh: torch.Tensor,
    row_valid: torch.Tensor,
    col_valid: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`auction_plain`'s (row_to_col, col_to_row) and the bidding
    rounds each problem took, (P,) int64: the round at which it had no
    bidding row left, or the cap."""
    p, r, c = cost.shape
    dev = cost.device
    f32 = torch.float32
    cost = torch.clamp(cost.to(f32), -1e6, 1e6)
    t = thresh.to(f32).reshape(p, 1, 1)
    valid = row_valid[:, :, None] & col_valid[:, None, :]
    cmin = torch.minimum(torch.where(valid, cost, t).amin((1, 2), keepdim=True), t)
    cmax = torch.maximum(torch.where(valid, cost, t).amax((1, 2), keepdim=True), t)
    crange = torch.clamp(cmax - cmin, min=1e-6)
    w = torch.where(valid, (t - cost) / crange, -4.0)

    cols = torch.arange(c, device=dev)
    rows = torch.arange(r, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=f32, device=dev)
    price = torch.zeros(p, c, dtype=f32, device=dev)
    owner = torch.full((p, c), -1, dtype=torch.long, device=dev)
    sent = torch.zeros(p, r, dtype=torch.bool, device=dev)
    eps = torch.tensor(EPS_REL, dtype=f32, device=dev)
    taken = torch.full((p,), max_rounds_for(r), dtype=torch.long, device=dev)
    for rounds in range(max_rounds_for(r)):
        owned = (owner[:, :, None] == rows[None, None, :]).any(1)  # (P, R)
        done = (sent | owned).all(1)
        taken = torch.where(done & (taken > rounds), rounds, taken)
        if bool(done.all()):
            break
        if rounds > 0 and rounds % 16 == 0:
            eps = eps * 8.0
        values = w - price[:, None, :]
        best_j = values.argmax(-1)  # first maximum
        best_v = torch.gather(values, 2, best_j[..., None])[..., 0]
        chosen = cols[None, None, :] == best_j[..., None]
        w_best = torch.gather(w, 2, best_j[..., None])[..., 0]
        second_v = torch.clamp(
            torch.where(chosen, neg_inf, values).amax(-1), min=0.0
        )
        bidding = ~sent & ~owned
        retire = bidding & (best_v < 0.0)
        sent = sent | retire
        place = bidding & ~retire
        bid = w_best - second_v + eps
        bids = place[..., None] & chosen  # (P, R, C)
        bid_mat = torch.where(bids, bid[..., None], neg_inf)
        has_bid = bids.any(1)  # (P, C)
        winner = bid_mat.argmax(1)  # lowest row among the highest bids
        win_bid = torch.gather(bid_mat, 1, winner[:, None, :])[:, 0]
        price = torch.where(has_bid, win_bid, price)
        owner = torch.where(has_bid, winner, owner)

    from strongsort_yolo_tpu_torch.ops.assignment import _filter_matches

    assign = torch.full((p, r + 1), -1, dtype=torch.long, device=dev)
    assign.scatter_(
        1, torch.where(owner >= 0, owner, r), cols[None].expand(p, c).contiguous()
    )
    return (*_filter_matches(assign[:, :r], cost, thresh, row_valid, col_valid),
            taken)


def auction(
    cost: torch.Tensor,
    thresh: torch.Tensor,
    row_valid: torch.Tensor,
    col_valid: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """P assignment problems with a cost limit: cost (P, R, C), thresh
    (P,), row_valid (P, R) bool, col_valid (P, C) bool -> (row_to_col
    (P, R), col_to_row (P, C)) int32, -1 unmatched. CPU tensors take
    :func:`auction_plain`; CUDA tensors launch K3, one block per problem."""
    if cost.device.type == "cpu":
        return auction_plain(cost, thresh, row_valid, col_valid)
    if cost.device.type != "cuda":
        raise ValueError(f"auction: unsupported device {cost.device}")
    p, r, c = cost.shape
    dev = cost.device
    if (cost.dtype != torch.float32 or thresh.shape != (p,)
            or thresh.dtype != torch.float32
            or row_valid.shape != (p, r) or row_valid.dtype != torch.bool
            or col_valid.shape != (p, c) or col_valid.dtype != torch.bool
            or any(x.device != dev for x in (thresh, row_valid, col_valid))):
        raise ValueError(
            "auction wants cost (P, R, C) f32, thresh (P,) f32, row_valid "
            "(P, R) bool and col_valid (P, C) bool on one device"
        )
    lib = _build.lib()
    if lib.ssyt_auction_smem_bytes(r, c, 0) > _build.MAX_SMEM:
        raise ValueError(f"auction: the row and column arrays of a {r} x {c} "
                         "problem exceed a block's shared memory")
    scratch = (None if shared_form(r, c)
               else torch.empty((p, r, c), dtype=torch.float32, device=dev))
    cost, thresh = cost.contiguous(), thresh.contiguous()
    row_valid, col_valid = row_valid.contiguous(), col_valid.contiguous()
    r2c = torch.empty((p, r), dtype=torch.int32, device=dev)
    c2r = torch.empty((p, c), dtype=torch.int32, device=dev)
    err = lib.ssyt_auction(
        cost.data_ptr(), thresh.data_ptr(), row_valid.data_ptr(),
        col_valid.data_ptr(), r2c.data_ptr(), c2r.data_ptr(),
        None if scratch is None else scratch.data_ptr(), p, r, c,
        EPS_REL, max_rounds_for(r),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    auction.launches += 1
    _build.check(err, "auction")
    return r2c, c2r


auction.launches = 0
