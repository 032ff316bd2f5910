"""Constant-velocity Kalman filters for track motion, batched over slots.

Counterpart of ``strongsort_yolo_tpu/track/kalman.py``: XYAH
(ByteTrack/DeepSORT/StrongSORT) and XYWH (BoT-SORT) 8-state filters with
the standard DeepSORT noise weights, StrongSORT's NSA measurement noise
(R scaled by 1 - detection confidence), closed-form F P F^T, a
closed-form 4x4 Cholesky in place of a batched linear solve, and the
squared Mahalanobis gating distance. The small products are
written as broadcast multiply-and-sum rather than matmuls, so no
setting of TF32 on the card can reach the covariance.
"""

from __future__ import annotations

import torch

STD_POS = 1.0 / 20
STD_VEL = 1.0 / 160

XYAH = "xyah"
XYWH = "xywh"


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _size_proxy(mean4: torch.Tensor, form: str):
    """Per-component noise scale bases (w-like, h-like)."""
    if form == XYWH:
        return mean4[..., 2], mean4[..., 3]
    return mean4[..., 3], mean4[..., 3]


def _pos_std(mean4: torch.Tensor, form: str, w_pos: float) -> torch.Tensor:
    w, h = _size_proxy(mean4, form)
    if form == XYWH:
        return torch.stack([w_pos * w, w_pos * h, w_pos * w, w_pos * h], -1)
    const = torch.full_like(w, 1e-2)
    return torch.stack([w_pos * h, w_pos * h, const, w_pos * h], -1)


def _vel_std(mean4: torch.Tensor, form: str, w_vel: float) -> torch.Tensor:
    w, h = _size_proxy(mean4, form)
    if form == XYWH:
        return torch.stack([w_vel * w, w_vel * h, w_vel * w, w_vel * h], -1)
    const = torch.full_like(w, 1e-5)
    return torch.stack([w_vel * h, w_vel * h, const, w_vel * h], -1)


def initiate(measurement: torch.Tensor, form: str = XYWH):
    """New-track state from measurements (..., 4) -> mean (..., 8), cov
    (..., 8, 8)."""
    mean = torch.cat([measurement, torch.zeros_like(measurement)], dim=-1)
    std_pos = 2.0 * _pos_std(measurement, form, STD_POS)
    std_vel = 10.0 * _vel_std(measurement, form, STD_VEL)
    std = torch.cat([std_pos, std_vel], dim=-1)
    cov = (std[..., :, None] ** 2) * _eye(8, measurement)
    return mean, cov


def predict(
    mean: torch.Tensor,
    cov: torch.Tensor,
    form: str = XYWH,
    *,
    still_mask: torch.Tensor | None = None,
):
    """KF time update. ``still_mask`` (...,) zeroes the size velocities
    of tracks that are not currently tracked (ByteTrack multi_predict)."""
    if still_mask is not None:
        damp = torch.where(still_mask[..., None], 0.0, 1.0)
        mean = torch.cat([mean[..., :6], mean[..., 6:8] * damp], dim=-1)
    std_pos = _pos_std(mean[..., :4], form, STD_POS)
    std_vel = _vel_std(mean[..., :4], form, STD_VEL)
    q_diag = torch.cat([std_pos, std_vel], dim=-1) ** 2
    new_mean = torch.cat([mean[..., :4] + mean[..., 4:], mean[..., 4:]], dim=-1)
    p11, p12 = cov[..., :4, :4], cov[..., :4, 4:]
    p21, p22 = cov[..., 4:, :4], cov[..., 4:, 4:]
    top = torch.cat([p11 + p12 + p21 + p22, p12 + p22], dim=-1)
    bot = torch.cat([p21 + p22, p22], dim=-1)
    new_cov = torch.cat([top, bot], dim=-2) + q_diag[..., :, None] * _eye(8, cov)
    return new_mean, new_cov


def project(
    mean: torch.Tensor, cov: torch.Tensor, form: str = XYWH, *,
    conf: torch.Tensor | None = None,
):
    """State -> measurement space: (mean4, S (..., 4, 4)). ``conf`` (...,)
    detection confidence scales R by clip(1 - conf, 0, 1) (NSA)."""
    std = _pos_std(mean[..., :4], form, STD_POS)
    if form == XYAH:
        # DeepSORT uses a larger aspect noise in project than initiate
        std = torch.cat(
            [std[..., :2], torch.full_like(std[..., 2:3], 1e-1), std[..., 3:]],
            dim=-1,
        )
    # floor keeps S invertible for empty slots (w = h = 0)
    r_diag = torch.clamp(std**2, min=1e-9)
    if conf is not None:
        r_diag = torch.clamp(
            r_diag * torch.clamp(1.0 - conf[..., None], 0.0, 1.0), min=1e-9
        )
    return mean[..., :4], cov[..., :4, :4] + r_diag[..., :, None] * _eye(4, cov)


def _chol4_lanes(s: torch.Tensor):
    """Closed-form Cholesky of batched SPD 4x4 matrices: the 10 lower
    entries as separate (...,) tensors."""

    def rsq(x):  # guarded sqrt: empty slots carry ~0 diagonals
        return torch.sqrt(torch.clamp(x, min=1e-12))

    l00 = rsq(s[..., 0, 0])
    l10 = s[..., 1, 0] / l00
    l20 = s[..., 2, 0] / l00
    l30 = s[..., 3, 0] / l00
    l11 = rsq(s[..., 1, 1] - l10 * l10)
    l21 = (s[..., 2, 1] - l20 * l10) / l11
    l31 = (s[..., 3, 1] - l30 * l10) / l11
    l22 = rsq(s[..., 2, 2] - l20 * l20 - l21 * l21)
    l32 = (s[..., 3, 2] - l30 * l20 - l31 * l21) / l22
    l33 = rsq(s[..., 3, 3] - l30 * l30 - l31 * l31 - l32 * l32)
    return (l00, l10, l20, l30, l11, l21, l31, l22, l32, l33)


def _forward_sub4(lanes, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b for batched b (..., 4, N), L from _chol4_lanes."""
    l00, l10, l20, l30, l11, l21, l31, l22, l32, l33 = (
        lane[..., None] for lane in lanes
    )
    y0 = b[..., 0, :] / l00
    y1 = (b[..., 1, :] - l10 * y0) / l11
    y2 = (b[..., 2, :] - l20 * y0 - l21 * y1) / l22
    y3 = (b[..., 3, :] - l30 * y0 - l31 * y1 - l32 * y2) / l33
    return torch.stack([y0, y1, y2, y3], dim=-2)


def _chol_solve4(lanes, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b for batched b (..., 4, N)."""
    l00, l10, l20, l30, l11, l21, l31, l22, l32, l33 = (
        lane[..., None] for lane in lanes
    )
    y0, y1, y2, y3 = _forward_sub4(lanes, b).unbind(-2)
    x3 = y3 / l33
    x2 = (y2 - l32 * x3) / l22
    x1 = (y1 - l21 * x2 - l31 * x3) / l11
    x0 = (y0 - l10 * x1 - l20 * x2 - l30 * x3) / l00
    return torch.stack([x0, x1, x2, x3], dim=-2)


def update(
    mean: torch.Tensor, cov: torch.Tensor, measurement: torch.Tensor,
    form: str = XYWH, *, conf: torch.Tensor | None = None,
):
    """KF measurement update, batched over leading dims; ``conf`` as in
    :func:`project`."""
    proj_mean, s = project(mean, cov, form, conf=conf)
    # gain^T = S^-1 (P H^T)^T, (..., 4, 8)
    gain_t = _chol_solve4(_chol4_lanes(s), cov[..., :, :4].transpose(-1, -2))
    innovation = measurement - proj_mean
    new_mean = mean + (innovation[..., :, None] * gain_t).sum(-2)
    s_gain = (s[..., :, :, None] * gain_t[..., None, :, :]).sum(-2)  # S K^T
    new_cov = cov - (gain_t[..., :, :, None] * s_gain[..., :, None, :]).sum(-3)
    return new_mean, new_cov


def gating_distance(
    mean: torch.Tensor, cov: torch.Tensor, measurements: torch.Tensor,
    form: str = XYWH,
) -> torch.Tensor:
    """Squared Mahalanobis distance of each measurement to each track:
    mean (S, K, 8), cov (S, K, 8, 8), measurements (S, N, 4) -> (S, K, N)."""
    proj_mean, s = project(mean, cov, form)
    d = measurements[:, None, :, :] - proj_mean[:, :, None, :]  # (S, K, N, 4)
    # z solves L z = d^T for all N measurements of each track at once
    z = _forward_sub4(_chol4_lanes(s), d.transpose(-1, -2))
    return (z**2).sum(-2)


CHI2_95_4DOF = 9.4877  # chi-square 95% quantile, 4 degrees of freedom
