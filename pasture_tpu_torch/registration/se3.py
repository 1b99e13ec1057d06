"""SE(3)/SO(3) Lie group operations on torch tensors.

Port of pasture_tpu/registration/se3.py.  Rotations are 3x3 matrices,
twists 6-vectors ``[rho, phi]`` (translation first).  Every function works
on batches (leading dimensions), follows its input's dtype and device, and
is written with ``torch.where`` guards and a smooth norm
(``sqrt(x·x + tiny)``, atan2-based rotation log) so that forward-mode
Jacobians at the identity (``torch.func.jacfwd``, which the pose-graph
solver takes) stay finite.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["so3_exp", "so3_log", "se3_exp", "se3_log", "skew",
           "transform_points"]

_EPS = 1e-8
_TINY = 1e-24


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """Norm over the last axis with a finite derivative at 0."""
    return torch.sqrt(torch.sum(x * x, dim=-1) + _TINY)


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
    ], dim=-2)


def _one_where(cond: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` where ``cond``, else 1 — a safe denominator."""
    return torch.where(cond, x, torch.ones_like(x))


def _sin_over_x(t):
    big = torch.abs(t) > _EPS
    return torch.where(big, torch.sin(t) / _one_where(big, t),
                       1.0 - t * t / 6.0)


def _one_minus_cos_over_x2(t):
    t2 = t * t
    return torch.where(torch.abs(t) > _EPS,
                       (1.0 - torch.cos(t)) / _one_where(t2 > _EPS * _EPS, t2),
                       0.5 - t2 / 24.0)


def _x_minus_sin_over_x3(t):
    t2 = t * t
    t3 = t2 * t
    return torch.where(torch.abs(t) > _EPS,
                       (t - torch.sin(t)) / _one_where(
                           torch.abs(t3) > _EPS ** 3, t3),
                       1.0 / 6.0 - t2 / 120.0)


def _eye_like(k: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta = _safe_norm(phi)[..., None, None]
    k = skew(phi)
    k2 = k @ k
    return _eye_like(k) + _sin_over_x(theta) * k \
        + _one_minus_cos_over_x2(theta) * k2


def so3_log(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    Uses ``atan2(|w|/2, (tr-1)/2)`` rather than arccos, which has an
    infinite derivative at the identity."""
    w = torch.stack([rot[..., 2, 1] - rot[..., 1, 2],
                     rot[..., 0, 2] - rot[..., 2, 0],
                     rot[..., 1, 0] - rot[..., 0, 1]], dim=-1)
    sin_theta = 0.5 * _safe_norm(w)
    cos_theta = 0.5 * (rot.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0)
    theta = torch.atan2(sin_theta, cos_theta)
    # w = 2 sin(theta) * axis  ->  phi = theta * axis = w * theta/(2 sin)
    scale = torch.where(theta > _EPS,
                        theta / _one_where(sin_theta > _EPS * 0.5,
                                           2.0 * sin_theta),
                        0.5 + theta * theta / 12.0)
    return scale[..., None] * w


def se3_exp(xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twist (..., 6) [rho, phi] -> (R (..., 3, 3), t (..., 3))."""
    rho, phi = xi[..., :3], xi[..., 3:]
    rot = so3_exp(phi)
    theta = _safe_norm(phi)[..., None, None]
    k = skew(phi)
    k2 = k @ k
    v = _eye_like(k) + _one_minus_cos_over_x2(theta) * k \
        + _x_minus_sin_over_x3(theta) * k2
    return rot, (v @ rho[..., None])[..., 0]


def se3_log(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> twist (..., 6) [rho, phi]."""
    phi = so3_log(rot)
    theta = _safe_norm(phi)[..., None, None]
    k = skew(phi)
    k2 = k @ k
    t2 = theta * theta
    # V^{-1} = I - K/2 + (1/t^2 - (1+cos)/(2 t sin)) K^2
    sin_t = torch.sin(theta)
    two_t_sin = 2.0 * theta * sin_t
    cot_term = torch.where(
        (theta > _EPS) & (torch.abs(sin_t) > _EPS),
        1.0 / _one_where(t2 > _EPS * _EPS, t2)
        - (1.0 + torch.cos(theta)) / _one_where(
            torch.abs(two_t_sin) > _EPS * _EPS, two_t_sin),
        1.0 / 12.0 + t2 / 720.0)
    v_inv = _eye_like(k) - 0.5 * k + cot_term * k2
    rho = (v_inv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def transform_points(rot: torch.Tensor, t: torch.Tensor,
                     points: torch.Tensor) -> torch.Tensor:
    """Apply (R, t) to an (N, 3) column."""
    return points @ rot.mT + t[None, :]
