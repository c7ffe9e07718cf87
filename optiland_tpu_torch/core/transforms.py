"""Coordinate transforms between the global frame and per-surface frames.

Port of `optiland_tpu/core/transforms.py`: localize = translate(-t) then
rotate by -rz, -ry, -rx; globalize = rotate rx, ry, rz then translate(+t).
"""

from __future__ import annotations

import torch

from optiland_tpu_torch.core.rays import Rays


def _rot_x(x, y, z, c, s):
    return x, y * c - z * s, y * s + z * c


def _rot_y(x, y, z, c, s):
    return x * c + z * s, y, -x * s + z * c


def _rot_z(x, y, z, c, s):
    return x * c - y * s, x * s + y * c, z


def localize(rays: Rays, tx, ty, tz, rx, ry, rz) -> Rays:
    """Transform rays from the global frame into the surface-local frame."""
    x, y, z = rays.x - tx, rays.y - ty, rays.z - tz
    L, M, N = rays.L, rays.M, rays.N
    for rot, ang in ((_rot_z, rz), (_rot_y, ry), (_rot_x, rx)):
        c, s = torch.cos(-ang), torch.sin(-ang)
        x, y, z = rot(x, y, z, c, s)
        L, M, N = rot(L, M, N, c, s)
    return rays.replace(x=x, y=y, z=z, L=L, M=M, N=N)


def globalize(rays: Rays, tx, ty, tz, rx, ry, rz) -> Rays:
    """Transform rays from the surface-local frame back to the global frame."""
    x, y, z = rays.x, rays.y, rays.z
    L, M, N = rays.L, rays.M, rays.N
    for rot, ang in ((_rot_x, rx), (_rot_y, ry), (_rot_z, rz)):
        c, s = torch.cos(ang), torch.sin(ang)
        x, y, z = rot(x, y, z, c, s)
        L, M, N = rot(L, M, N, c, s)
    return rays.replace(x=x + tx, y=y + ty, z=z + tz, L=L, M=M, N=N)


def translate_z(rays: Rays, tz) -> Rays:
    """Fast path for untilted, on-axis surfaces: a pure z shift."""
    return rays.replace(z=rays.z - tz)


def untranslate_z(rays: Rays, tz) -> Rays:
    return rays.replace(z=rays.z + tz)


def rotation_matrix(rx, ry, rz) -> torch.Tensor:
    """3x3 rotation matrix R = Rz @ Ry @ Rx (reference
    `coordinate_system.py:121-143`), in the dtype and on the device of the
    first angle that is a tensor (Python numbers: the precision policy's
    dtype, on the CPU)."""
    from optiland_tpu_torch import config

    ref = next((a for a in (rx, ry, rz) if torch.is_tensor(a)), None)
    dt = config.get_dtype() if ref is None else ref.dtype
    dev = None if ref is None else ref.device
    rx, ry, rz = torch.broadcast_tensors(
        *(torch.as_tensor(a, dtype=dt, device=dev) for a in (rx, ry, rz)))
    one, zero = torch.ones_like(rx), torch.zeros_like(rx)
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    Rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    Ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    Rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return Rz @ Ry @ Rx
