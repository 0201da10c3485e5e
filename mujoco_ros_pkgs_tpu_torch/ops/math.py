"""Quaternion and 6D spatial algebra in MuJoCo conventions, on batched tensors.

Counterpart of mujoco_ros_pkgs_tpu/ops/math.py. Every function broadcasts
over leading dims: a quaternion is (..., 4) as (w, x, y, z), a vector is
(..., 3), a spatial vector is (..., 6) with the rotation first.
"""

from __future__ import annotations

import numpy as np
import torch

# mjMINVAL
MINVAL = 1e-15

_STATIC: dict = {}


def static_tensor(a, device, dtype=None) -> torch.Tensor:
    """`a` (a model's index or mask data: numpy array, tuple or list) as a
    tensor on `device`, made once per content, dtype and device and then
    reused, so that a step makes no host-to-device copy of it (on CUDA each
    such copy is a pageable copy that waits for the stream). The result is
    shared: never write to it."""
    a = np.asarray(a)
    key = (a.tobytes(), a.dtype.str, a.shape, str(device), dtype)
    t = _STATIC.get(key)
    if t is None:
        t = _STATIC[key] = torch.tensor(a, dtype=dtype, device=device)
    return t


def norm_safe(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp((x * x).sum(-1), min=MINVAL * MINVAL))


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / norm_safe(x)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product u*v (mju_mulQuat)."""
    u0, u1, u2, u3 = u.unbind(-1)
    v0, v1, v2, v3 = v.unbind(-1)
    return torch.stack([
        u0 * v0 - u1 * v1 - u2 * v2 - u3 * v3,
        u0 * v1 + u1 * v0 + u2 * v3 - u3 * v2,
        u0 * v2 - u1 * v3 + u2 * v0 + u3 * v1,
        u0 * v3 + u1 * v2 - u2 * v1 + u3 * v0,
    ], -1)


def rot_vec_quat(vec: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate vec by quaternion q (mju_rotVecQuat): world = R(q) @ local."""
    u = q[..., 1:4]
    w = q[..., 0:1]
    c = cross(u, vec)
    return vec + 2.0 * (w * c + cross(u, c))


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions; mju_negQuat)."""
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Velocity-space difference: the 3D rotation taking qb to qa
    (mju_subQuat)."""
    qdif = quat_mul(quat_conj(qb), qa)
    qdif = torch.where(qdif[..., :1] < 0, -qdif, qdif)
    sin_half = norm_safe(qdif[..., 1:])
    angle = 2.0 * torch.atan2(sin_half, qdif[..., 0])
    return qdif[..., 1:] / sin_half[..., None] * angle[..., None]


def quat_to_vel(q: torch.Tensor) -> torch.Tensor:
    """Quaternion to its 3D angular displacement, axis times angle
    (mju_quat2Vel with dt = 1)."""
    q = torch.where(q[..., :1] < 0, -q, q)
    sin_half = norm_safe(q[..., 1:])
    angle = 2.0 * torch.atan2(sin_half, q[..., 0])
    return q[..., 1:] / sin_half[..., None] * angle[..., None]


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion to 3x3 rotation matrix (mju_quat2Mat)."""
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, -2)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(unit axis (..., 3), angle (...)) -> quaternion (mju_axisAngle2Quat)."""
    s = torch.sin(angle * 0.5)
    return torch.cat([torch.cos(angle * 0.5)[..., None], axis * s[..., None]], -1)


def mat_to_quat(mat: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix (..., 3, 3) to quaternion (mju_mat2Quat): Shepperd's
    method on the largest of the trace and the diagonal (the first on a tie),
    normalized, w >= 0."""
    m00, m11, m22 = mat[..., 0, 0], mat[..., 1, 1], mat[..., 2, 2]
    tr = m00 + m11 + m22

    def s_of(x):
        return torch.sqrt(torch.clamp(x, min=MINVAL)) * 2.0
    sw, sx = s_of(tr + 1.0), s_of(1.0 + m00 - m11 - m22)
    sy, sz = s_of(1.0 + m11 - m00 - m22), s_of(1.0 + m22 - m00 - m11)
    d21, d02, d10 = (mat[..., 2, 1] - mat[..., 1, 2], mat[..., 0, 2] - mat[..., 2, 0],
                     mat[..., 1, 0] - mat[..., 0, 1])
    s01, s02, s12 = (mat[..., 0, 1] + mat[..., 1, 0], mat[..., 0, 2] + mat[..., 2, 0],
                     mat[..., 1, 2] + mat[..., 2, 1])
    cand = torch.stack([
        torch.stack([0.25 * sw, d21 / sw, d02 / sw, d10 / sw], -1),
        torch.stack([d21 / sx, 0.25 * sx, s01 / sx, s02 / sx], -1),
        torch.stack([d02 / sy, s01 / sy, 0.25 * sy, s12 / sy], -1),
        torch.stack([d10 / sz, s02 / sz, s12 / sz, 0.25 * sz], -1)], -2)
    pick = torch.argmax(torch.stack([tr, m00, m11, m22], -1), -1)
    q = normalize(torch.take_along_dim(cand, pick[..., None, None], -2)[..., 0, :])
    return torch.where(q[..., :1] < 0, -q, q)


def euler_to_quat(euler: torch.Tensor) -> torch.Tensor:
    """Euler angles (..., 3), radians, about the fixed x, y and z axes in
    turn (MuJoCo's eulerseq "XYZ", extrinsic) to a quaternion qz qy qx."""
    lead, dev, dtype = euler.shape[:-1], euler.device, euler.dtype
    q = static_tensor(np.eye(4)[0], dev, dtype).expand(lead + (4,))
    for i in range(3):
        axis = static_tensor(np.eye(3)[i], dev, dtype)
        q = quat_mul(axis_angle_to_quat(axis.expand(lead + (3,)), euler[..., i]), q)
    return q


def quat_integrate(q: torch.Tensor, vel: torch.Tensor, dt) -> torch.Tensor:
    """Integrate a quaternion by body-local angular velocity
    (mju_quatIntegrate): q' = q * exp(dt/2 * vel)."""
    angle = norm_safe(vel) * dt
    axis = normalize(vel)
    return quat_mul(q, axis_angle_to_quat(axis, angle))


def motion_cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Motion-vector cross product u x_m v (mju_crossMotion)."""
    return torch.cat([cross(u[..., :3], v[..., :3]),
                      cross(u[..., :3], v[..., 3:]) + cross(u[..., 3:], v[..., :3])],
                     -1)


def force_cross(u: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Force-vector cross product u x_f f, u a motion (mju_crossForce)."""
    return torch.cat([cross(u[..., :3], f[..., :3]) + cross(u[..., 3:], f[..., 3:]),
                      cross(u[..., :3], f[..., 3:])], -1)


def transform_force(vec: torch.Tensor, newpos: torch.Tensor,
                    oldpos: torch.Tensor) -> torch.Tensor:
    """Move a force vector's reference point (mju_transformSpatial, no
    rotation)."""
    return torch.cat([vec[..., :3] - cross(newpos - oldpos, vec[..., 3:]),
                      vec[..., 3:]], -1)


def inert_vec_mul(inert: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Spatial inertia (..., 10) times motion vector (..., 6) (mju_mulInertVec);
    inert = [Ixx Iyy Izz Ixy Ixz Iyz, hx hy hz, m]."""
    Ixx, Iyy, Izz, Ixy, Ixz, Iyz = inert[..., :6].unbind(-1)
    h = inert[..., 6:9]
    m = inert[..., 9:10]
    w, l = v[..., :3], v[..., 3:]
    w0, w1, w2 = w.unbind(-1)
    Iw = torch.stack([Ixx * w0 + Ixy * w1 + Ixz * w2,
                      Ixy * w0 + Iyy * w1 + Iyz * w2,
                      Ixz * w0 + Iyz * w1 + Izz * w2], -1)
    return torch.cat([Iw + cross(h, l), m * l - cross(h, w)], -1)


def inert_from_mass_com_fullinertia(mass, inertia_at_com, com):
    """10-vector spatial inertia about a reference point from mass (...),
    a 3x3 inertia about the com (..., 3, 3) and the com offset from the
    reference point (..., 3). Parallel axis: I + m (c.c 1 - c c^T)."""
    eye = torch.eye(3, dtype=com.dtype, device=com.device)
    cc = com[..., :, None] * com[..., None, :]
    shift = mass[..., None, None] * ((com * com).sum(-1)[..., None, None] * eye - cc)
    full = inertia_at_com + shift
    return torch.cat([
        torch.stack([full[..., 0, 0], full[..., 1, 1], full[..., 2, 2],
                     full[..., 0, 1], full[..., 0, 2], full[..., 1, 2]], -1),
        mass[..., None] * com,
        mass[..., None],
    ], -1)
