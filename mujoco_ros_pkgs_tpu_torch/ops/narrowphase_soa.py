"""Structure-of-arrays narrowphase primitives on per-env component tensors.

Counterpart of mujoco_ros_pkgs_tpu/ops/narrowphase_soa.py. A vec3 is a tuple
of three (B,) tensors, a mat3 a 3x3 nested tuple (M[i][j] row i column j).
The primitives mirror the JAX package op for op, with the same guards, tie
breaking and contact order, and are the plain versions of the device
functions in csrc/narrowphase.cuh. The plane primitives are the ones the
fused step kernel has (SOA_FNS, which ops/step_tpu.supports() gates on);
the sphere-capsule and capsule-capsule primitives run on the general path
only (GENERAL_FNS, ops/narrowphase.collide), as plain torch, as they are
plain jnp in the JAX package.
"""

from __future__ import annotations

import torch

from mujoco_ros_pkgs_tpu_torch.ops.math import MINVAL


def v_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def v_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def v_scale(a, s):
    return tuple(x * s for x in a)


def v_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v_cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def v_norm_safe(a):
    return torch.sqrt(torch.clamp(v_dot(a, a), min=MINVAL * MINVAL))


def v_normalize(a):
    return v_scale(a, 1.0 / v_norm_safe(a))


def v_where(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def m_col(M, j):
    return (M[0][j], M[1][j], M[2][j])


def m_matvec(M, v):
    """world = R @ local."""
    return tuple(M[i][0] * v[0] + M[i][1] * v[1] + M[i][2] * v[2]
                 for i in range(3))


def _argmin3_flags(a0, a1, a2):
    """First-occurrence argmin over three tensors as exclusive flags."""
    is0 = (a0 <= a1) & (a0 <= a2)
    is1 = (~is0) & (a1 <= a2)
    is2 = (~is0) & (~is1)
    return is0, is1, is2


def make_frame(n):
    """mju_makeFrame (rows n, t1, t2): helper axis = the coordinate axis with
    the smallest |n| (first on ties)."""
    n = v_normalize(n)
    flags = _argmin3_flags(torch.abs(n[0]), torch.abs(n[1]), torch.abs(n[2]))
    a = tuple(f.to(n[0].dtype) for f in flags)
    t1 = v_normalize(v_cross(n, a))
    t2 = v_cross(n, t1)
    return (n, t1, t2)


# ---------------------------------------------------------------------------
# primitives: (P1, M1, S1, P2, M2, S2) -> (dists [cap], poss [cap] vec3,
# frames [cap] mat3 rows); geom 1 is the plane, normal from geom 1 into 2
# ---------------------------------------------------------------------------


def _plane_sphere(P1, M1, S1, P2, M2, S2):
    n, p0 = m_col(M1, 2), P1
    c, r = P2, S2[0]
    cdist = v_dot(n, v_sub(c, p0))
    dist = cdist - r
    pos = v_sub(c, v_scale(n, r + 0.5 * dist))
    return [dist], [pos], [make_frame(n)]


def _plane_capsule(P1, M1, S1, P2, M2, S2):
    n, p0 = m_col(M1, 2), P1
    c, axis = P2, m_col(M2, 2)
    r, hl = S2[0], S2[1]
    frame = make_frame(n)
    dists, poss = [], []
    for sgn in (1.0, -1.0):
        e = v_add(c, v_scale(axis, sgn * hl))
        dist = v_dot(n, v_sub(e, p0)) - r
        dists.append(dist)
        poss.append(v_sub(e, v_scale(n, r + 0.5 * dist)))
    return dists, poss, [frame, frame]


def _plane_box(P1, M1, S1, P2, M2, S2):
    n, p0 = m_col(M1, 2), P1
    c, R, size = P2, M2, S2
    frame = make_frame(n)
    np0 = v_dot(n, p0)
    corners, cdists = [], []
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            for sz in (-1.0, 1.0):
                local = (size[0] * sx, size[1] * sy, size[2] * sz)
                corner = v_add(c, m_matvec(R, local))
                corners.append(corner)
                cdists.append(v_dot(corner, n) - np0)
    # the 4 most penetrating corners, lower index first on ties (the order
    # of lax.top_k in the JAX package): a strict < scan keeps the first min
    big = torch.full_like(cdists[0], float("inf"))
    taken = [torch.zeros_like(cdists[0], dtype=torch.bool) for _ in range(8)]
    dists, poss = [], []
    for _ in range(4):
        bestd = torch.where(taken[0], big, cdists[0])
        bestpos = corners[0]
        bestidx = torch.zeros_like(cdists[0], dtype=torch.int64)
        for i in range(1, 8):
            di = torch.where(taken[i], big, cdists[i])
            upd = di < bestd
            bestd = torch.where(upd, di, bestd)
            bestpos = v_where(upd, corners[i], bestpos)
            bestidx = torch.where(upd, i, bestidx)
        taken = [t | (bestidx == i) for i, t in enumerate(taken)]
        dists.append(bestd)
        poss.append(v_sub(bestpos, v_scale(n, 0.5 * bestd)))
    return dists, poss, [frame] * 4


def _seg_seg_closest(p1, d1, h1, p2, d2, h2):
    """Closest points between the segments p1 +- h1 d1 and p2 +- h2 d2."""
    r = v_sub(p1, p2)
    a = v_dot(d1, d1)
    e = v_dot(d2, d2)
    b = v_dot(d1, d2)
    c = v_dot(d1, r)
    f = v_dot(d2, r)
    denom = a * e - b * b
    ok = torch.abs(denom) > 1e-12
    s = torch.where(ok, (b * f - c * e) / torch.where(ok, denom, 1.0), 0.0)
    s = torch.clamp(s, -h1, h1)
    t = (b * s + f) / torch.clamp(e, min=MINVAL)
    t = torch.clamp(t, -h2, h2)
    s2 = torch.clamp((b * t - c) / torch.clamp(a, min=MINVAL), -h1, h1)
    return v_add(p1, v_scale(d1, s2)), v_add(p2, v_scale(d2, t))


def _sphere_capsule(P1, M1, S1, P2, M2, S2):
    c1, r1 = P1, S1[0]
    c2, axis = P2, m_col(M2, 2)
    r2, hl = S2[0], S2[1]
    t = torch.clamp(v_dot(v_sub(c1, c2), axis), -hl, hl)
    p = v_add(c2, v_scale(axis, t))
    dvec = v_sub(p, c1)
    n = v_normalize(dvec)
    dist = v_norm_safe(dvec) - r1 - r2
    pos = v_add(c1, v_scale(n, r1 + 0.5 * dist))
    return [dist], [pos], [make_frame(n)]


def _capsule_capsule(P1, M1, S1, P2, M2, S2):
    c1, a1 = P1, m_col(M1, 2)
    r1, h1 = S1[0], S1[1]
    c2, a2 = P2, m_col(M2, 2)
    r2, h2 = S2[0], S2[1]
    p1, p2 = _seg_seg_closest(c1, a1, h1, c2, a2, h2)
    dvec = v_sub(p2, p1)
    n = v_normalize(dvec)
    dist = v_norm_safe(dvec) - r1 - r2
    pos = v_add(p1, v_scale(n, r1 + 0.5 * dist))
    return [dist], [pos], [make_frame(n)]


# keyed by the JAX package's routine names (ops/narrowphase._DISPATCH); the
# index is the primitive id the fused CUDA kernel dispatches on
SOA_FNS = {
    "_plane_sphere": _plane_sphere,
    "_plane_capsule": _plane_capsule,
    "_plane_box": _plane_box,
}
PRIM_ID = {name: i for i, name in enumerate(SOA_FNS)}

# every primitive the port has, for the general path's collide
GENERAL_FNS = dict(SOA_FNS, _sphere_capsule=_sphere_capsule,
                   _capsule_capsule=_capsule_capsule)
