"""Structure-of-arrays narrowphase primitives on per-env component tensors.

Counterpart of mujoco_ros_pkgs_tpu/ops/narrowphase_soa.py. A vec3 is a tuple
of three (B,) tensors, a mat3 a 3x3 nested tuple (M[i][j] row i column j).
The primitives mirror the JAX package op for op, with the same guards, tie
breaking and contact order. SOA_FNS holds all twelve, in the JAX package's
order: the planes against spheres, capsules, ellipsoids, cylinders and
boxes, then sphere-sphere, sphere-capsule, sphere-cylinder, sphere-box,
capsule-capsule, capsule-box and box-box. The general path
(ops/narrowphase.collide) runs them as plain torch, as they are plain jnp
in the JAX package; the fused step (ops/step_tpu) runs them here on the CPU
and as their device versions in csrc/narrowphase.cuh on the card, where
PRIM_ID numbers them.
"""

from __future__ import annotations

import torch

from mujoco_ros_pkgs_tpu_torch.ops.math import MINVAL


def v_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def v_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def v_neg(a):
    return tuple(-x for x in a)


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


def m_row(M, i):
    return M[i]


def m_matvec(M, v):
    """world = R @ local."""
    return tuple(M[i][0] * v[0] + M[i][1] * v[1] + M[i][2] * v[2]
                 for i in range(3))


def m_tmatvec(M, v):
    """local = R^T @ world."""
    return tuple(M[0][j] * v[0] + M[1][j] * v[1] + M[2][j] * v[2]
                 for j in range(3))


def _sel3(flags, vals):
    """Select among 3 scalar tensors by exclusive flags (is0, is1, is2)."""
    is0, is1, _ = flags
    return torch.where(is0, vals[0], torch.where(is1, vals[1], vals[2]))


def _sel3v(flags, vecs):
    is0, is1, _ = flags
    return v_where(is0, vecs[0], v_where(is1, vecs[1], vecs[2]))


def _argmin3_flags(a0, a1, a2):
    """First-occurrence argmin over three tensors as exclusive flags."""
    is0 = (a0 <= a1) & (a0 <= a2)
    is1 = (~is0) & (a1 <= a2)
    is2 = (~is0) & (~is1)
    return is0, is1, is2


def _argmax3_flags(a0, a1, a2):
    """First-occurrence argmax over three tensors as exclusive flags."""
    is0 = (a0 >= a1) & (a0 >= a2)
    is1 = (~is0) & (a1 >= a2)
    is2 = (~is0) & (~is1)
    return is0, is1, is2


def _sign_or_one(x):
    """sign(x), with 1 where x is 0."""
    s = torch.sign(x)
    return torch.where(s == 0, torch.ones_like(s), s)


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
# frames [cap] mat3 rows); geom 1 has the lower type (a plane is always geom
# 1), and the normal points from geom 1 into geom 2
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


def _sphere_sphere(P1, M1, S1, P2, M2, S2):
    c1, r1 = P1, S1[0]
    c2, r2 = P2, S2[0]
    dvec = v_sub(c2, c1)
    n = v_normalize(dvec)
    dist = v_norm_safe(dvec) - r1 - r2
    pos = v_add(c1, v_scale(n, r1 + 0.5 * dist))
    return [dist], [pos], [make_frame(n)]


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


def _sphere_box_probe(c, r, bc, R, size):
    """Sphere against box: the closest point on (or, from inside, the
    nearest face of) the box; also the capsule-box probe."""
    local = m_tmatvec(R, v_sub(c, bc))
    clamped = tuple(torch.clamp(local[k], -size[k], size[k]) for k in range(3))
    absl = tuple(torch.abs(local[k]) for k in range(3))
    inside = (absl[0] < size[0]) & (absl[1] < size[1]) & (absl[2] < size[2])
    depth = tuple(size[k] - absl[k] for k in range(3))
    flags = _argmin3_flags(*depth)
    sgn = _sel3(flags, tuple(torch.sign(local[k]) for k in range(3)))
    surf = tuple(torch.where(flags[k], sgn * size[k], clamped[k]) for k in range(3))
    closest_local = v_where(inside, surf, clamped)
    closest = v_add(bc, m_matvec(R, closest_local))
    dvec = v_sub(closest, c)
    nrm = v_norm_safe(dvec)
    nn = v_normalize(dvec)
    n_out = v_where(inside, v_neg(nn), nn)
    dist = torch.where(inside, -(nrm + r), nrm - r)
    pos = v_sub(closest, v_scale(n_out, 0.5 * dist))
    return dist, pos, n_out


def _sphere_box(P1, M1, S1, P2, M2, S2):
    dist, pos, n_out = _sphere_box_probe(P1, S1[0], P2, M2, S2)
    return [dist], [pos], [make_frame(n_out)]


def _capsule_box(P1, M1, S1, P2, M2, S2):
    c, axis = P1, m_col(M1, 2)
    r, hl = S1[0], S1[1]
    dists, poss, frames = [], [], []
    for sgn in (1.0, -1.0):
        e = v_add(c, v_scale(axis, sgn * hl))
        dist, pos, n_out = _sphere_box_probe(e, r, P2, M2, S2)
        dists.append(dist)
        poss.append(pos)
        frames.append(make_frame(n_out))
    return dists, poss, frames


def _plane_ellipsoid(P1, M1, S1, P2, M2, S2):
    """The ellipsoid's support point along -n (its deepest point)."""
    n, p0 = m_col(M1, 2), P1
    c, R, s = P2, M2, S2
    nl = m_tmatvec(R, n)
    sn = (s[0] * nl[0], s[1] * nl[1], s[2] * nl[2])
    denom = v_norm_safe(sn)
    support_local = v_scale((s[0] * sn[0], s[1] * sn[1], s[2] * sn[2]),
                            -1.0 / denom)
    p = v_add(c, m_matvec(R, support_local))
    dist = v_dot(n, v_sub(p, p0))
    pos = v_sub(p, v_scale(n, 0.5 * dist))
    return [dist], [pos], [make_frame(n)]


def _plane_cylinder(P1, M1, S1, P2, M2, S2):
    """4 contacts: a tilted cylinder's two rim points on each cap (the
    lower cap's first); an upright one (axis within 1e-8 of n) the lower
    cap's rim points at 0, 120 and 240 degrees about its x axis, and the
    fourth slot inactive (dist 1e10)."""
    n, p0 = m_col(M1, 2), P1
    c, a = P2, m_col(M2, 2)
    r, hl = S2[0], S2[1]
    an = v_dot(a, n)
    perp = v_neg(v_sub(n, v_scale(a, an)))
    pnorm = v_norm_safe(perp)
    degenerate = pnorm < 1e-8
    rim = v_where(degenerate, m_col(M2, 0), v_scale(perp, 1.0 / pnorm))
    lower = torch.where(an > 0, -1.0, 1.0).to(an.dtype)
    frame = make_frame(n)

    def cap_pts(sgn_cap):
        center = v_add(c, v_scale(a, sgn_cap * hl))
        return [v_add(center, v_scale(rim, r)), v_sub(center, v_scale(rim, r))]

    tilt = cap_pts(lower) + cap_pts(-lower)
    t1 = m_col(M2, 0)
    t2 = m_col(M2, 1)
    center = v_add(c, v_scale(a, lower * hl))
    h32 = 0.8660254037844386
    tri = [v_add(center, v_scale(t1, r)),
           v_add(center, v_add(v_scale(t1, -0.5 * r), v_scale(t2, h32 * r))),
           v_add(center, v_add(v_scale(t1, -0.5 * r), v_scale(t2, -h32 * r))),
           center]
    np0 = v_dot(n, p0)
    dists, poss = [], []
    for k in range(4):
        pt = v_where(degenerate, tri[k], tilt[k])
        dist = v_dot(pt, n) - np0
        if k == 3:
            dist = torch.where(degenerate, torch.full_like(dist, 1e10), dist)
        dists.append(dist)
        poss.append(v_sub(pt, v_scale(n, 0.5 * dist)))
    return dists, poss, [frame] * 4


def _sphere_cylinder(P1, M1, S1, P2, M2, S2):
    """Sphere against cylinder: the closest point on the side or a cap, or
    from inside the nearer of the two surfaces."""
    cs, rs = P1, S1[0]
    cc, Rc = P2, M2
    r, hl = S2[0], S2[1]
    local = m_tmatvec(Rc, v_sub(cs, cc))
    rad = torch.sqrt(torch.clamp(local[0] ** 2 + local[1] ** 2, min=MINVAL * MINVAL))
    raddir = (local[0] / rad, local[1] / rad, torch.zeros_like(rad))
    clamped_z = torch.clamp(local[2], -hl, hl)
    clamped_r = torch.minimum(rad, r)
    absz = torch.abs(local[2])
    inside = (rad < r) & (absz < hl)
    side = (raddir[0] * r, raddir[1] * r, clamped_z)
    cap = (raddir[0] * clamped_r, raddir[1] * clamped_r, torch.sign(local[2]) * hl)
    use_side = rad > r
    closest_local = v_where(
        inside,
        v_where(r - rad < hl - absz, side, cap),
        v_where(use_side & (absz < hl), side,
                v_where(absz >= hl, cap, side)))
    closest = v_add(cc, m_matvec(Rc, closest_local))
    dvec = v_sub(closest, cs)
    nrm = v_norm_safe(dvec)
    nn = v_normalize(dvec)
    n_out = v_where(inside, v_neg(nn), nn)
    dist = torch.where(inside, -(nrm + rs), nrm - rs)
    pos = v_sub(closest, v_scale(n_out, 0.5 * dist))
    return [dist], [pos], [make_frame(n_out)]


def _box_box(P1, M1, S1, P2, M2, S2):
    """Box against box: separating-axis test over the 15 axes (3 face
    normals of each box, 9 edge crosses), 4 contacts from the reference
    face clamped against the incident face, or 1 from the closest edges
    when an edge axis separates more. Every update is a strict > in the
    JAX package's order, so ties keep the first axis."""
    p1, R1, s1 = P1, M1, S1
    p2, R2, s2 = P2, M2, S2
    t = v_sub(p2, p1)
    dt = t[0].dtype

    axes = [(m_col(R1, i), False) for i in range(3)]
    axes += [(m_col(R2, i), False) for i in range(3)]
    for i in range(3):
        for j in range(3):
            axes.append((v_cross(m_col(R1, i), m_col(R2, j)), True))

    neg_inf = torch.full_like(t[0], float("-inf"))
    zero3 = (torch.zeros_like(t[0]),) * 3
    best_face_sep, best_face_axis = neg_inf, zero3
    best_edge_sep, best_edge_axis = neg_inf, zero3

    for (ax, is_edge) in axes:
        ln = v_norm_safe(ax)
        ok = ln > 1e-9
        a = v_scale(ax, 1.0 / torch.clamp(ln, min=MINVAL))
        sgn = 1.0 - 2.0 * (v_dot(a, t) < 0).to(dt)
        a = v_scale(a, sgn)
        ra = sum(torch.abs(v_dot(a, m_col(R1, k))) * s1[k] for k in range(3))
        rb = sum(torch.abs(v_dot(a, m_col(R2, k))) * s2[k] for k in range(3))
        sep = torch.abs(v_dot(v_scale(ax, 1.0 / torch.clamp(ln, min=MINVAL)), t)) \
            - (ra + rb)
        sep = torch.where(ok, sep, neg_inf)
        if is_edge:
            upd = sep > best_edge_sep
            best_edge_sep = torch.where(upd, sep, best_edge_sep)
            best_edge_axis = v_where(upd, a, best_edge_axis)
        else:
            upd = sep > best_face_sep
            best_face_sep = torch.where(upd, sep, best_face_sep)
            best_face_axis = v_where(upd, a, best_face_axis)

    n = best_face_axis

    a1 = torch.maximum(torch.maximum(torch.abs(v_dot(n, m_col(R1, 0))),
                                     torch.abs(v_dot(n, m_col(R1, 1)))),
                       torch.abs(v_dot(n, m_col(R1, 2))))
    a2 = torch.maximum(torch.maximum(torch.abs(v_dot(n, m_col(R2, 0))),
                                     torch.abs(v_dot(n, m_col(R2, 1)))),
                       torch.abs(v_dot(n, m_col(R2, 2))))
    ref_is_1 = a1 >= a2

    def face_contacts(pr, Rr, sr, pi, Ri, si, nrm):
        dots = tuple(v_dot(nrm, m_col(Ri, k)) for k in range(3))
        iflags = _argmax3_flags(*(torch.abs(dk) for dk in dots))
        isgn = -torch.sign(_sel3(iflags, dots))
        nl = tuple(v_dot(nrm, m_col(Rr, k)) for k in range(3))
        rflags = _argmax3_flags(*(torch.abs(nk) for nk in nl))
        rsgn = torch.sign(_sel3(rflags, nl))
        sr_r = _sel3(rflags, sr)
        dists, poss = [], []
        for u in (-1.0, 1.0):
            for v in (-1.0, 1.0):
                # incident-face corner in incident-local coordinates, by axis
                cand0 = (isgn * si[0], u * si[1], v * si[2])
                cand1 = (v * si[0], isgn * si[1], u * si[2])
                cand2 = (u * si[0], v * si[1], isgn * si[2])
                local = _sel3v(iflags, (cand0, cand1, cand2))
                corner = v_add(pi, m_matvec(Ri, local))
                loc = m_tmatvec(Rr, v_sub(corner, pr))
                clamped = tuple(torch.clamp(loc[k], -sr[k], sr[k]) for k in range(3))
                loc_r = _sel3(rflags, loc)
                dist = rsgn * loc_r - sr_r
                fix = loc_r - 0.5 * dist * rsgn
                pos_loc = tuple(torch.where(rflags[k], fix, clamped[k])
                                for k in range(3))
                poss.append(v_add(pr, m_matvec(Rr, pos_loc)))
                dists.append(dist)
        return dists, poss

    d_f1, p_f1 = face_contacts(p1, R1, s1, p2, R2, s2, n)
    d_f2, p_f2 = face_contacts(p2, R2, s2, p1, R1, s1, v_neg(n))
    dist_face = [torch.where(ref_is_1, d_f1[k], d_f2[k]) for k in range(4)]
    pos_face = [v_where(ref_is_1, p_f1[k], p_f2[k]) for k in range(4)]

    ne = best_edge_axis

    def support_edge(p, R, s, direction):
        dk = tuple(v_dot(direction, m_col(R, k)) for k in range(3))
        sgns = tuple(_sign_or_one(d) for d in dk)
        corner = v_add(p, m_matvec(R, (sgns[0] * s[0], sgns[1] * s[1],
                                       sgns[2] * s[2])))
        eflags = _argmin3_flags(*(torch.abs(d) for d in dk))
        edir = _sel3v(eflags, (m_col(R, 0), m_col(R, 1), m_col(R, 2)))
        half = _sel3(eflags, s)
        sg = _sel3(eflags, sgns)
        center = v_sub(corner, v_scale(edir, sg * half))
        return center, edir, half

    c1, e1, h1 = support_edge(p1, R1, s1, ne)
    c2, e2, h2 = support_edge(p2, R2, s2, v_neg(ne))
    q1, q2 = _seg_seg_closest(c1, e1, h1, c2, e2, h2)
    dvec = v_sub(q2, q1)
    nn = v_normalize(dvec)
    edge_n = v_where(v_dot(dvec, ne) < 0, v_neg(nn), nn)
    edge_n = v_where(v_norm_safe(dvec) > 1e-9, edge_n, ne)
    dist_edge = best_edge_sep
    pos_edge = v_scale(v_add(q1, q2), 0.5)

    use_edge = best_edge_sep > best_face_sep + 1e-9
    big = torch.full_like(t[0], 1e10)
    zero = torch.zeros_like(t[0])
    dists = [torch.where(use_edge, dist_edge, dist_face[0])]
    poss = [v_where(use_edge, pos_edge, pos_face[0])]
    for k in range(1, 4):
        dists.append(torch.where(use_edge, big, dist_face[k]))
        poss.append(v_where(use_edge, (zero, zero, zero), pos_face[k]))
    nrm = v_where(use_edge, edge_n, n)
    frame = make_frame(nrm)
    return dists, poss, [frame] * 4


# keyed by the JAX package's routine names (ops/narrowphase._DISPATCH), in
# its order; the index is the primitive id the fused CUDA kernel dispatches
# on (csrc/step_fused.cuh, enum Prim)
SOA_FNS = {
    "_plane_sphere": _plane_sphere,
    "_plane_capsule": _plane_capsule,
    "_plane_ellipsoid": _plane_ellipsoid,
    "_plane_cylinder": _plane_cylinder,
    "_plane_box": _plane_box,
    "_sphere_sphere": _sphere_sphere,
    "_sphere_capsule": _sphere_capsule,
    "_sphere_cylinder": _sphere_cylinder,
    "_sphere_box": _sphere_box,
    "_capsule_capsule": _capsule_capsule,
    "_capsule_box": _capsule_box,
    "_box_box": _box_box,
}
PRIM_ID = {name: i for i, name in enumerate(SOA_FNS)}
