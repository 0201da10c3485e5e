"""Tendon wrap geometry over a batch: sphere and cylinder geodesic wraps.

Counterpart of mujoco_ros_pkgs_tpu/ops/wrap.py (libmujoco's mju_wrap
semantics as the JAX package pins them). Every function is branchless and
batch-first: the inputs carry any leading shape (..., envs, wraps), each
solution branch is computed and selected with `torch.where`, and a wrap
that does not bend collapses both tangent points onto the straight
segment's midpoint, so that its Jacobian term vanishes (the midpoint rides
the chord). `wrap_geom` takes every wrap of every tendon of every env in one
call; the sphere and the cylinder wraps share one 2D circle solve.

- No sidesite: the cable wraps iff the straight segment meets the circle;
  of the two tangent-pair solutions the shorter path wins.
- Sidesite outside the geom: the candidate whose tangent-point midpoint lies
  nearest the sidesite is taken; it bends when the segment meets the circle,
  or else when its rotation sense matches the side of the chord the centre
  lies on.
- Sidesite inside the geom: the cable passes through the disk; it stays
  straight where the segment already meets the circle and otherwise bends
  at the circle point of least total length (the Fermat point, found by
  `_FERMAT_ITERS` bisection steps on the arc between the endpoint
  directions, as many as the JAX package takes).
"""

from __future__ import annotations

import math

import torch

from mujoco_ros_pkgs_tpu_torch.ops import math as mmath

_EPS = 1e-9
_FERMAT_ITERS = 26


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def _circle(r: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    return r[..., None] * torch.stack([torch.cos(phi), torch.sin(phi)], -1)


def _seg_intersects(p0, p1, r):
    """Whether the segment p0-p1 (..., 2) comes within r of the origin."""
    chord = p1 - p0
    tproj = torch.clamp(-_dot(p0, chord) / torch.clamp(_dot(chord, chord), min=_EPS),
                        0.0, 1.0)
    return _norm(p0 + tproj[..., None] * chord) < r


def _fermat_point(p0, p1, r):
    """The circle point minimising |p0 - c| + |c - p1| on the shorter arc
    between the endpoint directions (bisection on the path length's
    derivative)."""
    a0 = torch.atan2(p0[..., 1], p0[..., 0])
    a1 = torch.atan2(p1[..., 1], p1[..., 0])
    da = torch.remainder(a1 - a0 + math.pi, 2.0 * math.pi) - math.pi

    def dlen(t):
        phi = a0 + t * da
        c = _circle(r, phi)
        cp = (r * da)[..., None] * torch.stack([-torch.sin(phi), torch.cos(phi)], -1)
        g0 = _dot(c - p0, cp) / torch.clamp(_norm(c - p0), min=_EPS)
        g1 = _dot(c - p1, cp) / torch.clamp(_norm(c - p1), min=_EPS)
        return g0 + g1

    lo = torch.zeros_like(a0)
    hi = torch.ones_like(a0)
    for _ in range(_FERMAT_ITERS):
        mid = 0.5 * (lo + hi)
        neg = dlen(mid) < 0
        lo = torch.where(neg, mid, lo)
        hi = torch.where(neg, hi, mid)
    return _circle(r, a0 + 0.5 * (lo + hi) * da)


def wrap_circle(p0, p1, r, side, has_side, side_inside):
    """2D wrap around a circle of radius r (...) at the origin. p0, p1,
    side: (..., 2); has_side, side_inside: bool (...). Returns tangent
    points t0, t1 (..., 2), the arc length and whether the cable bends;
    where it does not, t0 = t1 = the chord's midpoint and the arc is 0."""
    d0 = torch.sqrt(torch.clamp(_dot(p0, p0), min=_EPS))
    d1 = torch.sqrt(torch.clamp(_dot(p1, p1), min=_EPS))
    a0 = torch.atan2(p0[..., 1], p0[..., 0])
    a1 = torch.atan2(p1[..., 1], p1[..., 0])
    b0 = torch.arccos(torch.clamp(r / d0, -1.0, 1.0))
    b1 = torch.arccos(torch.clamp(r / d1, -1.0, 1.0))

    def candidate(s):
        ph0 = a0 - s * b0
        ph1 = a1 + s * b1
        t0, t1 = _circle(r, ph0), _circle(r, ph1)
        dphi = torch.remainder(s * (ph0 - ph1), 2.0 * math.pi)
        total = _norm(p0 - t0) + r * dphi + _norm(p1 - t1)
        return t0, t1, r * dphi, total, 0.5 * (t0 + t1)

    t0p, t1p, arcp, totp, midp = candidate(1.0)     # clockwise
    t0m, t1m, arcm, totm, midm = candidate(-1.0)    # counterclockwise

    intersects = _seg_intersects(p0, p1, r)
    # the centre on the + side of the chord: only the clockwise pair touches
    chord = p1 - p0
    cross_center = chord[..., 0] * (-p0[..., 1]) - chord[..., 1] * (-p0[..., 0])
    cw_ok = intersects | (cross_center > 0)
    ccw_ok = intersects | (cross_center <= 0)

    closer_cw = _norm(midp - side) <= _norm(midm - side)
    pick_cw = torch.where(has_side, closer_cw, totp <= totm)
    pick2 = pick_cw[..., None]
    t0 = torch.where(pick2, t0p, t0m)
    t1 = torch.where(pick2, t1p, t1m)
    arc = torch.where(pick_cw, arcp, arcm)
    act_out = torch.where(has_side, torch.where(pick_cw, cw_ok, ccw_ok), intersects)

    # a sidesite inside: one bend point, straight where the chord meets the disk
    use_in = has_side & side_inside
    c = _fermat_point(p0, p1, r)
    t0 = torch.where(use_in[..., None], c, t0)
    t1 = torch.where(use_in[..., None], c, t1)
    arc = torch.where(use_in, 0.0, arc)
    active = torch.where(use_in, ~intersects, act_out) & (d0 > r) & (d1 > r)

    mid = 0.5 * (p0 + p1)
    act2 = active[..., None]
    return (torch.where(act2, t0, mid), torch.where(act2, t1, mid),
            torch.where(active, arc, 0.0), active)


def _any_perp(v):
    """A unit vector perpendicular to the unit vectors v (..., 3)."""
    x = torch.zeros_like(v)
    x[..., 0] = 1.0
    y = torch.zeros_like(v)
    y[..., 1] = 1.0
    w = mmath.cross(v, torch.where(v[..., :1].abs() < 0.9, x, y))
    return w / torch.clamp(_norm(w), min=_EPS)[..., None]


def wrap_geom(pos0, pos1, gpos, gmat, r, is_sphere, side_pos, has_side):
    """World-frame wraps around sphere and cylinder geoms.

    pos0, pos1, gpos, side_pos: (..., 3) world endpoints, geom centres and
    sidesites; gmat (..., 3, 3) the geoms' frames; r the radii and
    is_sphere, has_side bool, each broadcastable to the leading shape.
    A sphere's geodesic lies in the plane of the centre and the endpoints
    (the sidesite's plane when they are colinear with the centre); a
    cylinder's (axis z) is a helix over the 2D wrap of the xy projection.
    Returns the world tangent points t0, t1 (..., 3), the arc lengths and
    whether each wrap bends."""
    lead = torch.broadcast_shapes(pos0.shape[:-1], r.shape)
    r = r.expand(lead)
    is_sphere = is_sphere.expand(lead)
    has_side = has_side.expand(lead)

    def local(p):
        return torch.einsum("...ji,...j->...i", gmat, p - gpos)
    p0, p1, sd = local(pos0), local(pos1), local(side_pos)

    # the sphere's plane: e1 along p0, e2 towards p1 (or the sidesite)
    e1 = p0 / torch.clamp(_norm(p0), min=_EPS)[..., None]
    p1perp = p1 - _dot(p1, e1)[..., None] * e1
    nrm = _norm(p1perp)
    ok_ends = nrm > _EPS
    sperp = sd - _dot(sd, e1)[..., None] * e1
    snrm = _norm(sperp)
    side_plane = has_side & (snrm > _EPS)
    e2 = torch.where(ok_ends[..., None], p1perp / torch.clamp(nrm, min=_EPS)[..., None],
                     torch.where(side_plane[..., None],
                                 sperp / torch.clamp(snrm, min=_EPS)[..., None],
                                 _any_perp(e1)))
    ok_plane = ok_ends | side_plane

    def plane(p):
        return torch.stack([_dot(p, e1), _dot(p, e2)], -1)
    sph = is_sphere[..., None]
    q0 = torch.where(sph, plane(p0), p0[..., :2])
    q1 = torch.where(sph, plane(p1), p1[..., :2])
    qs = torch.where(sph, plane(sd), sd[..., :2])
    inside = torch.where(is_sphere, _norm(sd), _norm(sd[..., :2])) < r
    t0q, t1q, arc2d, active = wrap_circle(q0, q1, r, qs, has_side, inside)

    # sphere: back to 3D in the plane
    act_s = active & ok_plane
    t0s = t0q[..., :1] * e1 + t0q[..., 1:] * e2
    t1s = t1q[..., :1] * e1 + t1q[..., 1:] * e2
    # cylinder: z interpolated along the 2D path
    l0 = _norm(p0[..., :2] - t0q)
    l1 = _norm(p1[..., :2] - t1q)
    L2d = torch.clamp(l0 + arc2d + l1, min=_EPS)
    dz = p1[..., 2] - p0[..., 2]
    z0 = p0[..., 2] + dz * l0 / L2d
    z1 = p0[..., 2] + dz * (l0 + arc2d) / L2d
    t0c = torch.cat([t0q, z0[..., None]], -1)
    t1c = torch.cat([t1q, z1[..., None]], -1)
    arc3d = torch.sqrt(arc2d * arc2d + (z1 - z0) ** 2)

    act = torch.where(is_sphere, act_s, active)
    mid = 0.5 * (p0 + p1)
    a3 = act[..., None]
    t0 = torch.where(a3, torch.where(sph, t0s, t0c), mid)
    t1 = torch.where(a3, torch.where(sph, t1s, t1c), mid)
    arc = torch.where(act, torch.where(is_sphere, arc2d, arc3d), 0.0)

    def world(t):
        return gpos + torch.einsum("...ij,...j->...i", gmat, t)
    return world(t0), world(t1), arc, act
