"""Generic convex narrowphase: fixed-iteration MPR over a batch of pairs.

Counterpart of mujoco_ros_pkgs_tpu/ops/gjk.py. MuJoCo 2.3.7 collides every
convex pair without an analytic routine (an ellipsoid or a cylinder against
most geoms, mesh hulls) by libccd's Minkowski Portal Refinement. The JAX
package writes it per pair as straight-line code, fixed trip counts and
`jnp.where` in place of early exits, and vmaps it; here it runs on whole
batches: every tensor leads with the env axis and the pair axis (B, P),
Python loops of fixed count run over them and `torch.where` takes every
branch, so that nothing reads a device value back to the host.

The pairs of one call may differ in their geom types (`types1`, `types2`:
one static type per pair column): each support call evaluates the support
of every type present and selects per column. So collide() runs all its
MPR pairs, of every type pair and mesh, in one call per step. Mesh hulls
come as their vertices per column (V, padded by repeating the first
vertex, which leaves the argmax's point unchanged).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core.types import GeomType
from mujoco_ros_pkgs_tpu_torch.ops.math import MINVAL, cross, norm_safe, normalize, static_tensor

# iteration budgets of the JAX package's MPR (libccd: 100 with a tolerance exit)
_DISCOVER_ITERS = 12
_REFINE_ITERS = 30


def _dot(a, b):
    return (a * b).sum(-1)


def _w(c, a, b):
    """torch.where with a condition of one dim less than the vectors."""
    return torch.where(c[..., None], a, b)


# products as multiplies and sums, not matmuls: a BLAS kernel fuses them into
# FMAs, which round otherwise, and MPR's discrete portal updates turn that
# into another portal
def _tmv(mat, v):
    """mat^T @ v over leading dims."""
    return (mat * v[..., :, None]).sum(-2)


def _mv(mat, v):
    return (mat * v[..., None, :]).sum(-1)


def _argmin3_onehot(x):
    """One-hot (..., 3) of the first minimum of x (..., 3), as jnp.argmin."""
    a0, a1, a2 = x.unbind(-1)
    is0 = (a0 <= a1) & (a0 <= a2)
    is1 = (~is0) & (a1 <= a2)
    is2 = (~is0) & (~is1)
    return torch.stack([is0, is1, is2], -1).to(x.dtype)


def make_frame(n):
    """mju_makeFrame rows (n, t1, t2) (..., 3, 3): the helper axis is the
    coordinate axis of the smallest |n| (the first on ties)."""
    n = normalize(n)
    t1 = normalize(cross(n, _argmin3_onehot(n.abs())))
    return torch.stack([n, t1, cross(n, t1)], -2)


def _any_orthogonal(v):
    return cross(v, _argmin3_onehot(v.abs()))


def support(t: GeomType, size, pos, mat, verts=None):
    """World support point s(d) = argmax_{x in geom} <x, d> of one geom type
    over (..., 3) directions (d need not be unit): size, pos (..., 3), mat
    (..., 3, 3), verts (..., V, 3) local hull vertices of a mesh."""
    t = GeomType(t)
    if t == GeomType.SPHERE:
        return lambda d: pos + size[..., :1] * normalize(d)
    if t == GeomType.CAPSULE:
        def sup(d):
            dl = _tmv(mat, d)
            return (pos + (size[..., 1] * torch.sign(dl[..., 2]))[..., None] * mat[..., 2]
                    + size[..., :1] * normalize(d))
        return sup
    if t == GeomType.ELLIPSOID:
        def sup(d):
            sd = size * _tmv(mat, d)
            denom = torch.clamp(norm_safe(sd), min=MINVAL)[..., None]
            return pos + _mv(mat, size * sd / denom)
        return sup
    if t == GeomType.CYLINDER:
        def sup(d):
            dl = _tmv(mat, d)
            rxy = torch.sqrt(torch.clamp(dl[..., 0] ** 2 + dl[..., 1] ** 2, min=MINVAL ** 2))
            local = torch.stack([size[..., 0] * dl[..., 0] / rxy,
                                 size[..., 0] * dl[..., 1] / rxy,
                                 torch.sign(dl[..., 2]) * size[..., 1]], -1)
            return pos + _mv(mat, local)
        return sup
    if t == GeomType.BOX:
        def sup(d):
            dl = _tmv(mat, d)
            return pos + _mv(mat, torch.where(dl >= 0, size, -size))
        return sup
    if t == GeomType.MESH:
        if verts is None:
            raise ValueError("a mesh's support needs its hull vertices")

        def sup(d):
            idx = torch.argmax((verts * _tmv(mat, d)[..., None, :]).sum(-1), -1)
            v = torch.take_along_dim(verts, idx[..., None, None], -2)[..., 0, :]
            return pos + _mv(mat, v)
        return sup
    raise NotImplementedError(f"no support function for {t.name}")


def mixed_support(types, size, pos, mat, verts=None):
    """The support of pair columns of differing types: `types` holds one
    static GeomType per column of the last leading axis; each type present
    is evaluated over every column and the column's own kept."""
    types = tuple(GeomType(t) for t in types)
    kinds = sorted(set(types))
    sups = [support(t, size, pos, mat, verts if t == GeomType.MESH else None)
            for t in kinds]
    if len(kinds) == 1:
        return sups[0]
    masks = [static_tensor(np.array([tt == t for tt in types])[:, None], pos.device)
             for t in kinds]

    def sup(d):
        out = sups[0](d)
        for s, mask in zip(sups[1:], masks[1:]):
            out = torch.where(mask, s(d), out)
        return out
    return sup


def mpr(sup1, sup2, c1, c2):
    """MPR between two batches of convex shapes with interior points c1, c2
    (..., 3). Returns (dist, pos, normal): dist < 0 the penetration depth
    negated, dist > 0 a lower bound of the separation; pos the contact
    midpoint; the normal from geom 1 into geom 2."""
    dtype, dev = c1.dtype, c1.device

    def S(d):
        a, b = sup1(-d), sup2(d)
        return b - a, a, b

    def const(*vals):
        return static_tensor(np.array(vals), dev, dtype)
    eps = 1e-12

    v0 = c2 - c1
    v0 = _w(norm_safe(v0) < 1e-9, const(1e-5, 0.0, 0.0).expand_as(v0), v0)
    # the interior point nudged off any symmetry axis: an origin ray through a
    # portal vertex (an axis-aligned resting contact) stalls the refinement
    v0 = (v0 * (1.0 + const(1.1e-6, -2.3e-6, 3.1e-6))
          + const(2.9e-7, 1.3e-7, -1.9e-7) * norm_safe(v0)[..., None])

    # portal discovery seeds
    n1 = -v0
    v1, a1, b1 = S(n1)
    sep1 = _dot(v1, normalize(n1))
    miss = sep1 < 0.0
    gap = -sep1

    n2 = cross(v1, v0)
    n2 = _w(norm_safe(n2) < 1e-10, _any_orthogonal(v1 - v0), n2)
    v2, a2, b2 = S(n2)
    sep2 = _dot(v2, normalize(n2))
    miss = miss | (sep2 < 0.0)
    gap = torch.maximum(gap, -sep2)

    n3 = cross(v1 - v0, v2 - v0)
    flip = _dot(n3, v0) > 0.0
    # swap v1 and v2 so that the portal's normal points away from v0
    v1, v2 = _w(flip, v2, v1), _w(flip, v1, v2)
    a1, a2 = _w(flip, a2, a1), _w(flip, a1, a2)
    b1, b2 = _w(flip, b2, b1), _w(flip, b1, b2)
    n3 = _w(flip, -n3, n3)
    n3 = _w(norm_safe(n3) < eps, n1, n3)
    v3, a3, b3 = S(n3)
    sep3 = _dot(v3, normalize(n3))
    miss = miss | (sep3 < 0.0)
    gap = torch.maximum(gap, -sep3)

    # discovery: turn the candidate portal until the origin ray pierces it
    done = torch.zeros_like(miss)
    for _ in range(_DISCOVER_ITERS):
        out13 = _dot(cross(v1, v3), v0) < 0.0     # the ray outside plane v0-v1-v3
        out32 = _dot(cross(v3, v2), v0) < 0.0     # the ray outside plane v0-v3-v2
        need = (~done) & (out13 | out32)
        # replace v2 (out13), else v1 (out32)
        r2, r1 = need & out13, need & ~out13
        v2, a2, b2 = _w(r2, v3, v2), _w(r2, a3, a2), _w(r2, b3, b2)
        v1, a1, b1 = _w(r1, v3, v1), _w(r1, a3, a1), _w(r1, b3, b1)
        n = cross(v1 - v0, v2 - v0)
        n = _w(norm_safe(n) < eps, v1 - v0, n)
        nv3, na3, nb3 = S(n)
        sep = _dot(nv3, normalize(n))
        miss = miss | (need & (sep < 0.0))
        gap = torch.where(need, torch.maximum(gap, -sep), gap)
        v3, a3, b3 = _w(need, nv3, v3), _w(need, na3, a3), _w(need, nb3, b3)
        done = done | ~need

    # refinement: push the portal out to the Minkowski difference's surface
    conv = torch.zeros_like(miss)
    for _ in range(_REFINE_ITERS):
        n = cross(v2 - v1, v3 - v1)
        nn = norm_safe(n)
        n = _w(nn < eps, v1, n / torch.clamp(nn, min=eps)[..., None])
        n = _w(_dot(n, v1 - v0) < 0.0, -n, n)       # outward, away from v0
        v4, a4, b4 = S(n)
        conv = conv | (_dot(v4 - v1, n) < 1e-7)
        # which sub-portal holds the origin ray: replace that vertex
        c41 = _dot(cross(v4, v1), v0) < 0.0
        c42 = _dot(cross(v4, v2), v0) < 0.0
        c43 = _dot(cross(v4, v3), v0) < 0.0
        do = ~conv
        rep1 = do & ((c41 & c42) | (~c41 & ~c43))
        rep3 = do & c41 & ~c42
        rep2 = do & ~c41 & c43
        v1, a1, b1 = _w(rep1, v4, v1), _w(rep1, a4, a1), _w(rep1, b4, b1)
        v3, a3, b3 = _w(rep3, v4, v3), _w(rep3, a4, a3), _w(rep3, b4, b3)
        v2, a2, b2 = _w(rep2, v4, v2), _w(rep2, a4, a2), _w(rep2, b4, b2)

    # the contact
    n = cross(v2 - v1, v3 - v1)
    nn = norm_safe(n)
    n = _w(nn < eps, normalize(-v0), n / torch.clamp(nn, min=eps)[..., None])
    n = _w(_dot(n, v1 - v0) < 0.0, -n, n)
    depth = _dot(v1, n)            # the origin's distance to the portal's plane
    hit = (~miss) & (depth >= 0.0)
    lam = _barycentric(depth[..., None] * n, v1, v2, v3, n)
    pa = lam[..., 0:1] * a1 + lam[..., 1:2] * a2 + lam[..., 2:3] * a3
    pb = lam[..., 0:1] * b1 + lam[..., 1:2] * b2 + lam[..., 2:3] * b3
    # separated: the converged portal's plane lies |depth| past the origin;
    # that and every supporting plane seen on the way bound the gap below
    sep_est = torch.maximum(gap, -depth)
    dist = torch.where(hit, -depth, torch.clamp(sep_est, min=1e-10))
    pos = _w(hit, 0.5 * (pa + pb), 0.5 * (a1 + b1))
    # the portal's normal points from geom 2 toward geom 1: flip it
    return dist, pos, -n


def _barycentric(p, v1, v2, v3, n):
    """Barycentric coordinates (..., 3) of p, projected along n, in the
    triangle v1 v2 v3, clipped to [0, 1] and renormalised."""
    d1, d2, d3 = v1 - p, v2 - p, v3 - p
    w = torch.stack([_dot(cross(d2, d3), n), _dot(cross(d3, d1), n),
                     _dot(cross(d1, d2), n)], -1)
    tot = w[..., 0] + w[..., 1] + w[..., 2]
    ok = tot.abs() > 1e-12
    lam = _w(ok, w / torch.where(ok, tot, 1.0)[..., None], torch.full_like(w, 1.0 / 3.0))
    lam = torch.clamp(lam, 0.0, 1.0)
    return lam / torch.clamp(lam[..., 0] + lam[..., 1] + lam[..., 2], min=1e-12)[..., None]


def convex_pair(types1, types2, size1, pos1, mat1, size2, pos2, mat2,
                verts1=None, verts2=None):
    """MPR contacts of a batch of convex pairs: (dist (B, P, 4), pos (B, P,
    4, 3), frame (B, P, 4, 3, 3)). MPR gives the normal and the deepest
    point; a sweep of supports tilted 0.02 rad off the normal at three
    angles samples the contact patch (a flat face on a face gives its
    corners, a point contact collapses onto the first point and is
    dropped: distance 1e10), as the JAX package does; every sample of a
    separated pair is dropped. types1 / types2: a static GeomType per pair
    column; size, pos (B or 1, P, 3); mat (B, P, 3, 3); verts (1, P, V, 3)
    local hull vertices of mesh columns (any other column's are unused)."""
    sup1 = mixed_support(types1, size1, pos1, mat1, verts1)
    sup2 = mixed_support(types2, size2, pos2, mat2, verts2)
    dist0, pos0, n = mpr(sup1, sup2, pos1, pos2)
    frame = make_frame(n)
    t1, t2 = frame[..., 1, :], frame[..., 2, :]
    dists, poss = [dist0], [pos0]
    for k in range(3):
        phi = 2.0 * math.pi * k / 3.0
        dir_k = n + 0.02 * (math.cos(phi) * t1 + math.sin(phi) * t2)
        s1 = sup1(dir_k)              # geom 1's extreme toward geom 2
        s2 = sup2(-dir_k)             # geom 2's extreme toward geom 1
        dk = _dot(s2 - s1, n)         # their separation along the normal
        pk = 0.5 * (s1 + s2)
        dup = torch.zeros_like(dist0, dtype=torch.bool)
        for prev in poss:
            dup = dup | (norm_safe(pk - prev) < 1e-4)
        dists.append(torch.where(dup | (dist0 > 0), 1e10, dk))
        poss.append(pk)
    return (torch.stack(dists, -1), torch.stack(poss, -2),
            frame.unsqueeze(-3).expand(frame.shape[:-2] + (4, 3, 3)))


def plane_convex(n, p0, pos, mat, verts):
    """A plane (unit normal n, a point p0; (B, P, 3)) against a mesh hull
    (pos (B, P, 3), mat (B, P, 3, 3), verts (V, 3), this hull's alone and
    unpadded): its 4 most penetrating vertices, a lower index first on ties
    (lax.top_k's order), each with its distance to the plane."""
    world = pos[..., None, :] + _mv(mat[..., None, :, :], verts)     # (B, P, V, 3)
    dists = (world * n[..., None, :]).sum(-1) - _dot(n, p0)[..., None]
    dsel, idx = torch.sort(dists, dim=-1, stable=True)
    dsel, idx = dsel[..., :4], idx[..., :4]
    sel = torch.take_along_dim(world, idx[..., None], -2)
    frame = make_frame(n)
    return (dsel, sel - 0.5 * dsel[..., None] * n[..., None, :],
            frame.unsqueeze(-3).expand(frame.shape[:-2] + (4, 3, 3)))
