"""Height-field contacts: the bilinear surface's tangent plane.

Counterpart of mujoco_ros_pkgs_tpu/ops/hfield.py. Instead of MuJoCo's
prisms under the other geom (mjc_ConvexHField, a data-dependent loop), the
field's bilinear surface is sampled under the other geom's centre, its
tangent plane (height and gradient) built, and the analytic plane routine
of the other geom's type (ops/narrowphase_soa.py; ops/gjk.plane_convex for
a mesh) run against that plane. Fixed shapes, no data-dependent control
flow: exact on flat cells, first-order on slopes. A geom whose footprint
lies off the field's extent gets no contact (distance 1e10). Capacities
are those of the plane pairs (HFIELD_NCON).

Heights are stored normalised to [0, 1]; the world height is data * size[2]
above the field frame's base plane.
"""

from __future__ import annotations

import torch

from mujoco_ros_pkgs_tpu_torch.core.types import GeomType, Model
from mujoco_ros_pkgs_tpu_torch.ops import gjk
from mujoco_ros_pkgs_tpu_torch.ops import narrowphase_soa as soa

# contacts per pair by the other geom's type (the plane pairs' table)
HFIELD_NCON = {GeomType.SPHERE: 1, GeomType.CAPSULE: 2, GeomType.ELLIPSOID: 1,
               GeomType.CYLINDER: 4, GeomType.BOX: 4, GeomType.MESH: 4}

_PLANE_FNS = {GeomType.SPHERE: "_plane_sphere", GeomType.CAPSULE: "_plane_capsule",
              GeomType.ELLIPSOID: "_plane_ellipsoid", GeomType.CYLINDER: "_plane_cylinder",
              GeomType.BOX: "_plane_box"}


def sample_height(m: Model, hid: int, x: torch.Tensor, y: torch.Tensor):
    """Bilinear height and gradient (z, dz/dx, dz/dy) of height field hid at
    local coordinates (x, y) of any shape; points off the extent clamp to
    its border (the caller masks their contacts)."""
    size = m.hfield_size[hid].to(x.dtype)      # rx, ry, top_z, bottom_z
    nrow, ncol = m.hfield_nrow[hid], m.hfield_ncol[hid]
    data = m.hfield_data[hid, :nrow, :ncol].to(x.dtype) * size[2]
    # x in [-rx, rx] -> column in [0, ncol - 1]; y -> row in [0, nrow - 1]
    fx = torch.clamp((x / size[0] + 1.0) * 0.5 * (ncol - 1), 0.0, ncol - 1.000001)
    fy = torch.clamp((y / size[1] + 1.0) * 0.5 * (nrow - 1), 0.0, nrow - 1.000001)
    j0 = torch.floor(fx).long()
    i0 = torch.floor(fy).long()
    tx, ty = fx - j0, fy - i0
    z00, z01 = data[i0, j0], data[i0, j0 + 1]
    z10, z11 = data[i0 + 1, j0], data[i0 + 1, j0 + 1]
    z = (1 - ty) * ((1 - tx) * z00 + tx * z01) + ty * ((1 - tx) * z10 + tx * z11)
    dxc = 2.0 * size[0] / (ncol - 1)         # the cell's metric: x per column,
    dyc = 2.0 * size[1] / (nrow - 1)         # y per row
    dzdx = ((1 - ty) * (z01 - z00) + ty * (z11 - z10)) / dxc
    dzdy = ((1 - tx) * (z10 - z00) + tx * (z11 - z01)) / dyc
    return z, dzdx, dzdy


def tangent_plane(m: Model, hid: int, pos1, mat1, pos2, rbound2):
    """The tangent plane of height field hid (its geom at pos1, mat1: (B,
    P, 3), (B, P, 3, 3)) under the other geoms' centres pos2: (normal,
    point) in world coordinates and whether each footprint (the centre
    widened by rbound2) lies over the field's extent."""
    c = torch.einsum("...ji,...j->...i", mat1, pos2 - pos1)
    size = m.hfield_size[hid].to(pos1.dtype)
    inside = ((c[..., 0].abs() <= size[0] + rbound2)
              & (c[..., 1].abs() <= size[1] + rbound2))
    z, dzdx, dzdy = sample_height(m, hid, c[..., 0], c[..., 1])
    n_local = torch.stack([-dzdx, -dzdy, torch.ones_like(z)], -1)
    n_local = n_local / torch.linalg.vector_norm(n_local, dim=-1, keepdim=True)
    s_local = torch.stack([c[..., 0], c[..., 1], z], -1)
    return (torch.einsum("...ij,...j->...i", mat1, n_local),
            pos1 + torch.einsum("...ij,...j->...i", mat1, s_local), inside)


def hfield_pair(m: Model, hid: int, t2: GeomType, pos1, mat1, pos2, mat2, size2,
                rbound2, verts2=None):
    """Height field hid (geom 1) against geoms of type t2 (geom 2) over (B,
    P) pairs: (dist (B, P, cap), pos (B, P, cap, 3), frame (B, P, cap, 3,
    3)), cap = HFIELD_NCON[t2]; verts2 (V, 3) the hull of a mesh t2."""
    n, p, inside = tangent_plane(m, hid, pos1, mat1, pos2, rbound2)
    if t2 == GeomType.MESH:
        dist, pos, frame = gjk.plane_convex(n, p, pos2, mat2, verts2)
    else:
        # the plane routine reads its plane's normal from column 2 of the
        # frame and the point from the position
        zero = torch.zeros_like(n[..., 0])
        plane_mat = tuple((zero, zero, n[..., i]) for i in range(3))
        di, po, fr = soa.SOA_FNS[_PLANE_FNS[t2]](
            tuple(p.unbind(-1)), plane_mat, None,
            tuple(pos2.unbind(-1)), tuple(tuple(r.unbind(-1)) for r in mat2.unbind(-2)),
            tuple(size2.unbind(-1)))
        dist = torch.stack(di, -1)
        pos = torch.stack([torch.stack(q, -1) for q in po], -2)
        frame = torch.stack([torch.stack([torch.stack(r, -1) for r in f], -2) for f in fr], -3)
    return torch.where(inside[..., None], dist, 1e10), pos, frame
