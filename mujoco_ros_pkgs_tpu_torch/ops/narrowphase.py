"""Narrowphase: dispatch table, pair groups, contact slots and `collide`.

Counterpart of mujoco_ros_pkgs_tpu/ops/narrowphase.py. The slot layout
(which contact of which geom pair lands in which slot) must be identical to
the JAX package's, because contact rows are compared with it row by row.
The dispatch table names every routine the JAX package has, so the pair
table and capacities agree for any model; the routines the port implements
live in ops/narrowphase_soa.py (GENERAL_FNS), and `collide` raises for a
pair group whose routine is not there.

Per-pair parameter mixing mirrors mj_contactParam (priority, solmix,
solref/solimp blending, elementwise-max friction).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core.types import Contact, Data, GeomType, Model
from mujoco_ros_pkgs_tpu_torch.ops import narrowphase_soa as soa
from mujoco_ros_pkgs_tpu_torch.ops.math import MINVAL, static_tensor


class Routine(NamedTuple):
    name: str          # the JAX package's function name (SOA_FNS key)
    cap: int           # contacts per pair


_DISPATCH = {
    (GeomType.PLANE, GeomType.SPHERE): Routine("_plane_sphere", 1),
    (GeomType.PLANE, GeomType.CAPSULE): Routine("_plane_capsule", 2),
    (GeomType.PLANE, GeomType.ELLIPSOID): Routine("_plane_ellipsoid", 1),
    (GeomType.PLANE, GeomType.CYLINDER): Routine("_plane_cylinder", 4),
    (GeomType.PLANE, GeomType.BOX): Routine("_plane_box", 4),
    (GeomType.SPHERE, GeomType.SPHERE): Routine("_sphere_sphere", 1),
    (GeomType.SPHERE, GeomType.CAPSULE): Routine("_sphere_capsule", 1),
    (GeomType.SPHERE, GeomType.CYLINDER): Routine("_sphere_cylinder", 1),
    (GeomType.SPHERE, GeomType.BOX): Routine("_sphere_box", 1),
    (GeomType.CAPSULE, GeomType.CAPSULE): Routine("_capsule_capsule", 1),
    (GeomType.CAPSULE, GeomType.BOX): Routine("_capsule_box", 2),
    (GeomType.BOX, GeomType.BOX): Routine("_box_box", 4),
}

# convex pairs without an analytic routine go through MPR with one contact
# table entry of capacity 4, planes vs meshes likewise, and height fields
# through tangent-plane delegation (the JAX package's generic registrations)
_CONVEX = (GeomType.SPHERE, GeomType.CAPSULE, GeomType.ELLIPSOID,
           GeomType.CYLINDER, GeomType.BOX, GeomType.MESH)
for _i, _t1 in enumerate(_CONVEX):
    for _t2 in _CONVEX[_i:]:
        _DISPATCH.setdefault((_t1, _t2), Routine("convex_pair", 4))
_DISPATCH.setdefault((GeomType.PLANE, GeomType.MESH), Routine("plane_convex", 4))
for _t2, _cap in ((GeomType.SPHERE, 1), (GeomType.CAPSULE, 2),
                  (GeomType.ELLIPSOID, 1), (GeomType.CYLINDER, 4),
                  (GeomType.BOX, 4), (GeomType.MESH, 4)):
    _DISPATCH.setdefault((GeomType.HFIELD, _t2), Routine("hfield_pair", _cap))

# capacity table consumed by the compiler (core/assemble.py)
PAIR_NCON = {k: r.cap for k, r in _DISPATCH.items()}


def _pair_condim(m: Model, g1: int, g2: int) -> int:
    p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
    if p1 != p2:
        return int(m.geom_condim[g1 if p1 > p2 else g2])
    return int(max(m.geom_condim[g1], m.geom_condim[g2]))


def pair_groups(m: Model):
    """Narrowphase groups + the static slot layout (uncompacted table).

    Each group dict: key, pairs, g1s/g2s, cap, condim, topk (always 0 here)
    and bases (per-pair slot base). Groups key on (type1, type2, dataids);
    slots follow collision_pairs order, each pair's `cap` slots contiguous."""
    if m.pair_topk:
        raise NotImplementedError("pair_topk broadphase compaction is not "
                                  "ported to the torch package")
    mesh_like = (GeomType.MESH, GeomType.HFIELD)
    groups: dict = {}
    order = []
    for (g1, g2) in m.collision_pairs:
        t1, t2 = GeomType(m.geom_type[g1]), GeomType(m.geom_type[g2])
        cap = _DISPATCH[(t1, t2)].cap
        did1 = m.geom_dataid[g1] if t1 in mesh_like else -1
        did2 = m.geom_dataid[g2] if t2 in mesh_like else -1
        key = ("g", t1, t2, did1, did2, -1)
        if key not in groups:
            groups[key] = dict(key=key, pairs=[], cap=cap)
            order.append(key)
        groups[key]["pairs"].append((g1, g2))

    base = 0
    pair_base: dict = {}
    for (g1, g2) in m.collision_pairs:
        pair_base[(g1, g2)] = base
        base += _DISPATCH[(GeomType(m.geom_type[g1]),
                           GeomType(m.geom_type[g2]))].cap
    out = []
    for key in order:
        grp = groups[key]
        pairs = grp["pairs"]
        grp["topk"] = 0
        grp["g1s"] = np.array([p[0] for p in pairs])
        grp["g2s"] = np.array([p[1] for p in pairs])
        grp["condim"] = key[5]      # uniform condim only matters when compacted
        grp["bases"] = np.array([pair_base[p] for p in pairs])
        out.append(grp)
    return out


def slot_meta(m: Model):
    """Static (geom1, geom2, condim) tuples for every contact slot, in the
    order the JAX package's collide() emits them."""
    slots: dict = {}
    for grp in pair_groups(m):
        for (g1, g2), b in zip(grp["pairs"], grp["bases"]):
            condim = _pair_condim(m, g1, g2)
            for j in range(grp["cap"]):
                slots[int(b) + j] = (g1, g2, condim)
    n = len(slots)
    return (tuple(slots[i][0] for i in range(n)),
            tuple(slots[i][1] for i in range(n)),
            tuple(slots[i][2] for i in range(n)))


def _contact_params_vec(m: Model, g1s: np.ndarray, g2s: np.ndarray, dtype):
    """mj_contactParam over static pair arrays: (friction5, solref, solimp,
    margin, gap), one row per pair."""
    pr = np.array(m.geom_priority)
    p1, p2 = pr[g1s], pr[g2s]
    hi = static_tensor(np.where(p1 > p2, g1s, g2s), m.device)
    neq = static_tensor(p1 != p2, m.device)
    g1s = static_tensor(g1s, m.device)
    g2s = static_tensor(g2s, m.device)

    fri_eq = torch.maximum(m.geom_friction[g1s], m.geom_friction[g2s])
    s1, s2 = m.geom_solmix[g1s], m.geom_solmix[g2s]
    both_small = (s1 < MINVAL) & (s2 < MINVAL)
    mix = torch.where(both_small, 0.5,
                      torch.where(s1 < MINVAL, 0.0,
                                  torch.where(s2 < MINVAL, 1.0,
                                              s1 / torch.clamp(s1 + s2, min=MINVAL))))
    r1, r2 = m.geom_solref[g1s], m.geom_solref[g2s]
    standard = (r1[:, 0] > 0) & (r2[:, 0] > 0)
    solref_eq = torch.where(standard[:, None],
                            mix[:, None] * r1 + (1 - mix[:, None]) * r2,
                            torch.minimum(r1, r2))
    solimp_eq = (mix[:, None] * m.geom_solimp[g1s]
                 + (1 - mix[:, None]) * m.geom_solimp[g2s])

    fri = torch.where(neq[:, None], m.geom_friction[hi], fri_eq)
    solref = torch.where(neq[:, None], m.geom_solref[hi], solref_eq)
    solimp = torch.where(neq[:, None], m.geom_solimp[hi], solimp_eq)
    margin = torch.maximum(m.geom_margin[g1s], m.geom_margin[g2s])
    gap = torch.maximum(m.geom_gap[g1s], m.geom_gap[g2s])
    friction5 = torch.stack([fri[:, 0], fri[:, 0], fri[:, 1],
                             fri[:, 2], fri[:, 2]], dim=1)
    return (friction5.to(dtype), solref.to(dtype), solimp.to(dtype),
            margin.to(dtype), gap.to(dtype))


def empty_contact(m: Model, nenv: int, dtype, device) -> Contact:
    """The contact set of `nenv` envs with every slot inactive (dist 1e10)."""
    g1, g2, dims = slot_meta(m)
    n = max(len(g1), 1)
    if not g1:
        g1, g2, dims = (-1,) * n, (-1,) * n, (3,) * n

    def z(*shape):
        return torch.zeros((nenv, n) + shape, dtype=dtype, device=device)
    return Contact(
        dist=torch.full((nenv, n), 1e10, dtype=dtype, device=device),
        pos=z(3),
        frame=torch.eye(3, dtype=dtype, device=device).expand(nenv, n, 3, 3).clone(),
        includemargin=z(), friction=z(5), solref=z(2), solimp=z(5),
        geom1=g1, geom2=g2, dim=dims)


def _vec(t):
    """(B, P, 3) -> vec3 of (B, P)."""
    return tuple(t[..., k] for k in range(3))


def _mat(t):
    """(B, P, 3, 3) -> mat3 of (B, P)."""
    return tuple(tuple(t[..., i, j] for j in range(3)) for i in range(3))


def _stack_mat(rows):
    """mat3 rows of (B, P) -> (B, P, 3, 3)."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def collide(m: Model, d: Data) -> Data:
    """Every pair of the static pair table through its primitive; the
    contacts land in the canonical slot order (slot_meta). Each pair group
    runs its primitive once over (envs, pairs) component tensors."""
    dtype = d.qpos.dtype
    B = d.qpos.shape[0]
    dists, poss, frames, incms, fris, srefs, simps, dest = ([] for _ in range(8))
    for grp in pair_groups(m):
        cap, P = grp["cap"], len(grp["pairs"])
        name = _DISPATCH[grp["key"][1:3]].name
        if name not in soa.GENERAL_FNS:
            raise NotImplementedError(f"collide: narrowphase routine {name} is not "
                                      "ported to the torch package")
        g1s, g2s = grp["g1s"], grp["g2s"]
        dest.append(np.concatenate([np.arange(b, b + cap) for b in grp["bases"]]))
        friction5, solref, solimp, margin, gap = _contact_params_vec(m, g1s, g2s, dtype)
        i1 = static_tensor(g1s, d.qpos.device)
        i2 = static_tensor(g2s, d.qpos.device)
        di, po, fr = soa.GENERAL_FNS[name](
            _vec(d.geom_xpos[:, i1]), _mat(d.geom_xmat[:, i1]),
            tuple(m.geom_size[i1].to(dtype).unbind(-1)),
            _vec(d.geom_xpos[:, i2]), _mat(d.geom_xmat[:, i2]),
            tuple(m.geom_size[i2].to(dtype).unbind(-1)))
        # (B, P, cap) pair-major, as the JAX package's (P, cap) reshape
        dists.append(torch.stack(di, -1).reshape(B, P * cap))
        poss.append(torch.stack([torch.stack(p, -1) for p in po], -2)
                    .reshape(B, P * cap, 3))
        frames.append(torch.stack([_stack_mat(f) for f in fr], -3)
                      .reshape(B, P * cap, 3, 3))
        incms.append(torch.repeat_interleave(margin - gap, cap))
        fris.append(torch.repeat_interleave(friction5, cap, dim=0))
        srefs.append(torch.repeat_interleave(solref, cap, dim=0))
        simps.append(torch.repeat_interleave(solimp, cap, dim=0))
    perm = static_tensor(np.argsort(np.concatenate(dest)), d.qpos.device)
    geom1, geom2, dims = slot_meta(m)

    def per_env(parts):
        return torch.cat(parts)[perm].expand((B,) + (-1,) * parts[0].dim())
    contact = Contact(
        dist=torch.cat(dists, 1)[:, perm], pos=torch.cat(poss, 1)[:, perm],
        frame=torch.cat(frames, 1)[:, perm], includemargin=per_env(incms),
        friction=per_env(fris), solref=per_env(srefs), solimp=per_env(simps),
        geom1=geom1, geom2=geom2, dim=dims)
    return d.replace(contact=contact)
