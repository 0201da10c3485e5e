"""Narrowphase: dispatch table, pair groups, contact slots and `collide`.

Counterpart of mujoco_ros_pkgs_tpu/ops/narrowphase.py. The slot layout
(which contact of which geom pair lands in which slot) must be identical to
the JAX package's, because contact rows are compared with it row by row.
The dispatch table names every routine the JAX package has, so the pair
table and capacities agree for any model: the twelve analytic primitives
of ops/narrowphase_soa.py (SOA_FNS); MPR (ops/gjk.convex_pair) for a
cylinder against a capsule, a box or a cylinder, an ellipsoid against
anything but a plane, and a mesh against anything but a plane; a plane
against a mesh's hull (ops/gjk.plane_convex); a height field against
anything but a plane (ops/hfield.hfield_pair). Every MPR pair of the
model, whatever its group, runs in one batched MPR call per step.

Per-pair parameter mixing mirrors mj_contactParam (priority, solmix,
solref/solimp blending, elementwise-max friction).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core.types import Contact, Data, GeomType, Model
from mujoco_ros_pkgs_tpu_torch.ops import gjk, hfield
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
for _t2, _cap in hfield.HFIELD_NCON.items():
    _DISPATCH.setdefault((GeomType.HFIELD, _t2), Routine("hfield_pair", _cap))

# capacity table consumed by the compiler (core/assemble.py)
PAIR_NCON = {k: r.cap for k, r in _DISPATCH.items()}


def _pair_condim(m: Model, g1: int, g2: int) -> int:
    p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
    if p1 != p2:
        return int(m.geom_condim[g1 if p1 > p2 else g2])
    return int(max(m.geom_condim[g1], m.geom_condim[g2]))


def pair_groups(m: Model):
    """Narrowphase groups + the static slot layout, shared by slot_meta,
    collide and the broadphase so that they agree exactly.

    Each group dict: key, pairs, g1s/g2s, cap (contacts per pair), condim
    (uniform, meaningful when compacted) and topk: 0 for a group whose pairs
    each own `cap` static slots from `bases` (per pair, collision_pairs
    order), or K = m.pair_topk for a group of more than K compactable pairs
    whose K most-overlapping pairs per env land in K * cap dynamic slots
    from `dyn_base` (`dyn_rank` their first rank in Contact.dyn_pair).
    With pair_topk > 0 the groups also key on condim, so that dynamic slots
    have one static condim; dynamic blocks follow every static slot."""
    from mujoco_ros_pkgs_tpu_torch.ops import broadphase

    mesh_like = (GeomType.MESH, GeomType.HFIELD)
    topk = int(m.pair_topk)
    groups: dict = {}
    order = []
    for (g1, g2) in m.collision_pairs:
        t1, t2 = GeomType(m.geom_type[g1]), GeomType(m.geom_type[g2])
        cap = _DISPATCH[(t1, t2)].cap
        did1 = m.geom_dataid[g1] if t1 in mesh_like else -1
        did2 = m.geom_dataid[g2] if t2 in mesh_like else -1
        key = ("g", t1, t2, did1, did2, _pair_condim(m, g1, g2) if topk else -1)
        if key not in groups:
            groups[key] = dict(key=key, pairs=[], cap=cap)
            order.append(key)
        groups[key]["pairs"].append((g1, g2))

    out = []
    pair_grp: dict = {}
    for key in order:
        grp = groups[key]
        pairs = grp["pairs"]
        compact = (topk and len(pairs) > topk
                   and broadphase.compactable(key[1], key[2]))
        grp["topk"] = topk if compact else 0
        grp["g1s"] = np.array([p[0] for p in pairs])
        grp["g2s"] = np.array([p[1] for p in pairs])
        grp["condim"] = key[5]
        for p in pairs:
            pair_grp[p] = grp
        out.append(grp)
    base = 0
    pair_base: dict = {}
    for p in m.collision_pairs:
        grp = pair_grp[p]
        if not grp["topk"]:
            pair_base[p] = base
            base += grp["cap"]
    dyn_rank = 0
    for grp in out:
        if grp["topk"]:
            grp["dyn_base"], grp["dyn_rank"] = base, dyn_rank
            base += grp["topk"] * grp["cap"]
            dyn_rank += grp["topk"] * grp["cap"]
        else:
            grp["bases"] = np.array([pair_base[p] for p in grp["pairs"]])
    return out


def slot_meta(m: Model):
    """Static (geom1, geom2, condim) tuples for every contact slot, in the
    order the JAX package's collide() emits them; a dynamic slot carries
    geom ids -2 (its pair is in Contact.dyn_pair)."""
    slots: dict = {}
    for grp in pair_groups(m):
        if grp["topk"]:
            for j in range(grp["topk"] * grp["cap"]):
                slots[grp["dyn_base"] + j] = (-2, -2, grp["condim"])
            continue
        for (g1, g2), b in zip(grp["pairs"], grp["bases"]):
            condim = _pair_condim(m, g1, g2)
            for j in range(grp["cap"]):
                slots[int(b) + j] = (g1, g2, condim)
    n = len(slots)
    return (tuple(slots[i][0] for i in range(n)),
            tuple(slots[i][1] for i in range(n)),
            tuple(slots[i][2] for i in range(n)))


def n_dyn_slots(m: Model) -> int:
    """The number of dynamic (broadphase-compacted) contact slots."""
    return sum(g["topk"] * g["cap"] for g in pair_groups(m) if g["topk"])


def _contact_params_vec(m: Model, g1s, g2s, dtype):
    """mj_contactParam over the pairs of a group: static numpy arrays (P,)
    or per-env index tensors (B, K) of a compacted group. Returns
    (friction5, solref, solimp, margin, gap), one entry per pair."""
    dev = m.device
    if isinstance(g1s, np.ndarray):
        pr = np.array(m.geom_priority)
        p1, p2 = pr[g1s], pr[g2s]
        hi = static_tensor(np.where(p1 > p2, g1s, g2s), dev)
        neq = static_tensor(p1 != p2, dev)[..., None]
        i1, i2 = static_tensor(g1s, dev), static_tensor(g2s, dev)
    else:
        i1, i2 = g1s, g2s
        pr = static_tensor(m.geom_priority, dev)
        p1, p2 = pr[i1], pr[i2]
        hi = torch.where(p1 > p2, i1, i2)
        neq = (p1 != p2)[..., None]

    fri_eq = torch.maximum(m.geom_friction[i1], m.geom_friction[i2])
    s1, s2 = m.geom_solmix[i1], m.geom_solmix[i2]
    both_small = (s1 < MINVAL) & (s2 < MINVAL)
    mix = torch.where(both_small, 0.5,
                      torch.where(s1 < MINVAL, 0.0,
                                  torch.where(s2 < MINVAL, 1.0,
                                              s1 / torch.clamp(s1 + s2, min=MINVAL))))
    mix = mix[..., None]
    r1, r2 = m.geom_solref[i1], m.geom_solref[i2]
    standard = (r1[..., :1] > 0) & (r2[..., :1] > 0)
    solref_eq = torch.where(standard, mix * r1 + (1 - mix) * r2, torch.minimum(r1, r2))
    solimp_eq = mix * m.geom_solimp[i1] + (1 - mix) * m.geom_solimp[i2]

    fri = torch.where(neq, m.geom_friction[hi], fri_eq)
    solref = torch.where(neq, m.geom_solref[hi], solref_eq)
    solimp = torch.where(neq, m.geom_solimp[hi], solimp_eq)
    margin = torch.maximum(m.geom_margin[i1], m.geom_margin[i2])
    gap = torch.maximum(m.geom_gap[i1], m.geom_gap[i2])
    friction5 = torch.stack([fri[..., 0], fri[..., 0], fri[..., 1],
                             fri[..., 2], fri[..., 2]], dim=-1)
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
        geom1=g1, geom2=g2, dim=dims,
        dyn_pair=torch.zeros((nenv, n_dyn_slots(m), 2), dtype=torch.int64,
                             device=device))


def _vec(t):
    """(B, P, 3) -> vec3 of (B, P)."""
    return tuple(t[..., k] for k in range(3))


def _mat(t):
    """(B, P, 3, 3) -> mat3 of (B, P)."""
    return tuple(tuple(t[..., i, j] for j in range(3)) for i in range(3))


def _stack_mat(rows):
    """mat3 rows of (B, P) -> (B, P, 3, 3)."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _topk_pairs(m: Model, d: Data, grp):
    """The K most-overlapping pairs (B, K) of a compacted group in every
    env, most-overlapping first: lax.top_k's order, a lower pair index
    first among equal scores (a stable sort)."""
    from mujoco_ros_pkgs_tpu_torch.ops import broadphase

    sep = broadphase.pair_scores(m, d, grp["g1s"], grp["g2s"], grp["key"][1])
    sel = torch.sort(sep, dim=1, stable=True)[1][:, :grp["topk"]]
    dev = d.qpos.device
    return static_tensor(grp["g1s"], dev)[sel], static_tensor(grp["g2s"], dev)[sel]


def _hull(m: Model, did: int, dtype) -> torch.Tensor:
    """Mesh did's hull vertices (V, 3), without the padding."""
    return m.mesh_vert[did, :m.mesh_vertnum[did]].to(dtype)


def _mpr_all(m: Model, d: Data, jobs):
    """Every MPR group's pairs in one ops/gjk.convex_pair call: jobs are
    (i1, i2 (B, P) geom ids, t1, t2, did1, did2); returns the (dist, pos,
    frame) of each job, (B, P * 4, ...)."""
    dtype = d.qpos.dtype
    i1 = torch.cat([j[0] for j in jobs], 1)
    i2 = torch.cat([j[1] for j in jobs], 1)
    cols = [(j[2], j[3], j[4], j[5]) for j in jobs for _ in range(j[0].shape[1])]
    t1s, t2s, did1s, did2s = zip(*cols)

    def verts(dids):
        if not m.nmesh:
            return None
        return m.mesh_vert[static_tensor(np.maximum(dids, 0), d.qpos.device)].to(dtype)[None]

    def geom(idx):
        return (m.geom_size.to(dtype)[idx],
                torch.take_along_dim(d.geom_xpos, idx[..., None], 1),
                torch.take_along_dim(d.geom_xmat, idx[..., None, None], 1))
    s1, x1, r1 = geom(i1)
    s2, x2, r2 = geom(i2)
    di, po, fr = gjk.convex_pair(t1s, t2s, s1, x1, r1, s2, x2, r2, verts(did1s), verts(did2s))
    B, out, at = d.qpos.shape[0], [], 0
    for j in jobs:
        P = j[0].shape[1]
        out.append((di[:, at:at + P].reshape(B, P * 4), po[:, at:at + P].reshape(B, P * 4, 3),
                    fr[:, at:at + P].reshape(B, P * 4, 3, 3)))
        at += P
    return out


def collide(m: Model, d: Data) -> Data:
    """Every pair of the pair table through its routine; the contacts land
    in the canonical slot order (slot_meta). Each analytic, plane-mesh or
    height-field group runs its routine once over (envs, pairs) tensors,
    and the MPR groups all together in one call; a compacted group
    (m.pair_topk) runs on each env's K most-overlapping pairs, gathered per
    env, into its dynamic slots."""
    dtype = d.qpos.dtype
    B = d.qpos.shape[0]
    dev = d.qpos.device
    dists, poss, frames, params, dest, dyn_pairs, jobs = ([] for _ in range(7))
    for grp in pair_groups(m):
        cap = grp["cap"]
        _, t1, t2, did1, did2, _ = grp["key"]
        name = _DISPATCH[(t1, t2)].name
        if grp["topk"]:
            i1, i2 = _topk_pairs(m, d, grp)                  # (B, K) per env
            P = grp["topk"]
            dyn_pairs.append(torch.stack([i1, i2], -1).repeat_interleave(cap, 1))
            dest.append(np.arange(grp["dyn_base"], grp["dyn_base"] + P * cap))
            x1 = torch.take_along_dim(d.geom_xpos, i1[..., None], 1)
            x2 = torch.take_along_dim(d.geom_xpos, i2[..., None], 1)
            r1 = torch.take_along_dim(d.geom_xmat, i1[..., None, None], 1)
            r2 = torch.take_along_dim(d.geom_xmat, i2[..., None, None], 1)
        else:
            P = len(grp["pairs"])
            dest.append(np.concatenate([np.arange(b, b + cap) for b in grp["bases"]]))
            i1 = static_tensor(grp["g1s"], dev)
            i2 = static_tensor(grp["g2s"], dev)
            x1, x2 = d.geom_xpos[:, i1], d.geom_xpos[:, i2]
            r1, r2 = d.geom_xmat[:, i1], d.geom_xmat[:, i2]
        friction5, solref, solimp, margin, gap = _contact_params_vec(
            m, i1 if grp["topk"] else grp["g1s"], i2 if grp["topk"] else grp["g2s"], dtype)
        # per-pair parameters: (P * cap, ...) of a static group, (B, K * cap,
        # ...) of a compacted one
        params.append([t.repeat_interleave(cap, dim=1 if grp["topk"] else 0)
                       for t in (margin - gap, friction5, solref, solimp)])
        size2 = m.geom_size[i2].to(dtype)
        if name == "convex_pair":
            # filled in after the loop, by one MPR call for every such group
            jobs.append((len(dists), i1.expand(B, P), i2.expand(B, P), t1, t2, did1, did2))
            for parts in (dists, poss, frames):
                parts.append(None)
            continue
        if name == "plane_convex":
            di, po, fr = gjk.plane_convex(r1[..., 2], x1, x2, r2, _hull(m, did2, dtype))
        elif name == "hfield_pair":
            di, po, fr = hfield.hfield_pair(
                m, did1, t2, x1, r1, x2, r2, size2, m.geom_rbound[i2].to(dtype),
                _hull(m, did2, dtype) if t2 == GeomType.MESH else None)
        else:
            di, po, fr = soa.SOA_FNS[name](
                _vec(x1), _mat(r1), tuple(m.geom_size[i1].to(dtype).unbind(-1)),
                _vec(x2), _mat(r2), tuple(size2.unbind(-1)))
            di = torch.stack(di, -1)
            po = torch.stack([torch.stack(p, -1) for p in po], -2)
            fr = torch.stack([_stack_mat(f) for f in fr], -3)
        # (B, P, cap) pair-major, as the JAX package's (P, cap) reshape
        dists.append(di.reshape(B, P * cap))
        poss.append(po.reshape(B, P * cap, 3))
        frames.append(fr.reshape(B, P * cap, 3, 3))
    if jobs:
        for job, (di, po, fr) in zip(jobs, _mpr_all(m, d, [j[1:] for j in jobs])):
            dists[job[0]], poss[job[0]], frames[job[0]] = di, po, fr
    perm = static_tensor(np.argsort(np.concatenate(dest)), dev)
    geom1, geom2, dims = slot_meta(m)

    def per_env(parts):
        if not dyn_pairs:     # shared by the batch: one copy, expanded
            return torch.cat(parts)[perm].expand((B,) + (-1,) * parts[0].dim())
        nd = max(p.dim() for p in parts)
        parts = [p.expand((B,) + p.shape) if p.dim() < nd else p for p in parts]
        return torch.cat(parts, 1)[:, perm]
    incm, fric, sref, simp = (per_env(list(col)) for col in zip(*params))
    dyn_pair = (torch.cat(dyn_pairs, 1) if dyn_pairs
                else torch.zeros((B, 0, 2), dtype=torch.int64, device=dev))
    contact = Contact(
        dist=torch.cat(dists, 1)[:, perm], pos=torch.cat(poss, 1)[:, perm],
        frame=torch.cat(frames, 1)[:, perm], includemargin=incm, friction=fric,
        solref=sref, solimp=simp, geom1=geom1, geom2=geom2, dim=dims,
        dyn_pair=dyn_pair)
    return d.replace(contact=contact)
