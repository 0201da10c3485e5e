"""Sensor evaluation over a batch: mj_sensorPos / mj_sensorVel / mj_sensorAcc.

Counterpart of mujoco_ros_pkgs_tpu/ops/sensor_impl.py for all 36 sensor
types (core/assemble.SENSOR_DIM), each at the stage the JAX package gives
it. Position: framepos, framequat, the frame axes, jointpos, ballquat,
tendonpos, actuatorpos, the joint and tendon limits' distances, subtreecom,
magnetometer, rangefinder, clock. Velocity: velocimeter, gyro, jointvel,
ballangvel, tendonvel, actuatorvel, framelinvel and frameangvel (relative
to a reference frame where one is given), subtreelinvel, subtreeangmom,
the limits' velocities. Acceleration: accelerometer, force, torque,
framelinacc and frameangacc (from _rne_post's cacc), actuatorfrc, touch
and the limits' forces (from the solver's row forces and efc.row_layout).
Each sensor is one set of batched ops over the whole batch (tensors (B,
...)); the values go into d.sensordata as ground truth, and noise and
cutoff scaling are the sensors plugin's (plugins/sensors.py), as the JAX
package splits them.

Rangefinder rays meet every geom type: primitives analytically
(`ray_local`), meshes by their hull's triangles, height fields by a march
and a bisection. The JAX semantics are copied as they are, including `_rne_post`'s
cfrc_int, which accumulates each subtree's inertial and bias forces but
leaves out contact and constraint forces.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from scipy.spatial import ConvexHull

from mujoco_ros_pkgs_tpu_torch.core.types import Data, GeomType, Model, ObjType, SensorType
from mujoco_ros_pkgs_tpu_torch.ops import math as mmath
from mujoco_ros_pkgs_tpu_torch.ops import smooth

_INF = float("inf")


def _tmv(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """mat^T @ v over leading dims: a world vector in mat's frame."""
    return torch.einsum("...ji,...j->...i", mat, v)


def _obj_pos_mat(d: Data, objtype: int, objid: int):
    if objtype == int(ObjType.BODY):
        return d.xipos[:, objid], d.ximat[:, objid]
    if objtype == int(ObjType.XBODY):
        return d.xpos[:, objid], d.xmat[:, objid]
    if objtype == int(ObjType.SITE):
        return d.site_xpos[:, objid], d.site_xmat[:, objid]
    if objtype == int(ObjType.GEOM):
        return d.geom_xpos[:, objid], d.geom_xmat[:, objid]
    raise ValueError(f"unsupported sensor objtype {objtype}")


def _site_vel(m: Model, d: Data, site: int):
    """mj_objectVelocity of a site in its own frame: (angular, linear)."""
    body = m.site_bodyid[site]
    ref = d.subtree_com[:, m.body_rootid[body]]
    cv = d.cvel[:, body]
    ang = cv[:, :3]
    lin = cv[:, 3:] + mmath.cross(ang, d.site_xpos[:, site] - ref)
    R = d.site_xmat[:, site]
    return _tmv(R, ang), _tmv(R, lin)


def _rne_post(m: Model, d: Data):
    """mj_rnePostConstraint subset: each body's spatial acceleration cacc
    (B, nbody, 6), with qacc and gravity, and the interaction forces
    cfrc_int (B, nbody, 6) accumulated up the tree, by level-order sweeps."""
    B, dtype, dev = d.qpos.shape[0], d.qpos.dtype, d.qpos.device
    cacc = torch.zeros(B, m.nbody, 6, dtype=dtype, device=dev)
    cacc[:, 0, 3:] = -m.opt.gravity.to(dtype)
    maxdof = max(list(m.body_dofnum) + [1])
    dofadr = np.asarray(m.body_dofadr, dtype=np.int64)
    dofnum = np.asarray(m.body_dofnum, dtype=np.int64)
    levels = smooth._model_levels(m)
    for lv in levels:
        a = cacc[:, mmath.static_tensor(lv.par, dev)]
        if m.nv:
            didx = mmath.static_tensor(np.minimum(dofadr[lv.ids][:, None]
                                                  + np.arange(maxdof), m.nv - 1), dev)
            mask = mmath.static_tensor(np.arange(maxdof)[None, :]
                                       < dofnum[lv.ids][:, None], dev, dtype)
            a = (a + torch.einsum("bwi,bwij->bwj", d.qvel[:, didx] * mask,
                                  d.cdof_dot[:, didx])
                 + torch.einsum("bwi,bwij->bwj", d.qacc[:, didx] * mask, d.cdof[:, didx]))
        cacc[:, mmath.static_tensor(lv.ids, dev)] = a
    cfrc = (mmath.inert_vec_mul(d.cinert, cacc)
            + mmath.force_cross(d.cvel, mmath.inert_vec_mul(d.cinert, d.cvel)))
    for lv in reversed(levels):
        cfrc = cfrc.index_add(1, mmath.static_tensor(lv.par, dev),
                              cfrc[:, mmath.static_tensor(lv.ids, dev)])
    return cacc, cfrc


def _site_acc(m: Model, d: Data, cacc: torch.Tensor, site: int):
    """Classical linear acceleration at a site (gravity included through
    cacc of the world) and the angular acceleration of its body."""
    body = m.site_bodyid[site]
    off = d.site_xpos[:, site] - d.subtree_com[:, m.body_rootid[body]]
    cv, ca = d.cvel[:, body], cacc[:, body]
    w = cv[:, :3]
    v_p = cv[:, 3:] + mmath.cross(w, off)
    a_p = ca[:, 3:] + mmath.cross(ca[:, :3], off) + mmath.cross(w, v_p)
    return a_p, ca[:, :3]


# ---------------------------------------------------------------------------
# ray casting (rangefinder)
# ---------------------------------------------------------------------------

def _ray_sphere(t, v, r):
    b = (t * v).sum(-1)
    c = (t * t).sum(-1) - r * r
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    d1, d2 = -b - sq, -b + sq
    dist = torch.where(d1 >= 0, d1, d2)
    return torch.where((disc >= 0) & (dist >= 0), dist, _INF)


def _ray_cylinder_side(t, v, r, h):
    a = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
    b = t[..., 0] * v[..., 0] + t[..., 1] * v[..., 1]
    c = t[..., 0] * t[..., 0] + t[..., 1] * t[..., 1] - r * r
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(a > 1e-12, a, 1e-12)
    d1 = (-b - sq) / a_safe
    d2 = (-b + sq) / a_safe
    ok1 = (d1 >= 0) & ((t[..., 2] + d1 * v[..., 2]).abs() <= h)
    ok2 = (d2 >= 0) & ((t[..., 2] + d2 * v[..., 2]).abs() <= h)
    dist = torch.where(ok1, d1, torch.where(ok2, d2, _INF))
    return torch.where((disc >= 0) & (a > 1e-12), dist, _INF)


def _shift_z(t, dz):
    return torch.cat([t[..., :2], (t[..., 2] + dz)[..., None]], -1)


def ray_local(gt: int, size: torch.Tensor, t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Distance along a ray to a primitive in the geom's local frame
    (t = R^T (origin - p), v = R^T dir, both (..., 3); size (3,)), +inf on a
    miss: a plane (finite where its size is), sphere, capsule, box,
    cylinder (side and caps) or ellipsoid (the unit sphere's quadratic in
    the scaled frame). A mesh or a height field, whose rays need the model
    (_ray_geom), gets +inf here, as from the JAX function."""
    if gt == int(GeomType.PLANE):
        denom = v[..., 2]
        ok_den = denom.abs() > 1e-12
        dist = -t[..., 2] / torch.where(ok_den, denom, 1e-12)
        p = t + dist[..., None] * v
        in_x = (size[0] <= 0) | (p[..., 0].abs() <= size[0])
        in_y = (size[1] <= 0) | (p[..., 1].abs() <= size[1])
        return torch.where(ok_den & (dist >= 0) & in_x & in_y, dist, _INF)
    if gt == int(GeomType.SPHERE):
        return _ray_sphere(t, v, size[0])
    if gt == int(GeomType.CAPSULE):
        d_cyl = _ray_cylinder_side(t, v, size[0], size[1])
        d_c1 = _ray_sphere(_shift_z(t, -size[1]), v, size[0])
        d_c2 = _ray_sphere(_shift_z(t, size[1]), v, size[0])
        return torch.minimum(d_cyl, torch.minimum(d_c1, d_c2))
    if gt == int(GeomType.BOX):
        tmin = torch.zeros_like(t[..., 0])
        tmax = torch.full_like(t[..., 0], _INF)
        for ax in range(3):
            va = torch.where(v[..., ax].abs() > 1e-12, v[..., ax], 1e-12)
            t1 = (-size[ax] - t[..., ax]) / va
            t2 = (size[ax] - t[..., ax]) / va
            tmin = torch.maximum(tmin, torch.minimum(t1, t2))
            tmax = torch.minimum(tmax, torch.maximum(t1, t2))
        return torch.where(tmax >= tmin, tmin, _INF)
    if gt == int(GeomType.CYLINDER):
        best = _ray_cylinder_side(t, v, size[0], size[1])
        ok_den = v[..., 2].abs() > 1e-12
        vz = torch.where(ok_den, v[..., 2], 1e-12)
        for sgn in (1.0, -1.0):           # the cap disks at z = +-h
            dc = (sgn * size[1] - t[..., 2]) / vz
            p = t + dc[..., None] * v
            ok = ok_den & (dc >= 0) & (p[..., 0] ** 2 + p[..., 1] ** 2 <= size[0] ** 2)
            best = torch.minimum(best, torch.where(ok, dc, _INF))
        return best
    if gt == int(GeomType.ELLIPSOID):
        ts, vs = t / size, v / size
        a = (vs * vs).sum(-1)
        b = (ts * vs).sum(-1)
        disc = b * b - a * ((ts * ts).sum(-1) - 1.0)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        a_safe = torch.clamp(a, min=1e-12)
        d1, d2 = (-b - sq) / a_safe, (-b + sq) / a_safe
        dist = torch.where(d1 >= 0, d1, d2)
        return torch.where((disc >= 0) & (dist >= 0), dist, _INF)
    return torch.full_like(t[..., 0], _INF)


# triangulated hull faces of each mesh, by the model's vertex tensor (kept
# alive in the entry, so that its id stays its own) and the mesh id
_HULL_FACES: dict = {}


def hull_faces(m: Model, did: int) -> torch.Tensor:
    """The triangulated faces (F, 3) int64 of mesh did's hull, on the
    model's device: computed on the host once per model tensor and mesh
    (forward.make_plan asks first, so that no step waits for the copy)."""
    key = (id(m.mesh_vert), did)
    hit = _HULL_FACES.get(key)
    if hit is None:
        verts = m.mesh_vert[did, :m.mesh_vertnum[did]].detach().cpu().double().numpy()
        faces = torch.as_tensor(ConvexHull(verts).simplices.astype(np.int64),
                                device=m.mesh_vert.device)
        if len(_HULL_FACES) >= 64:
            _HULL_FACES.pop(next(iter(_HULL_FACES)))
        hit = _HULL_FACES[key] = (m.mesh_vert, faces)
    return hit[1]


def _ray_triangles(t, v, tri):
    """Moller-Trumbore over triangles tri (F, 3, 3) for rays t, v (B, 3):
    the nearest hit (B,), +inf on a miss."""
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    h = mmath.cross(v[:, None], e2)                       # (B, F, 3)
    a = (e1 * h).sum(-1)
    a_safe = torch.where(a.abs() > 1e-12, a, 1e-12)
    s = t[:, None] - v0
    u = (s * h).sum(-1) / a_safe
    q = mmath.cross(s, e1)
    w = (v[:, None] * q).sum(-1) / a_safe
    dist = (e2 * q).sum(-1) / a_safe
    ok = (a.abs() > 1e-12) & (u >= 0) & (w >= 0) & (u + w <= 1) & (dist >= 0)
    return torch.where(ok, dist, _INF).amin(-1)


_HF_MARCH_STEPS = 64
_HF_REFINE_STEPS = 10


def _ray_hfield(m: Model, hid: int, t, v):
    """Rays t, v (B, 3) against height field hid's bilinear surface: the ray
    clipped to the field's box, marched in fixed steps to bracket the first
    crossing, then bisected (fixed trip counts; mj_ray's prism walk is data
    dependent)."""
    from mujoco_ros_pkgs_tpu_torch.ops.hfield import sample_height
    size = m.hfield_size[hid].to(t.dtype)     # rx, ry, top, bottom
    lo = torch.stack([-size[0], -size[1], -size[3]])
    hi = torch.stack([size[0], size[1], size[2]])
    tmin = torch.zeros_like(t[:, 0])
    tmax = torch.full_like(t[:, 0], 1e9)
    for ax in range(3):
        va = torch.where(v[:, ax].abs() > 1e-12, v[:, ax], 1e-12)
        t1, t2 = (lo[ax] - t[:, ax]) / va, (hi[ax] - t[:, ax]) / va
        tmin = torch.maximum(tmin, torch.minimum(t1, t2))
        tmax = torch.minimum(tmax, torch.maximum(t1, t2))
    miss_box = tmax < tmin

    def above(s):     # whether the ray's point at parameter s is above the surface
        p = t[:, None] + s[..., None] * v[:, None]
        z, _, _ = sample_height(m, hid, p[..., 0], p[..., 1])
        return p[..., 2] >= z

    # i / (n - 1) as jnp.linspace rounds it (torch.linspace takes its upper
    # half from the end: other last bits, and a sample on the surface may
    # fall on the other side of it)
    frac = (torch.arange(_HF_MARCH_STEPS, dtype=t.dtype, device=t.device)
            * (1.0 / (_HF_MARCH_STEPS - 1)))
    ss = tmin[:, None] + (tmax - tmin)[:, None] * frac            # (B, S)
    below = ~above(ss)
    first = torch.argmax(below.to(torch.int8), -1)               # the first sample below
    any_cross = below.any(-1)
    hit_entry = any_cross & below[:, 0]                          # started below: hit at entry
    s_lo = torch.take_along_dim(ss, torch.clamp(first - 1, min=0)[:, None], 1)[:, 0]
    s_lo = torch.where(first > 0, s_lo, ss[:, 0])
    s_hi = torch.take_along_dim(ss, first[:, None], 1)[:, 0]
    for _ in range(_HF_REFINE_STEPS):
        mid = 0.5 * (s_lo + s_hi)
        ab = above(mid[:, None])[:, 0]
        s_lo, s_hi = torch.where(ab, mid, s_lo), torch.where(ab, s_hi, mid)
    dist = torch.where(hit_entry, ss[:, 0], 0.5 * (s_lo + s_hi))
    return torch.where(any_cross & ~miss_box, dist, _INF)


def _ray_geom(m: Model, g: int, t, v):
    """Rays in geom g's local frame (t, v (B, 3)) against it: +inf on a
    miss. Every geom type: meshes by their hull's triangles, height fields
    by _ray_hfield, the rest by ray_local."""
    gt = m.geom_type[g]
    if gt == int(GeomType.MESH):
        did = m.geom_dataid[g]
        verts = m.mesh_vert[did, :m.mesh_vertnum[did]].to(t.dtype)
        return _ray_triangles(t, v, verts[hull_faces(m, did)])
    if gt == int(GeomType.HFIELD):
        return _ray_hfield(m, m.geom_dataid[g], t, v)
    return ray_local(gt, m.geom_size[g].to(t.dtype), t, v)


def _rangefinder(m: Model, d: Data, site: int) -> torch.Tensor:
    """Distance from the site along its z axis to the nearest geom not on
    the site's own body, -1 where nothing is hit."""
    origin = d.site_xpos[:, site]
    direction = d.site_xmat[:, site, :, 2]
    body = m.site_bodyid[site]
    best = torch.full_like(origin[:, 0], _INF)
    for g in range(m.ngeom):
        if m.geom_bodyid[g] == body:
            continue
        R = d.geom_xmat[:, g]
        best = torch.minimum(best, _ray_geom(m, g, _tmv(R, origin - d.geom_xpos[:, g]),
                                             _tmv(R, direction)))
    return torch.where(torch.isinf(best), -1.0, best)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def _write(d: Data, vals) -> Data:
    """d with the (address, value (B, k)) pairs written into sensordata."""
    if not vals:
        return d
    sd = d.sensordata.clone()
    for adr, val in vals:
        sd[:, adr:adr + val.shape[-1]] = val
    return d.replace(sensordata=sd)


def _frame_axis(st: int, mat: torch.Tensor) -> torch.Tensor:
    return mat[..., st - int(SensorType.FRAMEXAXIS)]


def _limit_dist(x, rng, margin):
    """min(x - range[0], range[1] - x) - margin, the nearer side's distance."""
    return torch.minimum(x - rng[0], rng[1] - x) - margin


def sensor_pos(m: Model, d: Data) -> Data:
    vals = []
    for i in range(m.nsensor):
        st, ot, oid = m.sensor_type[i], m.sensor_objtype[i], m.sensor_objid[i]
        rt, rid = m.sensor_reftype[i], m.sensor_refid[i]
        if st == int(SensorType.FRAMEPOS):
            val, _ = _obj_pos_mat(d, ot, oid)
            if rid >= 0:
                rpos, rmat = _obj_pos_mat(d, rt, rid)
                val = _tmv(rmat, val - rpos)
        elif st == int(SensorType.FRAMEQUAT):
            val = mmath.mat_to_quat(_obj_pos_mat(d, ot, oid)[1])
            if rid >= 0:
                rq = mmath.mat_to_quat(_obj_pos_mat(d, rt, rid)[1])
                val = mmath.quat_mul(mmath.quat_conj(rq), val)
        elif st in _AXES:
            val = _frame_axis(st, _obj_pos_mat(d, ot, oid)[1])
            if rid >= 0:
                val = _tmv(_obj_pos_mat(d, rt, rid)[1], val)
        elif st == int(SensorType.JOINTPOS):
            qadr = m.jnt_qposadr[oid]
            val = d.qpos[:, qadr:qadr + 1]
        elif st == int(SensorType.BALLQUAT):
            qadr = m.jnt_qposadr[oid]
            val = mmath.normalize(d.qpos[:, qadr:qadr + 4])
        elif st == int(SensorType.TENDONPOS):
            val = d.ten_length[:, oid:oid + 1]
        elif st == int(SensorType.ACTUATORPOS):
            val = d.actuator_length[:, oid:oid + 1]
        elif st == int(SensorType.JOINTLIMITPOS):
            val = torch.clamp(_limit_dist(d.qpos[:, m.jnt_qposadr[oid]], m.jnt_range[oid],
                                          m.jnt_margin[oid]), max=0.0)[:, None]
        elif st == int(SensorType.TENDONLIMITPOS):
            val = torch.clamp(_limit_dist(d.ten_length[:, oid], m.tendon_range[oid],
                                          m.tendon_margin[oid]), max=0.0)[:, None]
        elif st == int(SensorType.SUBTREECOM):
            val = d.subtree_com[:, oid]
        elif st == int(SensorType.MAGNETOMETER):
            val = _tmv(d.site_xmat[:, oid], m.opt.magnetic.to(d.qpos.dtype))
        elif st == int(SensorType.RANGEFINDER):
            val = _rangefinder(m, d, oid)[:, None]
        elif st == int(SensorType.CLOCK):
            val = d.time[:, None]
        else:
            continue
        vals.append((m.sensor_adr[i], val))
    return _write(d, vals)


def _obj_vel(m: Model, d: Data, objtype: int, objid: int):
    """mj_objectVelocity of an object's origin in the world frame:
    (angular, linear)."""
    body = _obj_bodyid(m, objtype, objid)
    cv = d.cvel[:, body]
    ang = cv[:, :3]
    pos = _obj_pos_mat(d, objtype, objid)[0]
    return ang, cv[:, 3:] + mmath.cross(ang, pos - d.subtree_com[:, m.body_rootid[body]])


def _obj_bodyid(m: Model, objtype: int, objid: int) -> int:
    if objtype in (int(ObjType.BODY), int(ObjType.XBODY)):
        return objid
    if objtype == int(ObjType.SITE):
        return m.site_bodyid[objid]
    if objtype == int(ObjType.GEOM):
        return m.geom_bodyid[objid]
    raise ValueError(f"unsupported sensor objtype {objtype}")


@functools.lru_cache(maxsize=256)
def _subtree(body_parentid, root: int) -> np.ndarray:
    """The bodies of root's subtree, root included (every body for the
    world)."""
    out = []
    for b in range(root, len(body_parentid)):
        p = b
        while p > 0 and p != root:
            p = body_parentid[p]
        if p == root:
            out.append(b)
    return np.asarray(out, dtype=np.int64)


def _com_vel(m: Model, d: Data, bodies: torch.Tensor):
    """Angular velocity and the com's linear velocity of bodies (B, k, 3)."""
    cv = d.cvel[:, bodies]
    root = mmath.static_tensor(np.asarray(m.body_rootid, dtype=np.int64), d.qpos.device)
    w = cv[..., :3]
    return w, cv[..., 3:] + mmath.cross(w, d.xipos[:, bodies] - d.subtree_com[:, root[bodies]])


def _limit_vel(m: Model, d: Data, st: int, oid: int) -> torch.Tensor:
    """The limit row's velocity of a joint or tendon limit sensor: its
    value's rate on the nearer side, 0 where the limit is not active."""
    if st == int(SensorType.JOINTLIMITVEL):
        x, rng, margin = d.qpos[:, m.jnt_qposadr[oid]], m.jnt_range[oid], m.jnt_margin[oid]
        v = d.qvel[:, m.jnt_dofadr[oid]]
    else:
        x, rng, margin = d.ten_length[:, oid], m.tendon_range[oid], m.tendon_margin[oid]
        v = (d.ten_J[:, oid] * d.qvel).sum(-1)
    lo, hi = x - rng[0], rng[1] - x
    vel = torch.where(lo < hi, 1.0, -1.0).to(v.dtype) * v
    return torch.where(torch.minimum(lo, hi) < margin, vel, 0.0)


def sensor_vel(m: Model, d: Data) -> Data:
    vals = []
    dev = d.qpos.device
    for i in range(m.nsensor):
        st, ot, oid = m.sensor_type[i], m.sensor_objtype[i], m.sensor_objid[i]
        rt, rid = m.sensor_reftype[i], m.sensor_refid[i]
        if st in (int(SensorType.VELOCIMETER), int(SensorType.GYRO)):
            ang, lin = _site_vel(m, d, oid)
            val = lin if st == int(SensorType.VELOCIMETER) else ang
        elif st == int(SensorType.JOINTVEL):
            vadr = m.jnt_dofadr[oid]
            val = d.qvel[:, vadr:vadr + 1]
        elif st == int(SensorType.BALLANGVEL):
            vadr = m.jnt_dofadr[oid]
            val = d.qvel[:, vadr:vadr + 3]
        elif st == int(SensorType.TENDONVEL):
            val = d.ten_velocity[:, oid:oid + 1]
        elif st == int(SensorType.ACTUATORVEL):
            val = d.actuator_velocity[:, oid:oid + 1]
        elif st in (int(SensorType.FRAMELINVEL), int(SensorType.FRAMEANGVEL)):
            ang, lin = _obj_vel(m, d, ot, oid)
            linear = st == int(SensorType.FRAMELINVEL)
            val = lin if linear else ang
            if rid >= 0:
                # relative to the reference frame, in its axes
                rang, rlin = _obj_vel(m, d, rt, rid)
                rpos, rmat = _obj_pos_mat(d, rt, rid)
                val = _tmv(rmat, lin - rlin - mmath.cross(
                    rang, _obj_pos_mat(d, ot, oid)[0] - rpos) if linear else ang - rang)
        elif st in (int(SensorType.SUBTREELINVEL), int(SensorType.SUBTREEANGMOM)):
            bodies = mmath.static_tensor(_subtree(m.body_parentid, oid), dev)
            w, v_com = _com_vel(m, d, bodies)
            mass = m.body_mass[bodies].to(d.qpos.dtype)[:, None]
            if st == int(SensorType.SUBTREELINVEL):
                val = (mass * v_com).sum(1) / torch.clamp(m.body_subtreemass[oid],
                                                          min=mmath.MINVAL)
            else:
                R = d.ximat[:, bodies]
                Iw = torch.einsum("bkij,kj,bkj->bki", R, m.body_inertia[bodies],
                                  _tmv(R, w))
                val = (Iw + mass * mmath.cross(
                    d.xipos[:, bodies] - d.subtree_com[:, oid:oid + 1], v_com)).sum(1)
        elif st in (int(SensorType.JOINTLIMITVEL), int(SensorType.TENDONLIMITVEL)):
            val = _limit_vel(m, d, st, oid)[:, None]
        else:
            continue
        vals.append((m.sensor_adr[i], val))
    return _write(d, vals)


_AXES = (int(SensorType.FRAMEXAXIS), int(SensorType.FRAMEYAXIS), int(SensorType.FRAMEZAXIS))
_RNE_POST_TYPES = (int(SensorType.ACCELEROMETER), int(SensorType.FORCE),
                   int(SensorType.TORQUE), int(SensorType.FRAMELINACC),
                   int(SensorType.FRAMEANGACC))
# the types that read the solver's forces by its row layout
_ROW_TYPES = (int(SensorType.TOUCH), int(SensorType.JOINTLIMITFRC),
              int(SensorType.TENDONLIMITFRC))
# the stage that computes each type, as the JAX package places them
ACC_TYPES = frozenset(_RNE_POST_TYPES + _ROW_TYPES + (int(SensorType.ACTUATORFRC),))
VEL_TYPES = frozenset(int(t) for t in (
    SensorType.VELOCIMETER, SensorType.GYRO, SensorType.JOINTVEL, SensorType.BALLANGVEL,
    SensorType.TENDONVEL, SensorType.ACTUATORVEL, SensorType.FRAMELINVEL,
    SensorType.FRAMEANGVEL, SensorType.SUBTREELINVEL, SensorType.SUBTREEANGMOM,
    SensorType.JOINTLIMITVEL, SensorType.TENDONLIMITVEL))
POS_TYPES = frozenset(int(t) for t in SensorType) - ACC_TYPES - VEL_TYPES


@functools.lru_cache(maxsize=256)
def _touch_meta(geom_bodyid, geom1, geom2, body, con, con_nrows, pyramidal, nrow):
    """A touch sensor's static reading plan: the contact slots (static ones
    on `body`, then every dynamic slot with its rank among the dynamic
    slots), and each slot's rows in the solver's force vector, padded with
    the index nrow (a row that reads 0)."""
    static, dyn = [], []
    rank = 0
    for ci in range(min(len(geom1), len(con))):
        if geom1[ci] == -2:
            dyn.append((ci, rank))
            rank += 1
        elif geom1[ci] >= 0 and body in (geom_bodyid[geom1[ci]], geom_bodyid[geom2[ci]]):
            static.append(ci)
    slots = static + [ci for ci, _ in dyn]
    width = max([con_nrows[ci] if pyramidal else 1 for ci in slots], default=1)
    rows = np.full((len(slots), width), nrow, dtype=np.int64)
    for k, ci in enumerate(slots):
        n = con_nrows[ci] if pyramidal else 1
        rows[k, :n] = con[ci] + np.arange(n)
    return (np.asarray(slots, dtype=np.int64), len(static),
            np.asarray([r for _, r in dyn], dtype=np.int64), rows)


def _touch(m: Model, d: Data, site: int, layout: dict) -> torch.Tensor:
    """The summed normal force (B,) of the active contacts of every slot
    whose geoms touch the site's body: the normal row's force, or the sum
    of a pyramidal cone's facet forces. 0 where the solver's forces are
    shorter than the row layout, as in the JAX package."""
    dev = d.qpos.device
    body = m.site_bodyid[site]
    c = d.contact
    f = d.efc_force_contact
    total = f.new_zeros(f.shape[0])
    if f.shape[1] < layout["nrow"]:
        return total
    slots, nstatic, ranks, rows = _touch_meta(
        m.geom_bodyid, c.geom1, c.geom2, body, tuple(layout["con"]),
        tuple(layout["con_nrows"]), layout["pyramidal"], f.shape[1])
    if not slots.size:
        return total
    frc = torch.cat([f, f.new_zeros(f.shape[0], 1)], 1)[:, mmath.static_tensor(rows, dev)].sum(-1)
    ci = mmath.static_tensor(slots, dev)
    hit = c.dist[:, ci] < c.includemargin[:, ci]
    if ranks.size:
        gb = mmath.static_tensor(np.asarray(m.geom_bodyid, dtype=np.int64), dev)
        on_body = (gb[c.dyn_pair[:, mmath.static_tensor(ranks, dev)]] == body).any(-1)
        hit = hit & torch.cat([torch.ones_like(hit[:, :nstatic]), on_body], 1)
    return torch.where(hit, frc, 0.0).sum(1)


def sensor_acc(m: Model, d: Data) -> Data:
    if not any(t in ACC_TYPES for t in m.sensor_type):
        return d
    from mujoco_ros_pkgs_tpu_torch.ops import efc as efc_mod

    cacc = cfrc_int = None
    if any(t in _RNE_POST_TYPES for t in m.sensor_type):
        cacc, cfrc_int = _rne_post(m, d)
    # the solver's row layout, for the sensors that read constraint forces
    layout = (efc_mod.row_layout(m) if any(t in _ROW_TYPES for t in m.sensor_type)
              else None)
    vals = []
    for i in range(m.nsensor):
        st, ot, oid = m.sensor_type[i], m.sensor_objtype[i], m.sensor_objid[i]
        if st == int(SensorType.ACCELEROMETER):
            val = _tmv(d.site_xmat[:, oid], _site_acc(m, d, cacc, oid)[0])
        elif st in (int(SensorType.FORCE), int(SensorType.TORQUE)):
            body = m.site_bodyid[oid]
            f = mmath.transform_force(cfrc_int[:, body], d.site_xpos[:, oid],
                                      d.subtree_com[:, m.body_rootid[body]])
            val = _tmv(d.site_xmat[:, oid],
                       f[:, 3:] if st == int(SensorType.FORCE) else f[:, :3])
        elif st in (int(SensorType.FRAMELINACC), int(SensorType.FRAMEANGACC)):
            body = _obj_bodyid(m, ot, oid)
            off = _obj_pos_mat(d, ot, oid)[0] - d.subtree_com[:, m.body_rootid[body]]
            cv, ca = d.cvel[:, body], cacc[:, body]
            w = cv[:, :3]
            v_p = cv[:, 3:] + mmath.cross(w, off)
            val = (ca[:, 3:] + mmath.cross(ca[:, :3], off) + mmath.cross(w, v_p)
                   if st == int(SensorType.FRAMELINACC) else ca[:, :3])
        elif st == int(SensorType.ACTUATORFRC):
            val = d.actuator_force[:, oid:oid + 1]
        elif st == int(SensorType.TOUCH):
            val = _touch(m, d, oid, layout)[:, None]
        elif st in (int(SensorType.JOINTLIMITFRC), int(SensorType.TENDONLIMITFRC)):
            row = layout["lim_jnt" if st == int(SensorType.JOINTLIMITFRC)
                         else "lim_ten"].get(oid)
            f = d.efc_force_contact
            val = (f[:, row:row + 1] if row is not None and f.shape[1] >= layout["nrow"]
                   else f.new_zeros(f.shape[0], 1))
        else:
            continue
        vals.append((m.sensor_adr[i], val))
    return _write(d, vals)
