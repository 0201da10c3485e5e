"""Model assembly: body/joint/dof topology, collision pair table, simple dofs.

Second stage of the torch port's MJCF compiler (first stage: core/mjcf.py).
Counterpart of mujoco_ros_pkgs_tpu/core/assemble.py for the elements the
port parses (mocap bodies; fixed and spatial tendons; actuators with their
activation layout and length ranges; connect, weld, joint and tendon
equalities; sites; every sensor type; the geoms' fluid coefficients; mesh
hulls and height fields; cameras; keyframes; <contact> excludes and
pairs); integer columns become static tuples.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core import types
from mujoco_ros_pkgs_tpu_torch.core.types import (
    EqType, GeomType, JointType, ObjType, SensorType, WrapType,
)
from mujoco_ros_pkgs_tpu_torch.ops.narrowphase import PAIR_NCON


def collision_pair_table(geom_type, geom_contype, geom_conaffinity,
                         geom_bodyid, body_weldid, body_parentid,
                         filterparent, excludes, explicit_pairs,
                         collision_mode="all"):
    """Static collision pair list + total contact capacity (mj_collision's
    weld/parent/exclude body filter and the contype/conaffinity rule)."""
    ngeom = len(geom_type)
    pairs = []
    if collision_mode != "predefined":
        for g1 in range(ngeom):
            for g2 in range(g1 + 1, ngeom):
                b1, b2 = geom_bodyid[g1], geom_bodyid[g2]
                w1, w2 = body_weldid[b1], body_weldid[b2]
                if w1 == w2:
                    continue
                if (b1, b2) in excludes or (b2, b1) in excludes:
                    continue
                if filterparent and w1 != 0 and w2 != 0:
                    wp1 = body_weldid[body_parentid[w1]]
                    wp2 = body_weldid[body_parentid[w2]]
                    if w1 == wp2 or w2 == wp1:
                        continue
                if not ((geom_contype[g1] & geom_conaffinity[g2])
                        or (geom_contype[g2] & geom_conaffinity[g1])):
                    continue
                pairs.append((g1, g2))
    for (g1, g2) in explicit_pairs:
        if (g1, g2) not in pairs and (g2, g1) not in pairs:
            pairs.append((g1, g2))

    ordered, ncon_max = [], 0
    for (g1, g2) in pairs:
        t1, t2 = geom_type[g1], geom_type[g2]
        if t1 > t2:
            g1, g2, t1, t2 = g2, g1, t2, t1
        cap = PAIR_NCON.get((GeomType(t1), GeomType(t2)))
        if cap is None:
            continue
        ordered.append((g1, g2))
        ncon_max += cap
    return tuple(ordered), ncon_max


def rebuild_pair_table(m: "types.Model") -> "types.Model":
    """Recompute collision_pairs / ncon_max for a Model whose geom types (or
    filter inputs) changed at run time (set_geom_properties with set_type).
    Returns an updated Model."""
    filterparent = not bool(m.opt.disableflags & types.DisableBit.FILTERPARENT)
    ordered, ncon_max = collision_pair_table(
        m.geom_type, m.geom_contype, m.geom_conaffinity, m.geom_bodyid,
        m.body_weldid, m.body_parentid, filterparent, m.pair_exclude,
        m.pair_explicit, m.collision_mode)
    return dataclasses.replace(m, collision_pairs=ordered, ncon_max=ncon_max)


def compute_simple_dofs(body_parentid, body_dofnum, body_dofadr, jnt_bodyid,
                        jnt_type, body_ipos, body_iquat):
    """Dofs with structurally-diagonal qM rows (libmujoco's dof_simplenum>0):
    dofs of an isolated single-joint body with identity inertia orientation
    and, for free/ball joints, the com at the joint frame."""
    nbody = len(body_parentid)
    ipos = np.asarray(body_ipos, dtype=np.float64)
    iquat = np.asarray(body_iquat, dtype=np.float64)
    has_desc_dofs = np.zeros(nbody, dtype=bool)
    for b in range(nbody - 1, 0, -1):
        if body_dofnum[b] or has_desc_dofs[b]:
            has_desc_dofs[body_parentid[b]] = True
    simple = []
    for b in range(1, nbody):
        if not body_dofnum[b] or has_desc_dofs[b]:
            continue
        p = body_parentid[b]
        anc = False
        while p != 0:
            if body_dofnum[p]:
                anc = True
                break
            p = body_parentid[p]
        if anc:
            continue
        jids = [j for j in range(len(jnt_bodyid)) if jnt_bodyid[j] == b]
        if len(jids) != 1:
            continue
        jt = jnt_type[jids[0]]
        if (abs(iquat[b][0] - 1.0) > 1e-12
                or np.any(np.abs(iquat[b][1:]) > 1e-12)):
            continue
        if jt in (int(JointType.FREE), int(JointType.BALL)) and np.any(
                np.abs(ipos[b]) > 1e-12):
            continue
        simple.extend(range(body_dofadr[b], body_dofadr[b] + body_dofnum[b]))
    return tuple(simple)


def _t(x, width=None) -> torch.Tensor:
    arr = np.asarray(x, dtype=np.float64)
    if width is not None and arr.size == 0:
        arr = arr.reshape(0, width)
    return torch.as_tensor(arr, dtype=torch.float64)


# every sensor type (ops/sensor_impl.py) and its width
SENSOR_DIM = {
    SensorType.TOUCH: 1, SensorType.ACCELEROMETER: 3, SensorType.VELOCIMETER: 3,
    SensorType.GYRO: 3, SensorType.FORCE: 3, SensorType.TORQUE: 3,
    SensorType.MAGNETOMETER: 3, SensorType.RANGEFINDER: 1,
    SensorType.JOINTPOS: 1, SensorType.JOINTVEL: 1,
    SensorType.TENDONPOS: 1, SensorType.TENDONVEL: 1,
    SensorType.ACTUATORPOS: 1, SensorType.ACTUATORVEL: 1,
    SensorType.ACTUATORFRC: 1, SensorType.BALLQUAT: 4, SensorType.BALLANGVEL: 3,
    SensorType.JOINTLIMITPOS: 1, SensorType.JOINTLIMITVEL: 1,
    SensorType.JOINTLIMITFRC: 1, SensorType.TENDONLIMITPOS: 1,
    SensorType.TENDONLIMITVEL: 1, SensorType.TENDONLIMITFRC: 1,
    SensorType.FRAMEPOS: 3, SensorType.FRAMEQUAT: 4, SensorType.FRAMEXAXIS: 3,
    SensorType.FRAMEYAXIS: 3, SensorType.FRAMEZAXIS: 3,
    SensorType.FRAMELINVEL: 3, SensorType.FRAMEANGVEL: 3,
    SensorType.FRAMELINACC: 3, SensorType.FRAMEANGACC: 3,
    SensorType.SUBTREECOM: 3, SensorType.SUBTREELINVEL: 3,
    SensorType.SUBTREEANGMOM: 3, SensorType.CLOCK: 1,
}
# the object types the JAX compiler gives a sensor on a tendon or an actuator
OBJ_TENDON = int(ObjType.UNKNOWN) + 100
OBJ_ACTUATOR = int(ObjType.UNKNOWN) + 200
_OBJ = {"body": ObjType.BODY, "xbody": ObjType.XBODY, "joint": ObjType.JOINT,
        "geom": ObjType.GEOM, "site": ObjType.SITE, "camera": ObjType.CAMERA}


def _sensors(elems, names):
    """Sensor columns (mjModel.sensor_*): type, the object and reference
    frame each reads (a tendon's object type OBJ_TENDON, an actuator's
    OBJ_ACTUATOR), and its address and width in sensordata. `names` maps
    "body", "joint", "geom", "site", "tendon" and "actuator" to the model's
    name lists."""
    def index(sensor, kind, name):
        if name not in names[kind]:
            raise ValueError(f"sensor '{sensor}': unknown {kind} '{name}'")
        return names[kind].index(name)

    def resolve(sensor, objtype, name):
        kind = {ObjType.BODY: "body", ObjType.XBODY: "body", ObjType.JOINT: "joint",
                ObjType.GEOM: "geom", ObjType.SITE: "site"}.get(objtype)
        if kind is None:
            raise ValueError(f"sensor '{sensor}': cannot resolve {objtype.name} {name}")
        return index(sensor, kind, name)

    def objtype_of(sensor, attr, value):
        if value not in _OBJ:
            raise ValueError(f"sensor '{sensor}': {attr}='{value}' is not one of "
                             f"{sorted(_OBJ)}")
        return _OBJ[value]

    cols = {k: [] for k in ("type", "objtype", "objid", "reftype", "refid", "adr",
                            "dim", "cutoff", "noise", "name")}
    adr = 0
    for e in elems:
        sname = e.get("name", "")
        st = SensorType[e.tag.upper()]
        objtype, objid = ObjType.UNKNOWN, -1
        if e.get("site") is not None:
            objtype, objid = ObjType.SITE, index(sname, "site", e.get("site"))
        elif e.get("joint") is not None:
            objtype, objid = ObjType.JOINT, index(sname, "joint", e.get("joint"))
        elif e.get("tendon") is not None:
            objtype, objid = OBJ_TENDON, index(sname, "tendon", e.get("tendon"))
        elif e.get("actuator") is not None:
            objtype, objid = OBJ_ACTUATOR, index(sname, "actuator", e.get("actuator"))
        elif e.get("body") is not None:
            objtype, objid = ObjType.BODY, index(sname, "body", e.get("body"))
        elif e.get("objtype") is not None:
            objtype = objtype_of(sname, "objtype", e.get("objtype"))
            objid = resolve(sname, objtype, e.get("objname"))
        reftype, refid = ObjType.UNKNOWN, -1
        if e.get("reftype") is not None:
            reftype = objtype_of(sname, "reftype", e.get("reftype"))
            refid = resolve(sname, reftype, e.get("refname"))
        elif e.get("refname") is not None:
            # MJCF allows refname with the type implied; xbody by default
            reftype, refid = ObjType.XBODY, index(sname, "body", e.get("refname"))
        dim = SENSOR_DIM[st]
        for key, val in (("type", st), ("objtype", objtype), ("objid", objid),
                         ("reftype", reftype), ("refid", refid), ("adr", adr),
                         ("dim", dim)):
            cols[key].append(int(val))
        cols["cutoff"].append(float(e.get("cutoff", "0")))
        cols["noise"].append(float(e.get("noise", "0")))
        cols["name"].append(sname)
        adr += dim
    return cols, adr


def _equalities(eqs, bodies):
    """Equality columns (mjModel.eq_*): eq_data holds connect's anchor in
    body1 (0:3) and the same world point at qpos0 in body2's frame (3:6);
    weld's anchor in body2 (0:3), body2's pose in body1's frame (3:6 and
    6:10: the relpose given, its quaternion normalised, else the pose at
    qpos0) and torquescale (10); joint's polycoef (0:5). Column 10 is 1
    for every type."""
    from mujoco_ros_pkgs_tpu_torch.core.mjcf import _quat_mul, _quat_rot, _quat_to_mat

    # world poses of the bodies at qpos0
    wpos = np.zeros((len(bodies), 3))
    wquat = np.tile(np.array([1.0, 0, 0, 0]), (len(bodies), 1))
    for i in range(1, len(bodies)):
        p = bodies[i].parentid
        wquat[i] = _quat_mul(wquat[p], bodies[i].quat)
        wpos[i] = wpos[p] + _quat_rot(bodies[i].pos, wquat[p])
    data = np.zeros((len(eqs), 11))
    data[:, 10] = 1.0
    types_ = []
    for k, q in enumerate(eqs):
        b1, b2 = q.obj1id, q.obj2id
        if q.tag == "connect":
            types_.append(int(EqType.CONNECT))
            data[k, 0:3] = q.anchor
            wp = wpos[b1] + _quat_rot(q.anchor, wquat[b1])
            data[k, 3:6] = _quat_to_mat(wquat[b2]).T @ (wp - wpos[b2])
        elif q.tag == "weld":
            types_.append(int(EqType.WELD))
            data[k, 0:3] = q.anchor
            if q.relpose is not None:
                rp = q.relpose.copy()
                qn = np.linalg.norm(rp[3:7])
                if qn > 1e-15:
                    rp[3:7] /= qn
                data[k, 3:10] = rp
            else:
                data[k, 3:6] = _quat_to_mat(wquat[b1]).T @ (wpos[b2] - wpos[b1])
                data[k, 6:10] = _quat_mul(wquat[b1] * np.array([1.0, -1, -1, -1]),
                                          wquat[b2])
            data[k, 10] = q.torquescale
        else:
            types_.append(int(EqType.JOINT if q.tag == "joint" else EqType.TENDON))
            data[k, 0:5] = q.polycoef
    return types_, data


def _tendons(tendons):
    """Tendon and wrap columns (mjModel.tendon_*, wrap_*): each tendon's
    wrap entries in order, their prm (a joint's coef, a geom's sidesite id
    or -1, a pulley's divisor) in wrap_prm and, for the spatial path, the
    sidesites and divisors as static columns."""
    adr, wraps = [], []
    for t in tendons:
        adr.append(len(wraps))
        wraps.extend(t.wraps)
    wtype = [w[0] for w in wraps]
    wprm = [w[2] for w in wraps]
    geom_kinds = (int(WrapType.SPHERE), int(WrapType.CYLINDER))
    return dict(
        ntendon=len(tendons), nwrap=len(wraps), tendon_adr=tuple(adr),
        tendon_num=tuple(len(t.wraps) for t in tendons),
        tendon_limited=tuple(t.limited for t in tendons),
        tendon_range=_t([t.range for t in tendons], 2),
        tendon_solref_lim=_t([t.solref for t in tendons], 2),
        tendon_solimp_lim=_t([t.solimp for t in tendons], 5),
        tendon_margin=_t([t.margin for t in tendons]),
        tendon_stiffness=_t([t.stiffness for t in tendons]),
        tendon_damping=_t([t.damping for t in tendons]),
        tendon_frictionloss=_t([t.frictionloss for t in tendons]),
        tendon_lengthspring=_t([t.lengthspring for t in tendons], 2),
        tendon_length0=_t(np.zeros(len(tendons))),
        tendon_invweight0=_t(np.zeros(len(tendons))),
        wrap_type=tuple(wtype), wrap_objid=tuple(w[1] for w in wraps), wrap_prm=_t(wprm),
        wrap_sidesite=tuple(int(p) if k in geom_kinds else -1 for k, p in zip(wtype, wprm)),
        wrap_divisor=tuple(float(p) if k == int(WrapType.PULLEY) else 1.0
                           for k, p in zip(wtype, wprm)),
        tendon_names=tuple(t.name for t in tendons),
        tendon_floss_adr=tuple(k for k, t in enumerate(tendons) if t.frictionloss > 0))


def _actuators(acts):
    """Actuator columns (mjModel.actuator_*): one activation slot, in
    actuator order, per actuator with dynamics."""
    actadr, na = [], 0
    for a in acts:
        actadr.append(na if a.dyntype != int(types.DynType.NONE) else -1)
        na += actadr[-1] >= 0
    return dict(
        na=na, actuator_trntype=tuple(a.trntype for a in acts),
        actuator_dyntype=tuple(a.dyntype for a in acts),
        actuator_gaintype=tuple(a.gaintype for a in acts),
        actuator_biastype=tuple(a.biastype for a in acts),
        actuator_trnid=tuple(a.trnid for a in acts),
        actuator_actadr=tuple(actadr),
        actuator_actnum=tuple(int(adr >= 0) for adr in actadr),
        actuator_ctrllimited=tuple(a.ctrllimited for a in acts),
        actuator_forcelimited=tuple(a.forcelimited for a in acts),
        actuator_actlimited=tuple(a.actlimited for a in acts),
        actuator_dynprm=_t([a.dynprm for a in acts], 10),
        actuator_gainprm=_t([a.gainprm for a in acts], 10),
        actuator_biasprm=_t([a.biasprm for a in acts], 10),
        actuator_ctrlrange=_t([a.ctrlrange for a in acts], 2),
        actuator_forcerange=_t([a.forcerange for a in acts], 2),
        actuator_actrange=_t([a.actrange for a in acts], 2),
        actuator_gear=_t([a.gear for a in acts], 6),
        actuator_lengthrange=_t([a.lengthrange for a in acts], 2),
        actuator_acc0=_t(np.zeros(len(acts))),
        actuator_names=tuple(a.name for a in acts))


def _assets(meshes, hfields):
    """Mesh and height-field columns: the hulls' vertices in one (nmesh,
    max_vert, 3) block, each padded by repeating its first vertex; the
    grids in one (nhfield, max_nrow, max_ncol) block, zero-padded."""
    if meshes:
        maxv = max(mv.verts.shape[0] for mv in meshes)
        vert = np.stack([np.concatenate([mv.verts, np.tile(mv.verts[:1],
                                                           (maxv - mv.verts.shape[0], 1))])
                         for mv in meshes])
    else:
        vert = np.zeros((0, 0, 3))
    if hfields:
        data = np.zeros((len(hfields), max(h.nrow for h in hfields),
                         max(h.ncol for h in hfields)))
        for k, h in enumerate(hfields):
            data[k, :h.nrow, :h.ncol] = h.data
    else:
        data = np.zeros((0, 0, 0))
    return dict(
        nmesh=len(meshes), mesh_vertnum=tuple(mv.verts.shape[0] for mv in meshes),
        mesh_names=tuple(mv.name for mv in meshes), mesh_vert=_t(vert),
        nhfield=len(hfields), hfield_nrow=tuple(h.nrow for h in hfields),
        hfield_ncol=tuple(h.ncol for h in hfields),
        hfield_names=tuple(h.name for h in hfields),
        hfield_size=_t([h.size for h in hfields], 4), hfield_data=_t(data))


def _keyframes(keys, qpos0, nv, na, nu, nmocap):
    """Keyframe columns (mjModel.key_*): each <key>'s values over qpos0,
    zeros and identity mocap quaternions."""
    nkey = len(keys)
    cols = dict(key_time=np.zeros(nkey), key_qpos=np.tile(qpos0, (nkey, 1)),
                key_qvel=np.zeros((nkey, nv)), key_act=np.zeros((nkey, na)),
                key_ctrl=np.zeros((nkey, nu)), key_mpos=np.zeros((nkey, 3 * nmocap)),
                key_mquat=np.tile(np.array([1.0, 0, 0, 0]), (nkey, nmocap)))
    for k, e in enumerate(keys):
        cols["key_time"][k] = float(e.get("time", "0"))
        for attr in ("qpos", "qvel", "act", "ctrl", "mpos", "mquat"):
            if e.get(attr) is not None:
                v = np.array([float(x) for x in e.get(attr).split()])
                arr = cols["key_" + attr]
                if v.size > arr.shape[1]:
                    raise ValueError(f"key '{e.get('name', '')}': {attr} has {v.size} "
                                     f"values, the model {arr.shape[1]}")
                arr[k, :v.size] = v
    return dict(nkey=nkey, key_names=tuple(e.get("name", "") for e in keys),
                **{k: _t(v) for k, v in cols.items()})


def _cameras(cams):
    return dict(ncam=len(cams), cam_bodyid=tuple(c.bodyid for c in cams),
                cam_names=tuple(c.name for c in cams),
                cam_pos=_t([c.pos for c in cams], 3),
                cam_quat=_t([c.quat for c in cams], 4),
                cam_fovy=_t([c.fovy for c in cams]))


def assemble(name, bodies, jnts, geoms, acts, opt, sites=(), sensors=(),
             eqs=(), tendons=(), meshes=(), hfields=(), cams=(), keys=(),
             excludes=(), explicit_pairs=()) -> types.Model:
    nbody, njnt, ngeom, nu = len(bodies), len(jnts), len(geoms), len(acts)
    nsite, neq = len(sites), len(eqs)

    # ---------------- body topology ----------------
    body_parentid = [b.parentid for b in bodies]
    body_rootid = [0] * nbody
    for i in range(1, nbody):
        j = i
        while body_parentid[j] != 0:
            j = body_parentid[j]
        body_rootid[i] = j
    body_weldid = [0] * nbody
    for i in range(1, nbody):
        body_weldid[i] = i if bodies[i].joints else body_weldid[body_parentid[i]]

    # ---------------- joint / dof layout ----------------
    jnt_qposadr, jnt_dofadr = [], []
    nq = nv = 0
    for j in jnts:
        jt = JointType(j.type)
        jnt_qposadr.append(nq)
        jnt_dofadr.append(nv)
        nq += jt.nq()
        nv += jt.nv()

    body_jntnum = [len(b.joints) for b in bodies]
    body_jntadr = [(b.joints[0] if b.joints else -1) for b in bodies]
    body_dofnum = [sum(JointType(jnts[ji].type).nv() for ji in b.joints)
                   for b in bodies]
    body_dofadr = [(jnt_dofadr[b.joints[0]] if b.joints else -1) for b in bodies]

    dof_bodyid, dof_jntid = [], []
    for ji, j in enumerate(jnts):
        for _ in range(JointType(j.type).nv()):
            dof_bodyid.append(j.bodyid)
            dof_jntid.append(ji)

    # previous dof in the body's joint chain, else the last dof of the
    # nearest ancestor body with dofs, else -1
    dof_parentid = [-1] * nv
    last_body_dof = [-1] * nbody
    for bi in range(1, nbody):
        anc = body_parentid[bi]
        while anc != 0 and last_body_dof[anc] < 0:
            anc = body_parentid[anc]
        prev = last_body_dof[anc] if anc != 0 else -1
        for ji in bodies[bi].joints:
            adr = jnt_dofadr[ji]
            for k in range(JointType(jnts[ji].type).nv()):
                dof_parentid[adr + k] = prev
                prev = adr + k
        last_body_dof[bi] = prev if bodies[bi].joints else -1

    # ---------------- qpos0 / qpos_spring ----------------
    qpos0 = np.zeros(nq)
    qpos_spring = np.zeros(nq)
    for ji, j in enumerate(jnts):
        adr = jnt_qposadr[ji]
        t = JointType(j.type)
        if t == JointType.FREE:
            if body_parentid[j.bodyid] != 0:
                raise ValueError("free joint must be on a child of world")
            qpos0[adr:adr + 3] = bodies[j.bodyid].pos
            qpos0[adr + 3:adr + 7] = bodies[j.bodyid].quat
            qpos_spring[adr:adr + 7] = qpos0[adr:adr + 7]
        elif t == JointType.BALL:
            qpos0[adr] = 1.0
            qpos_spring[adr] = 1.0
        else:
            qpos0[adr] = j.ref
            qpos_spring[adr] = j.springref

    body_subtreemass = np.array([b.mass for b in bodies], dtype=np.float64)
    for i in range(nbody - 1, 0, -1):
        body_subtreemass[body_parentid[i]] += body_subtreemass[i]

    filterparent = not bool(opt["disableflags"] & types.DisableBit.FILTERPARENT)
    ordered, ncon_max = collision_pair_table(
        geom_type=tuple(g.type for g in geoms),
        geom_contype=tuple(g.contype for g in geoms),
        geom_conaffinity=tuple(g.conaffinity for g in geoms),
        geom_bodyid=tuple(g.bodyid for g in geoms),
        body_weldid=tuple(body_weldid),
        body_parentid=tuple(body_parentid),
        filterparent=filterparent, excludes=excludes, explicit_pairs=explicit_pairs,
        collision_mode=opt["collision_mode"])

    scols, nsensordata = _sensors(sensors, {
        "body": [b.name for b in bodies], "joint": [j.name for j in jnts],
        "geom": [g.name for g in geoms], "site": [st.name for st in sites],
        "tendon": [t.name for t in tendons], "actuator": [a.name for a in acts]})

    body_mocapid, nmocap = [-1] * nbody, 0
    for i, b in enumerate(bodies):
        if b.mocap:
            body_mocapid[i], nmocap = nmocap, nmocap + 1
    eq_type, eq_data = _equalities(eqs, bodies)

    option = types.Option(
        timestep=_t(opt["timestep"]), gravity=_t(opt["gravity"]),
        wind=_t(opt["wind"]), magnetic=_t(opt["magnetic"]),
        density=_t(opt["density"]), viscosity=_t(opt["viscosity"]),
        impratio=_t(opt["impratio"]), o_margin=_t(opt["o_margin"]),
        o_solref=_t(opt["o_solref"]), o_solimp=_t(opt["o_solimp"]),
        tolerance=_t(opt["tolerance"]), ls_tolerance=_t(opt["ls_tolerance"]),
        integrator=opt["integrator"], cone=opt["cone"], solver=opt["solver"],
        iterations=opt["iterations"], ls_iterations=opt["ls_iterations"],
        disableflags=opt["disableflags"])

    m = types.Model(
        nq=nq, nv=nv, nu=nu, nbody=nbody, njnt=njnt, ngeom=ngeom, neq=neq,
        nmocap=nmocap, nsite=nsite, nsensor=len(sensors), nsensordata=nsensordata, opt=option,
        qpos0=_t(qpos0), qpos_spring=_t(qpos_spring),
        body_parentid=tuple(body_parentid), body_rootid=tuple(body_rootid),
        body_weldid=tuple(body_weldid),
        body_jntnum=tuple(body_jntnum), body_jntadr=tuple(body_jntadr),
        body_dofnum=tuple(body_dofnum), body_dofadr=tuple(body_dofadr),
        body_geomnum=tuple(len(b.geoms) for b in bodies),
        body_geomadr=tuple((b.geoms[0] if b.geoms else -1) for b in bodies),
        body_mocapid=tuple(body_mocapid),
        body_pos=_t([b.pos for b in bodies]),
        body_quat=_t([b.quat for b in bodies]),
        body_ipos=_t([b.ipos for b in bodies]),
        body_iquat=_t([b.iquat for b in bodies]),
        body_mass=_t([b.mass for b in bodies]),
        body_subtreemass=_t(body_subtreemass),
        body_inertia=_t([b.inertia for b in bodies]),
        body_invweight0=_t(np.zeros((nbody, 2))),
        jnt_type=tuple(j.type for j in jnts),
        jnt_qposadr=tuple(jnt_qposadr), jnt_dofadr=tuple(jnt_dofadr),
        jnt_bodyid=tuple(j.bodyid for j in jnts),
        jnt_limited=tuple(j.limited for j in jnts),
        jnt_actfrclimited=tuple(j.actfrclimited for j in jnts),
        jnt_actfrcrange=_t([j.actfrcrange for j in jnts], 2),
        jnt_pos=_t([j.pos for j in jnts], 3),
        jnt_axis=_t([j.axis for j in jnts], 3),
        jnt_stiffness=_t([j.stiffness for j in jnts]),
        jnt_range=_t([j.range for j in jnts], 2),
        jnt_solref=_t([j.solref for j in jnts], 2),
        jnt_solimp=_t([j.solimp for j in jnts], 5),
        jnt_margin=_t([j.margin for j in jnts]),
        dof_bodyid=tuple(dof_bodyid), dof_jntid=tuple(dof_jntid),
        dof_parentid=tuple(dof_parentid),
        dof_armature=_t([jnts[j].armature for j in dof_jntid]),
        dof_damping=_t([jnts[j].damping for j in dof_jntid]),
        dof_invweight0=_t(np.zeros(nv)),
        dof_frictionloss=_t([jnts[j].frictionloss for j in dof_jntid]),
        dof_solref=_t([jnts[j].solref_fri for j in dof_jntid], 2),
        dof_solimp=_t([jnts[j].solimp_fri for j in dof_jntid], 5),
        geom_type=tuple(g.type for g in geoms),
        geom_bodyid=tuple(g.bodyid for g in geoms),
        geom_contype=tuple(g.contype for g in geoms),
        geom_conaffinity=tuple(g.conaffinity for g in geoms),
        geom_condim=tuple(g.condim for g in geoms),
        geom_priority=tuple(g.priority for g in geoms),
        geom_dataid=tuple(g.dataid for g in geoms),
        geom_size=_t([g.size for g in geoms], 3),
        geom_rbound=_t([g.rbound for g in geoms]),
        geom_pos=_t([g.pos for g in geoms], 3),
        geom_quat=_t([g.quat for g in geoms], 4),
        geom_friction=_t([g.friction for g in geoms], 3),
        geom_solmix=_t([g.solmix for g in geoms]),
        geom_solref=_t([g.solref for g in geoms], 2),
        geom_solimp=_t([g.solimp for g in geoms], 5),
        geom_margin=_t([g.margin for g in geoms]),
        geom_gap=_t([g.gap for g in geoms]),
        geom_rgba=_t([g.rgba for g in geoms], 4),
        geom_fluid=_t([g.fluid for g in geoms], 12),
        geom_fluid_active=tuple(int(g.fluid[0] > 0) for g in geoms),
        eq_type=tuple(eq_type), eq_obj1id=tuple(q.obj1id for q in eqs),
        eq_obj2id=tuple(q.obj2id for q in eqs),
        eq_active0=tuple(q.active for q in eqs),
        eq_solref=_t([q.solref for q in eqs], 2),
        eq_solimp=_t([q.solimp for q in eqs], 5),
        eq_data=_t(eq_data, 11),
        site_bodyid=tuple(st.bodyid for st in sites),
        site_pos=_t([st.pos for st in sites], 3),
        site_quat=_t([st.quat for st in sites], 4),
        sensor_type=tuple(scols["type"]), sensor_objtype=tuple(scols["objtype"]),
        sensor_objid=tuple(scols["objid"]), sensor_reftype=tuple(scols["reftype"]),
        sensor_refid=tuple(scols["refid"]), sensor_adr=tuple(scols["adr"]),
        sensor_dim=tuple(scols["dim"]), sensor_cutoff=_t(scols["cutoff"]),
        sensor_noise=_t(scols["noise"]),
        name=name,
        body_names=tuple(b.name for b in bodies),
        jnt_names=tuple(j.name for j in jnts),
        geom_names=tuple(g.name for g in geoms),
        site_names=tuple(st.name for st in sites),
        sensor_names=tuple(scols["name"]),
        eq_names=tuple(q.name for q in eqs),
        dof_floss_adr=tuple(v for v in range(nv)
                            if jnts[dof_jntid[v]].frictionloss > 0),
        has_damping=bool(any(jnts[j].damping > 0 for j in dof_jntid)),
        has_fluid=bool(opt["density"] > 0 or opt["viscosity"] > 0
                       or np.any(np.asarray(opt["wind"]) != 0)),
        dof_simple=compute_simple_dofs(
            tuple(body_parentid), tuple(body_dofnum), tuple(body_dofadr),
            tuple(j.bodyid for j in jnts), tuple(j.type for j in jnts),
            np.stack([b.ipos for b in bodies]),
            np.stack([b.iquat for b in bodies])),
        collision_pairs=ordered, ncon_max=ncon_max,
        pair_exclude=tuple(excludes), pair_explicit=tuple(explicit_pairs),
        collision_mode=opt["collision_mode"],
        **_tendons(tendons), **_actuators(acts), **_assets(meshes, hfields),
        **_cameras(cams),
        **_keyframes(keys, qpos0, nv, sum(a.dyntype != int(types.DynType.NONE) for a in acts),
                     nu, nmocap),
    )

    from mujoco_ros_pkgs_tpu_torch.core import constants
    return constants.set_constants(m)
