"""Model -> MJCF (mj_saveLastXML's role), for the port's compiled `Model`.

Counterpart of mujoco_ros_pkgs_tpu/core/mjcf_writer.py. The reference's
viewer saves the live mjModel, runtime edits included
(viewer.cpp:1671-1690); this module writes the port's compiled model back
as MJCF that the port's compiler (core/mjcf.py) reads to the same model:

- every quantity comes from the model's arrays, so service edits (gravity,
  options, geom size, type and friction, a body's mass, equality
  parameters, saved keyframes) survive save and reload;
- bodies carry an explicit `<inertial>` (no recompute from the geoms);
- meshes are inline vertex hulls: the model holds each hull in its
  principal frame, and the compiler folds a hull's centre and principal
  axes into every geom that uses it, so each mesh geom's pos and quat are
  written with the fold the compiler will apply to these vertices undone
  (and the vertices turned so that the compiler's frame is the model's:
  `_mesh_vertices`);
- height fields are inline elevation grids (already normalised);
- geoms carry their fluidshape and fluidcoef;
- sites, cameras, `<contact>` excludes and pairs, fixed and spatial
  tendons, actuators (as `<general>`, whose parameters and lengthrange are
  the compiled ones, so a muscle's probe does not run again), equalities,
  sensors and keyframes follow.

Angles are written in radians (`<compiler angle="radian">`) and every
limited flag explicitly (`autolimits="false"`).
"""

from __future__ import annotations

import io
from typing import List
from xml.sax.saxutils import quoteattr

import numpy as np

from mujoco_ros_pkgs_tpu_torch.core.assemble import OBJ_ACTUATOR, OBJ_TENDON
from mujoco_ros_pkgs_tpu_torch.core.mjcf import _Mesh, _quat_mul, _quat_rot
from mujoco_ros_pkgs_tpu_torch.core.types import (
    EqType, GeomType, JointType, Model, ObjType, SensorType, TrnType, WrapType,
)

_GEOM_NAMES = {int(t): t.name.lower() for t in GeomType}
_JNT_NAMES = {int(t): t.name.lower() for t in JointType}
_INT_NAMES = {0: "Euler", 1: "RK4", 2: "implicit", 3: "implicitfast"}
_SOLVER_NAMES = {0: "PGS", 1: "CG", 2: "Newton"}
_FLAGS = ("constraint", "equality", "frictionloss", "limit", "contact", "passive",
          "gravity", "clampctrl", "warmstart", "filterparent", "actuation", "refsafe",
          "sensor")
_DYN_NAMES = {0: "none", 1: "integrator", 2: "filter", 3: "filterexact", 4: "muscle"}
_GAIN_NAMES = {0: "fixed", 1: "affine", 2: "muscle"}
_BIAS_NAMES = {0: "none", 1: "affine", 2: "muscle"}
_OBJ_NAMES = {int(ObjType.BODY): "body", int(ObjType.XBODY): "xbody",
              int(ObjType.JOINT): "joint", int(ObjType.GEOM): "geom",
              int(ObjType.SITE): "site"}
_FRAME_SENSORS = tuple(range(int(SensorType.FRAMEPOS), int(SensorType.FRAMEANGACC) + 1))


def _f(x) -> str:
    """The shortest decimal that reads back as the same float64."""
    return repr(float(x))


def _vec(a) -> str:
    return " ".join(_f(v) for v in np.asarray(a, dtype=np.float64).ravel())


def _tri(v) -> str:
    return "true" if v else "false"


class _El:
    """A minimal XML element: attributes in insertion order, None dropped."""

    def __init__(self, tag: str, **attrs):
        self.tag = tag
        self.attrs = {k: v for k, v in attrs.items() if v is not None}
        self.children: List["_El"] = []

    def add(self, tag: str, **attrs) -> "_El":
        el = _El(tag, **attrs)
        self.children.append(el)
        return el

    def write(self, out: io.StringIO, indent: int = 0) -> None:
        pad = "  " * indent
        attrs = "".join(f" {k}={quoteattr(str(v))}" for k, v in self.attrs.items())
        if not self.children:
            out.write(f"{pad}<{self.tag}{attrs}/>\n")
            return
        out.write(f"{pad}<{self.tag}{attrs}>\n")
        for c in self.children:
            c.write(out, indent + 1)
        out.write(f"{pad}</{self.tag}>\n")


def _option(root: _El, m: Model) -> None:
    o = m.opt
    opt = root.add(
        "option", timestep=_f(o.timestep), gravity=_vec(o.gravity), wind=_vec(o.wind),
        magnetic=_vec(o.magnetic), density=_f(o.density), viscosity=_f(o.viscosity),
        impratio=_f(o.impratio), o_margin=_f(o.o_margin), o_solref=_vec(o.o_solref),
        o_solimp=_vec(o.o_solimp), integrator=_INT_NAMES[int(o.integrator)],
        cone="pyramidal" if int(o.cone) == 0 else "elliptic",
        solver=_SOLVER_NAMES[int(o.solver)], iterations=str(int(o.iterations)),
        ls_iterations=str(int(o.ls_iterations)), tolerance=_f(o.tolerance),
        ls_tolerance=_f(o.ls_tolerance),
        collision=None if m.collision_mode == "all" else m.collision_mode)
    if int(o.disableflags):
        flags = opt.add("flag")
        for bit, name in enumerate(_FLAGS):
            if int(o.disableflags) & (1 << bit):
                flags.attrs[name] = "disable"


# the rotations that turn a principal frame into another one: two axes reversed
_FLIPS = tuple(np.diag(f) for f in ((1.0, 1.0, 1.0), (1.0, -1.0, -1.0), (-1.0, 1.0, -1.0),
                                    (-1.0, -1.0, 1.0)))


def _mesh_vertices(name: str, verts: np.ndarray):
    """The vertices to write for a hull held in its principal frame, and
    the compiler's fold of them (its _Mesh): the hull turned by one of
    _FLIPS, the one whose fold turns it back, so that the compiler gives the
    same vertices again (eigh may return a principal frame with two axes
    reversed). None for the fold when no flip comes back (a hull whose
    principal moments coincide): its geoms are then written in the model's
    own pose and the compiled hull is another frame of the same shape."""
    for flip in _FLIPS:
        fold = _Mesh(name, verts @ flip)
        if np.abs(fold.verts - verts).max() <= 1e-9 * max(np.abs(verts).max(), 1.0):
            return verts @ flip, fold
    return verts, None


def _assets(root: _El, m: Model) -> list:
    """The <asset> section; returns each mesh's fold (None: see
    _mesh_vertices), which its geoms undo."""
    folds = []
    if not (m.mesh_names or m.hfield_names):
        return folds
    asset = root.add("asset")
    for i, name in enumerate(m.mesh_names):
        verts, fold = _mesh_vertices(name, m.mesh_vert[i, :m.mesh_vertnum[i]].double().numpy())
        asset.add("mesh", name=name, vertex=_vec(verts))
        folds.append(fold)
    for i, name in enumerate(m.hfield_names):
        nrow, ncol = m.hfield_nrow[i], m.hfield_ncol[i]
        asset.add("hfield", name=name, size=_vec(m.hfield_size[i]), nrow=str(nrow),
                  ncol=str(ncol), elevation=_vec(m.hfield_data[i, :nrow, :ncol]))
    return folds


def _geom(parent: _El, m: Model, g: int, folds: list) -> None:
    gt = m.geom_type[g]
    attrs = dict(
        name=m.geom_names[g] or None, type=_GEOM_NAMES[gt],
        contype=str(m.geom_contype[g]), conaffinity=str(m.geom_conaffinity[g]),
        condim=str(m.geom_condim[g]), priority=str(m.geom_priority[g]),
        friction=_vec(m.geom_friction[g]), solmix=_f(m.geom_solmix[g]),
        solref=_vec(m.geom_solref[g]), solimp=_vec(m.geom_solimp[g]),
        margin=_f(m.geom_margin[g]), gap=_f(m.geom_gap[g]), rgba=_vec(m.geom_rgba[g]))
    if m.geom_fluid_active[g]:
        attrs.update(fluidshape="ellipsoid", fluidcoef=_vec(m.geom_fluid[g, 1:6]))
    pos, quat = m.geom_pos[g].double().numpy(), m.geom_quat[g].double().numpy()
    did = m.geom_dataid[g]
    if gt == int(GeomType.MESH) and folds[did] is None:
        attrs.update(mesh=m.mesh_names[did], pos=_vec(pos), quat=_vec(quat))
    elif gt == int(GeomType.MESH):
        # the compiler sets pos' = pos + R(quat) com, quat' = quat fold.quat:
        # write the (pos, quat) whose fold gives the model's
        fold = folds[did]
        quat_attr = _quat_mul(quat, fold.quat * np.array([1.0, -1.0, -1.0, -1.0]))
        quat_attr /= np.linalg.norm(quat_attr)
        attrs.update(mesh=m.mesh_names[did], pos=_vec(pos - _quat_rot(fold.com, quat_attr)),
                     quat=_vec(quat_attr))
    elif gt == int(GeomType.HFIELD):
        attrs.update(hfield=m.hfield_names[did], pos=_vec(pos), quat=_vec(quat))
    else:
        attrs.update(pos=_vec(pos), quat=_vec(quat), size=_vec(m.geom_size[g]))
    parent.add("geom", **attrs)


def _joint(parent: _El, m: Model, j: int) -> None:
    jt = m.jnt_type[j]
    attrs = dict(name=m.jnt_names[j] or None, type=_JNT_NAMES[jt], pos=_vec(m.jnt_pos[j]))
    if jt != int(JointType.FREE):
        v, q = m.jnt_dofadr[j], m.jnt_qposadr[j]
        attrs.update(
            axis=_vec(m.jnt_axis[j]), stiffness=_f(m.jnt_stiffness[j]),
            damping=_f(m.dof_damping[v]), armature=_f(m.dof_armature[v]),
            frictionloss=_f(m.dof_frictionloss[v]), limited=_tri(m.jnt_limited[j]),
            range=_vec(m.jnt_range[j]), margin=_f(m.jnt_margin[j]),
            solreflimit=_vec(m.jnt_solref[j]), solimplimit=_vec(m.jnt_solimp[j]),
            solreffriction=_vec(m.dof_solref[v]), solimpfriction=_vec(m.dof_solimp[v]),
            actuatorfrclimited=_tri(m.jnt_actfrclimited[j]),
            actuatorfrcrange=_vec(m.jnt_actfrcrange[j]))
        if jt in (int(JointType.SLIDE), int(JointType.HINGE)):
            attrs.update(ref=_f(m.qpos0[q]), springref=_f(m.qpos_spring[q]))
    parent.add("joint", **attrs)


def _frames(el: _El, m: Model, b: int) -> None:
    """Body b's sites and cameras."""
    for s in range(m.nsite):
        if m.site_bodyid[s] == b:
            el.add("site", name=m.site_names[s] or None, pos=_vec(m.site_pos[s]),
                   quat=_vec(m.site_quat[s]))
    for c in range(m.ncam):
        if m.cam_bodyid[c] == b:
            el.add("camera", name=m.cam_names[c] or None, mode="fixed",
                   pos=_vec(m.cam_pos[c]), quat=_vec(m.cam_quat[c]),
                   fovy=_f(m.cam_fovy[c]))


def _body_tree(root: _El, m: Model, folds: list) -> None:
    children: List[List[int]] = [[] for _ in range(m.nbody)]
    for b in range(1, m.nbody):
        children[m.body_parentid[b]].append(b)

    def emit(parent: _El, b: int) -> None:
        if b == 0:
            el = parent
        else:
            el = parent.add("body", name=m.body_names[b], pos=_vec(m.body_pos[b]),
                            quat=_vec(m.body_quat[b]),
                            mocap="true" if m.body_mocapid[b] >= 0 else None)
            if float(m.body_mass[b]) > 0 or m.body_geomnum[b]:
                el.add("inertial", pos=_vec(m.body_ipos[b]), quat=_vec(m.body_iquat[b]),
                       mass=_f(m.body_mass[b]), diaginertia=_vec(m.body_inertia[b]))
            for j in range(m.body_jntadr[b], m.body_jntadr[b] + m.body_jntnum[b]):
                _joint(el, m, j)
        for g in range(m.body_geomadr[b], m.body_geomadr[b] + m.body_geomnum[b]):
            _geom(el, m, g, folds)
        _frames(el, m, b)
        for c in children[b]:
            emit(el, c)

    emit(root.add("worldbody"), 0)


def _contact(root: _El, m: Model) -> None:
    if not (m.pair_exclude or m.pair_explicit):
        return
    ce = root.add("contact")
    for b1, b2 in m.pair_exclude:
        ce.add("exclude", body1=m.body_names[b1], body2=m.body_names[b2])
    for g1, g2 in m.pair_explicit:
        ce.add("pair", geom1=m.geom_names[g1], geom2=m.geom_names[g2])


def _tendons(root: _El, m: Model) -> None:
    if not m.ntendon:
        return
    te = root.add("tendon")
    for t in range(m.ntendon):
        spring = m.tendon_lengthspring[t].double().numpy()
        wraps = range(m.tendon_adr[t], m.tendon_adr[t] + m.tendon_num[t])
        fixed = all(m.wrap_type[w] == int(WrapType.JOINT) for w in wraps)
        el = te.add(
            "fixed" if fixed else "spatial", name=m.tendon_names[t] or None,
            limited=_tri(m.tendon_limited[t]),
            range=_vec(m.tendon_range[t]), solreflimit=_vec(m.tendon_solref_lim[t]),
            solimplimit=_vec(m.tendon_solimp_lim[t]), margin=_f(m.tendon_margin[t]),
            stiffness=_f(m.tendon_stiffness[t]), damping=_f(m.tendon_damping[t]),
            frictionloss=_f(m.tendon_frictionloss[t]),
            springlength=None if (spring == -1.0).all() else _vec(spring))
        for w in wraps:
            kind = m.wrap_type[w]
            if kind == int(WrapType.JOINT):
                el.add("joint", joint=m.jnt_names[m.wrap_objid[w]], coef=_f(m.wrap_prm[w]))
            elif kind == int(WrapType.SITE):
                el.add("site", site=m.site_names[m.wrap_objid[w]])
            elif kind == int(WrapType.PULLEY):
                el.add("pulley", divisor=_f(m.wrap_divisor[w]))
            else:
                side = m.wrap_sidesite[w]
                el.add("geom", geom=m.geom_names[m.wrap_objid[w]],
                       sidesite=m.site_names[side] if side >= 0 else None)


def _actuators(root: _El, m: Model) -> None:
    if not m.nu:
        return
    ae = root.add("actuator")
    for i in range(m.nu):
        trn, tid = m.actuator_trntype[i], m.actuator_trnid[i][0]
        attrs = dict(
            name=m.actuator_names[i] or None, dyntype=_DYN_NAMES[m.actuator_dyntype[i]],
            gaintype=_GAIN_NAMES[m.actuator_gaintype[i]],
            biastype=_BIAS_NAMES[m.actuator_biastype[i]],
            dynprm=_vec(m.actuator_dynprm[i]), gainprm=_vec(m.actuator_gainprm[i]),
            biasprm=_vec(m.actuator_biasprm[i]), gear=_vec(m.actuator_gear[i]),
            ctrllimited=_tri(m.actuator_ctrllimited[i]),
            ctrlrange=_vec(m.actuator_ctrlrange[i]),
            forcelimited=_tri(m.actuator_forcelimited[i]),
            forcerange=_vec(m.actuator_forcerange[i]),
            actlimited=_tri(m.actuator_actlimited[i]), actrange=_vec(m.actuator_actrange[i]),
            lengthrange=_vec(m.actuator_lengthrange[i]))
        if trn in (int(TrnType.JOINT), int(TrnType.JOINTINPARENT)):
            attrs["joint"] = m.jnt_names[tid]
        elif trn == int(TrnType.TENDON):
            attrs["tendon"] = m.tendon_names[tid]
        else:
            attrs["site"] = m.site_names[tid]
        ae.add("general", **attrs)


def _equalities(root: _El, m: Model) -> None:
    if not m.neq:
        return
    eq = root.add("equality")
    data = m.eq_data.double().numpy()
    for e in range(m.neq):
        et, o1, o2 = m.eq_type[e], m.eq_obj1id[e], m.eq_obj2id[e]
        common = dict(name=m.eq_names[e] or None, active=_tri(m.eq_active0[e]),
                      solref=_vec(m.eq_solref[e]), solimp=_vec(m.eq_solimp[e]))
        if et == int(EqType.CONNECT):
            eq.add("connect", body1=m.body_names[o1],
                   body2=m.body_names[o2] if o2 else None, anchor=_vec(data[e, 0:3]),
                   **common)
        elif et == int(EqType.WELD):
            eq.add("weld", body1=m.body_names[o1], body2=m.body_names[o2] if o2 else None,
                   anchor=_vec(data[e, 0:3]), relpose=_vec(data[e, 3:10]),
                   torquescale=_f(data[e, 10]), **common)
        elif et == int(EqType.JOINT):
            eq.add("joint", joint1=m.jnt_names[o1],
                   joint2=m.jnt_names[o2] if o2 >= 0 else None,
                   polycoef=_vec(data[e, 0:5]), **common)
        else:
            eq.add("tendon", tendon1=m.tendon_names[o1],
                   tendon2=m.tendon_names[o2] if o2 >= 0 else None,
                   polycoef=_vec(data[e, 0:5]), **common)


def _sensors(root: _El, m: Model) -> None:
    if not m.nsensor:
        return
    se = root.add("sensor")
    names = {int(ObjType.BODY): m.body_names, int(ObjType.XBODY): m.body_names,
             int(ObjType.JOINT): m.jnt_names, int(ObjType.GEOM): m.geom_names,
             int(ObjType.SITE): m.site_names, OBJ_TENDON: m.tendon_names,
             OBJ_ACTUATOR: m.actuator_names}
    for s in range(m.nsensor):
        st, ot, oid = m.sensor_type[s], m.sensor_objtype[s], m.sensor_objid[s]
        attrs = dict(name=m.sensor_names[s] or None, cutoff=_f(m.sensor_cutoff[s]),
                     noise=_f(m.sensor_noise[s]))
        if st in _FRAME_SENSORS:
            attrs.update(objtype=_OBJ_NAMES[ot], objname=names[ot][oid])
        elif oid >= 0:
            key = {int(ObjType.XBODY): "body", OBJ_TENDON: "tendon",
                   OBJ_ACTUATOR: "actuator"}.get(ot) or _OBJ_NAMES[ot]
            attrs[key] = names[ot][oid]
        rt, rid = m.sensor_reftype[s], m.sensor_refid[s]
        if rid >= 0:
            attrs.update(reftype=_OBJ_NAMES[rt], refname=names[rt][rid])
        se.add(SensorType(st).name.lower(), **attrs)


def _keyframes(root: _El, m: Model) -> None:
    if not m.nkey:
        return
    ke = root.add("keyframe")
    for k in range(m.nkey):
        ke.add("key", name=m.key_names[k] or None, time=_f(m.key_time[k]),
               qpos=_vec(m.key_qpos[k]), qvel=_vec(m.key_qvel[k]),
               act=_vec(m.key_act[k]) if m.na else None,
               ctrl=_vec(m.key_ctrl[k]) if m.nu else None,
               mpos=_vec(m.key_mpos[k]) if m.nmocap else None,
               mquat=_vec(m.key_mquat[k]) if m.nmocap else None)


def model_to_xml(m: Model) -> str:
    """MJCF text of the compiled model m (any device and dtype; written from
    its values as float64)."""
    m = m.to("cpu", None)
    root = _El("mujoco", model=m.name or "model")
    root.add("compiler", angle="radian", autolimits="false")
    _option(root, m)
    folds = _assets(root, m)
    _body_tree(root, m, folds)
    _contact(root, m)
    _tendons(root, m)
    _actuators(root, m)
    _equalities(root, m)
    _sensors(root, m)
    _keyframes(root, m)
    out = io.StringIO()
    root.write(out)
    return out.getvalue()
