"""MJCF parser + model compiler (numpy), the subset the torch port runs.

Counterpart of mujoco_ros_pkgs_tpu/core/mjcf.py, kept numpy-for-numpy so the
two compile a model to the same numbers. Supported elements:

- `<option>` (with `<flag>`), `<compiler>` (angle, eulerseq, autolimits,
  inertiafromgeom, boundmass, boundinertia), `<default>` classes;
- `<worldbody>` static geoms and sites and nested `<body>` with `<joint>`,
  `<freejoint>`, `<site>` and `<inertial>`; `mocap="true"` on a joint-less
  child of the world;
- geom types plane, sphere, capsule, ellipsoid, cylinder and box (a
  capsule or a cylinder also by `fromto`), with mass or
  density, friction, condim, priority, solmix, solref, solimp, margin, gap,
  contype and conaffinity;
- sites: name, pos, orientation (quat, axisangle, euler, zaxis, xyaxes)
  or `fromto`, `<default><site>` classes;
- `<tendon>` with `<fixed>` tendons (joint entries with coef; limited,
  range, margin, solreflimit, solimplimit, stiffness, damping,
  frictionloss, springlength) and their `<default>` classes;
- `<actuator>` with `<motor>`, `<position>` (kp, kv), `<velocity>` (kv),
  `<intvelocity>` (kp; an integrator activation), `<damper>` (kv; an
  affine gain) and `<general>` (dyntype none / integrator / filter /
  filterexact, gaintype fixed / affine, biastype none / affine, dynprm,
  gainprm, biasprm) on a joint (any type), tendon or site transmission
  (gear, ctrlrange, forcerange, actrange and their limited flags), and
  their `<default>` classes;
- `<equality>` with `<connect>`, `<weld>`, `<joint>` and `<tendon>`
  (solref, solimp, active, anchor, relpose, torquescale, polycoef),
  `<default><equality>`;
- `<sensor>` of the types in core/assemble.SENSOR_DIM, with `cutoff` and
  `noise`.

Anything else (cameras, muscles, spatial tendons, other sensor types,
contact pairs, assets, mesh and height-field geoms, fluid shapes) raises
ValueError naming the feature, rather than being dropped silently.
"""

from __future__ import annotations

import dataclasses
import itertools
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from mujoco_ros_pkgs_tpu_torch.core import types
from mujoco_ros_pkgs_tpu_torch.core.assemble import SENSOR_DIM, assemble
from mujoco_ros_pkgs_tpu_torch.core.types import (
    BiasType, DynType, GainType, GeomType, IntegratorType, JointType, SensorType,
    TrnType,
)

_SOLREF = (0.02, 1.0)
_SOLIMP = (0.9, 0.95, 0.001, 0.5, 2.0)

_TOP_LEVEL = ("option", "compiler", "default", "worldbody", "tendon", "actuator",
              "sensor", "equality", "size", "visual", "statistic")
_ACTUATORS = ("motor", "position", "velocity", "intvelocity", "damper", "general")
_DEFAULT_TAGS = ("joint", "geom", "site", "tendon", "equality") + _ACTUATORS
_EQUALITIES = ("connect", "weld", "joint", "tendon")
_DYNTYPES = {"none": DynType.NONE, "integrator": DynType.INTEGRATOR,
             "filter": DynType.FILTER, "filterexact": DynType.FILTEREXACT}
_GAINTYPES = {"fixed": GainType.FIXED, "affine": GainType.AFFINE}
_BIASTYPES = {"none": BiasType.NONE, "affine": BiasType.AFFINE}
_GEOM_TYPES = {"plane": GeomType.PLANE, "sphere": GeomType.SPHERE,
               "capsule": GeomType.CAPSULE, "ellipsoid": GeomType.ELLIPSOID,
               "cylinder": GeomType.CYLINDER, "box": GeomType.BOX}
_JOINT_TYPES = {"free": JointType.FREE, "ball": JointType.BALL,
                "slide": JointType.SLIDE, "hinge": JointType.HINGE}


# ---------------------------------------------------------------------------
# parsing helpers
# ---------------------------------------------------------------------------

def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.split()], dtype=np.float64)


def _attr_f(e: ET.Element, name: str, default=None, n: Optional[int] = None):
    """Float-array attribute; partial values overlay the default prefix-wise
    (size="0.05" -> (0.05, 0, 0), friction="1" -> (1, 0.005, 0.0001))."""
    v = e.get(name)
    if v is None:
        if default is None:
            return None
        out = np.array(default, dtype=np.float64)
        if n is not None and out.size < n:
            out = np.concatenate([out, np.zeros(n - out.size)])
        return out
    parsed = _floats(v)
    if n is None:
        return parsed
    base = np.array(default, dtype=np.float64) if default is not None else np.zeros(n)
    if base.size < n:
        base = np.concatenate([base, np.zeros(n - base.size)])
    out = base.copy()
    out[: min(parsed.size, n)] = parsed[:n]
    return out


def _attr_b(e: ET.Element, name: str, default: bool) -> bool:
    v = e.get(name)
    if v is None:
        return default
    return v.lower() in ("true", "1")


_TRISTATE = {"true": 1, "1": 1, "false": 0, "0": 0, "auto": 2}


def _choice(e: ET.Element, name: str, table: dict, default: str):
    """Keyword attribute looked up in `table`; ValueError naming it if unknown."""
    v = e.get(name, default)
    if v not in table:
        raise ValueError(f"<{e.tag}> {name}='{v}' is not one of {sorted(table)}")
    return table[v]


def _attr_tri(e: ET.Element, name: str, default: int = 2) -> int:
    v = e.get(name)
    if v is None:
        return default
    if v.lower() not in _TRISTATE:
        raise ValueError(f"<{e.tag}> {name}='{v}' is not one of {sorted(_TRISTATE)}")
    return _TRISTATE[v.lower()]


class _Compiler:
    """Parsed <compiler> settings."""

    def __init__(self, e: Optional[ET.Element]):
        self.angle = "degree"
        self.eulerseq = "xyz"
        self.autolimits = True
        self.inertiafromgeom = "auto"
        self.boundmass = 0.0
        self.boundinertia = 0.0
        if e is not None:
            self.angle = e.get("angle", self.angle)
            self.eulerseq = e.get("eulerseq", self.eulerseq)
            self.autolimits = _attr_b(e, "autolimits", self.autolimits)
            self.inertiafromgeom = e.get("inertiafromgeom", self.inertiafromgeom)
            self.boundmass = float(e.get("boundmass", "0"))
            self.boundinertia = float(e.get("boundinertia", "0"))
            if _attr_b(e, "balanceinertia", False):
                raise ValueError("compiler balanceinertia is not supported")

    def ang(self, x):
        if self.angle == "degree":
            return np.asarray(x) * np.pi / 180.0
        return np.asarray(x)


# ---------------------------------------------------------------------------
# quaternion helpers (host-side numpy; conventions match ops/math.py)
# ---------------------------------------------------------------------------

def _quat_mul(u, v):
    return np.array([
        u[0] * v[0] - u[1] * v[1] - u[2] * v[2] - u[3] * v[3],
        u[0] * v[1] + u[1] * v[0] + u[2] * v[3] - u[3] * v[2],
        u[0] * v[2] - u[1] * v[3] + u[2] * v[0] + u[3] * v[1],
        u[0] * v[3] + u[1] * v[2] - u[2] * v[1] + u[3] * v[0],
    ])


def _quat_rot(v, q):
    u, w = q[1:4], q[0]
    c = np.cross(u, v)
    return v + 2.0 * (w * c + np.cross(u, c))


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _mat_to_quat(m):
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                      (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                      0.25 * s, (m[1, 2] + m[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                      (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    q = q / np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def _axis_angle_quat(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-15:
        return np.array([1.0, 0, 0, 0])
    axis = axis / n
    return np.concatenate([[np.cos(angle / 2)], axis * np.sin(angle / 2)])


def _principal_inertia(full: np.ndarray):
    """Diagonalize a full 3x3 inertia with the minimal rotation from the input
    frame (libmujoco keeps geom-frame axis order). Returns (diag, quat)."""
    w, V = np.linalg.eigh(full)
    best, best_score = None, -np.inf
    for perm in itertools.permutations(range(3)):
        score = sum(abs(V[i, perm[i]]) for i in range(3))
        if score > best_score:
            best_score, best = score, perm
    V = V[:, list(best)]
    w = w[list(best)]
    for i in range(3):
        if V[i, i] < 0:
            V[:, i] *= -1
    if np.linalg.det(V) < 0:
        i = int(np.argmin(np.abs(np.diag(V))))
        V[:, i] *= -1
    return w, _mat_to_quat(V)


def _z2quat(vec: np.ndarray, degenerate_identity: bool = True) -> np.ndarray:
    """Minimal rotation taking +z to vec (mjuu_z2quat semantics)."""
    z = vec / np.linalg.norm(vec)
    axis = np.cross([0.0, 0, 1], z)
    s = np.linalg.norm(axis)
    if s < 1e-10:
        if degenerate_identity or z[2] > 0:
            return np.array([1.0, 0, 0, 0])
        return _axis_angle_quat(np.array([1.0, 0, 0]), np.pi)
    return _axis_angle_quat(axis, np.arctan2(s, z[2]))


def _orientation(e: ET.Element, comp: _Compiler) -> np.ndarray:
    """Frame orientation: quat | axisangle | euler | zaxis | xyaxes."""
    if e.get("axisangle") is not None:
        v = _floats(e.get("axisangle"))
        return _axis_angle_quat(v[:3], float(comp.ang(v[3])))
    if e.get("euler") is not None:
        eul = comp.ang(_floats(e.get("euler")))
        q = np.array([1.0, 0, 0, 0])
        axes = {"x": [1.0, 0, 0], "y": [0, 1.0, 0], "z": [0, 0, 1.0]}
        for i, ax in enumerate(comp.eulerseq):
            qi = _axis_angle_quat(axes[ax.lower()], eul[i])
            q = _quat_mul(q, qi) if ax.islower() else _quat_mul(qi, q)
        return q
    if e.get("zaxis") is not None:
        return _z2quat(_floats(e.get("zaxis")), degenerate_identity=False)
    if e.get("xyaxes") is not None:
        v = _floats(e.get("xyaxes"))
        x = v[:3] / np.linalg.norm(v[:3])
        y = v[3:6] - x * np.dot(x, v[3:6])
        y = y / np.linalg.norm(y)
        z = np.cross(x, y)
        return _mat_to_quat(np.stack([x, y, z], axis=1))
    q = _attr_f(e, "quat", [1.0, 0, 0, 0])
    return q / np.linalg.norm(q)


# ---------------------------------------------------------------------------
# defaults tree
# ---------------------------------------------------------------------------

def _collect_defaults(root: ET.Element) -> Dict[str, Dict[str, Dict[str, str]]]:
    """Flatten the <default> class tree into {class: {elemtype: {attr: val}}}."""
    out: Dict[str, Dict[str, Dict[str, str]]] = {}

    def walk(e: ET.Element, inherited: Dict[str, Dict[str, str]]):
        cls = e.get("class", "main")
        merged = {k: dict(v) for k, v in inherited.items()}
        for child in e:
            if child.tag in _DEFAULT_TAGS:
                merged.setdefault(child.tag, {}).update(child.attrib)
            elif child.tag != "default":
                raise ValueError(f"<default> for <{child.tag}> is not supported")
        out[cls] = merged
        for child in e:
            if child.tag == "default":
                walk(child, merged)

    for e in root:
        if e.tag == "default":
            walk(e, {})
    out.setdefault("main", {})
    return out


def _apply_defaults(e: ET.Element, defaults: Dict[str, Dict[str, str]],
                    elemtype: str) -> ET.Element:
    merged = dict(defaults.get(elemtype, {}))
    merged.pop("class", None)
    merged.update(e.attrib)
    clone = ET.Element(e.tag, merged)
    clone.extend(list(e))
    return clone


# ---------------------------------------------------------------------------
# geom inertia
# ---------------------------------------------------------------------------

def _geom_volume(gtype: int, size: np.ndarray) -> float:
    r = size[0]
    if gtype == GeomType.SPHERE:
        return 4.0 / 3.0 * np.pi * r ** 3
    if gtype == GeomType.CAPSULE:
        return 4.0 / 3.0 * np.pi * r ** 3 + 2.0 * size[1] * np.pi * r * r
    if gtype == GeomType.CYLINDER:
        return 2.0 * size[1] * np.pi * r * r
    if gtype == GeomType.ELLIPSOID:
        return 4.0 / 3.0 * np.pi * size[0] * size[1] * size[2]
    if gtype == GeomType.BOX:
        return 8.0 * size[0] * size[1] * size[2]
    return 0.0


def _geom_inertia_diag(gtype: int, size: np.ndarray, mass: float) -> np.ndarray:
    """Diagonal rotational inertia of a geom about its own frame."""
    r = size[0]
    if gtype == GeomType.SPHERE:
        i = 0.4 * mass * r * r
        return np.array([i, i, i])
    if gtype == GeomType.CAPSULE:
        hl = size[1]
        v_sph = 4.0 / 3.0 * np.pi * r ** 3
        v_cyl = 2.0 * hl * np.pi * r * r
        ms = mass * v_sph / (v_sph + v_cyl)
        mc = mass - ms
        iz = 0.4 * ms * r * r + 0.5 * mc * r * r
        ixy = (mc * (3 * r * r + 4 * hl * hl) / 12.0
               + ms * (0.4 * r * r + hl * hl + 0.75 * hl * r))
        return np.array([ixy, ixy, iz])
    if gtype == GeomType.CYLINDER:
        hl = size[1]
        iz = 0.5 * mass * r * r
        ixy = mass * (3 * r * r + 4 * hl * hl) / 12.0
        return np.array([ixy, ixy, iz])
    if gtype == GeomType.ELLIPSOID:
        a, b, c = size
        return mass / 5.0 * np.array([b * b + c * c, a * a + c * c, a * a + b * b])
    if gtype == GeomType.BOX:
        sx, sy, sz = size
        return mass / 3.0 * np.array([sy * sy + sz * sz, sx * sx + sz * sz,
                                      sx * sx + sy * sy])
    return np.zeros(3)


def _geom_rbound(gtype: int, size: np.ndarray) -> float:
    if gtype == GeomType.PLANE:
        return 0.0
    if gtype == GeomType.SPHERE:
        return size[0]
    if gtype == GeomType.CAPSULE:
        return size[0] + size[1]
    if gtype == GeomType.CYLINDER:
        return float(np.sqrt(size[0] ** 2 + size[1] ** 2))
    if gtype == GeomType.ELLIPSOID:
        return float(np.max(size))
    return float(np.linalg.norm(size))     # box


class _Body:
    def __init__(self):
        self.name = ""
        self.parentid = 0
        self.pos = np.zeros(3)
        self.quat = np.array([1.0, 0, 0, 0])
        self.explicit_inertial = False
        self.ipos = np.zeros(3)
        self.iquat = np.array([1.0, 0, 0, 0])
        self.mass = 0.0
        self.inertia = np.zeros(3)
        self.mocap = False
        self.joints: List[int] = []
        self.geoms: List[int] = []


class _Spec:
    """One parsed joint or geom (attributes set by the parser)."""


# ---------------------------------------------------------------------------


def load_model(path: str, dtype=None, pair_topk: int = 0,
               con_topk: int = 0) -> types.Model:
    """Load and compile an MJCF file (mj_loadXML analogue)."""
    with open(path) as f:
        xml = f.read()
    return load_model_from_string(xml, dtype=dtype, pair_topk=pair_topk,
                                  con_topk=con_topk)


def load_model_from_string(xml: str, dtype=None, pair_topk: int = 0,
                           con_topk: int = 0) -> types.Model:
    """Compile an MJCF string to a float64 CPU Model (cast with `dtype`),
    with the broadphase (pair_topk) and active-contact (con_topk)
    compaction capacities set (types.Model; 0 = off)."""
    root = ET.fromstring(xml)
    if root.tag != "mujoco":
        raise ValueError(f"expected <mujoco> root, got <{root.tag}>")
    for child in root:
        if child.tag not in _TOP_LEVEL:
            raise ValueError(f"<{child.tag}> is not supported by the torch port")
    m = dataclasses.replace(_compile(root), pair_topk=int(pair_topk),
                            con_topk=int(con_topk))
    return m.to(dtype=dtype) if dtype is not None else m


def _parse_option(oe: Optional[ET.Element]) -> dict:
    opt = dict(timestep=0.002, gravity=np.array([0.0, 0, -9.81]),
               wind=np.zeros(3), magnetic=np.array([0.0, -0.5, 0.0]),
               density=0.0, viscosity=0.0, impratio=1.0, o_margin=0.0,
               o_solref=np.array(_SOLREF), o_solimp=np.array(_SOLIMP),
               integrator=int(IntegratorType.EULER),
               cone=int(types.ConeType.PYRAMIDAL),
               solver=int(types.SolverType.NEWTON), iterations=100,
               ls_iterations=50, tolerance=1e-8, ls_tolerance=0.01,
               disableflags=0, collision_mode="all")
    if oe is None:
        return opt
    opt.update(
        timestep=float(oe.get("timestep", "0.002")),
        gravity=_attr_f(oe, "gravity", opt["gravity"]),
        wind=_attr_f(oe, "wind", opt["wind"]),
        magnetic=_attr_f(oe, "magnetic", opt["magnetic"]),
        density=float(oe.get("density", "0")),
        viscosity=float(oe.get("viscosity", "0")),
        impratio=float(oe.get("impratio", "1")),
        o_margin=float(oe.get("o_margin", "0")),
        o_solref=_attr_f(oe, "o_solref", opt["o_solref"]),
        o_solimp=_attr_f(oe, "o_solimp", opt["o_solimp"]),
        integrator=_choice(oe, "integrator", {"Euler": 0, "RK4": 1, "implicit": 2,
                                              "implicitfast": 3}, "Euler"),
        cone=_choice(oe, "cone", {"pyramidal": 0, "elliptic": 1}, "pyramidal"),
        solver=_choice(oe, "solver", {"PGS": 0, "CG": 1, "Newton": 2}, "Newton"),
        iterations=int(oe.get("iterations", "100")),
        ls_iterations=int(oe.get("ls_iterations", "50")),
        tolerance=float(oe.get("tolerance", "1e-8")),
        ls_tolerance=float(oe.get("ls_tolerance", "0.01")),
        collision_mode=oe.get("collision", "all"))
    fe = oe.find("flag")
    if fe is not None:
        names = {"constraint": 1 << 0, "equality": 1 << 1,
                 "frictionloss": 1 << 2, "limit": 1 << 3, "contact": 1 << 4,
                 "passive": 1 << 5, "gravity": 1 << 6, "clampctrl": 1 << 7,
                 "warmstart": 1 << 8, "filterparent": 1 << 9,
                 "actuation": 1 << 10, "refsafe": 1 << 11, "sensor": 1 << 12}
        for k, bit in names.items():
            if fe.get(k, "enable") == "disable":
                opt["disableflags"] |= bit
    return opt


def _compile(root: ET.Element) -> types.Model:
    comp = _Compiler(root.find("compiler"))
    defaults_tree = _collect_defaults(root)
    opt = _parse_option(root.find("option"))

    bodies: List[_Body] = []
    jnts: List[_Spec] = []
    geoms: List[_Spec] = []
    sites: List[_Spec] = []
    world = _Body()
    world.name = "world"
    bodies.append(world)

    def limited(e, flag, rng):
        """A limited flag (true / false / auto): auto is true where
        autolimits is on and the range is given."""
        v = _attr_tri(e, flag, 2)
        return (1 if (comp.autolimits and e.get(rng) is not None) else 0) if v == 2 else v

    def parse_joint(e, bclass, bodyid):
        if e.tag != "freejoint":
            # <freejoint> takes only name/group: joint defaults do not apply
            e = _apply_defaults(e, defaults_tree.get(bclass, defaults_tree["main"]),
                                "joint")
        j = _Spec()
        j.name = e.get("name", "")
        if e.tag == "freejoint":
            j.type = int(JointType.FREE)
        else:
            j.type = int(_choice(e, "type", _JOINT_TYPES, "hinge"))
        j.bodyid = bodyid
        j.pos = _attr_f(e, "pos", [0, 0, 0])
        j.axis = _attr_f(e, "axis", [0, 0, 1])
        j.axis = j.axis / np.linalg.norm(j.axis)
        j.stiffness = float(e.get("stiffness", "0"))
        rng = _attr_f(e, "range", [0, 0])
        if j.type in (int(JointType.HINGE), int(JointType.BALL)):
            rng = comp.ang(rng)
        j.range = rng
        j.limited = limited(e, "limited", "range")
        j.actfrcrange = _attr_f(e, "actuatorfrcrange", [0, 0])
        j.actfrclimited = limited(e, "actuatorfrclimited", "actuatorfrcrange")
        j.solref = _attr_f(e, "solreflimit", _SOLREF)
        j.solimp = _attr_f(e, "solimplimit", _SOLIMP)
        j.solref_fri = _attr_f(e, "solreffriction", _SOLREF)
        j.solimp_fri = _attr_f(e, "solimpfriction", _SOLIMP)
        j.margin = float(e.get("margin", "0"))
        ref = float(e.get("ref", "0"))
        springref = float(e.get("springref", "0"))
        if j.type == int(JointType.HINGE):
            ref, springref = float(comp.ang(ref)), float(comp.ang(springref))
        j.ref, j.springref = ref, springref
        j.armature = float(e.get("armature", "0"))
        j.damping = float(e.get("damping", "0"))
        j.frictionloss = float(e.get("frictionloss", "0"))
        jnts.append(j)
        return len(jnts) - 1

    def parse_geom(e, bclass, bodyid):
        e = _apply_defaults(e, defaults_tree.get(bclass, defaults_tree["main"]),
                            "geom")
        g = _Spec()
        g.name = e.get("name", "")
        gt = e.get("type", "sphere")
        if gt not in _GEOM_TYPES:
            raise ValueError(f"geom '{g.name}': type '{gt}' is not supported "
                             f"by the torch port")
        for attr in ("mesh", "hfield"):
            if e.get(attr):
                raise ValueError(f"geom '{g.name}': {attr} geoms are not supported")
        if e.get("fluidshape", "none") != "none":
            raise ValueError(f"geom '{g.name}': fluidshape is not supported")
        g.type = int(_GEOM_TYPES[gt])
        g.bodyid = bodyid
        g.contype = int(e.get("contype", "1"))
        g.conaffinity = int(e.get("conaffinity", "1"))
        g.condim = int(e.get("condim", "3"))
        g.priority = int(e.get("priority", "0"))
        g.size = _attr_f(e, "size", [0, 0, 0], n=3)
        g.friction = _attr_f(e, "friction", [1.0, 0.005, 0.0001], n=3)
        g.solmix = float(e.get("solmix", "1"))
        g.solref = _attr_f(e, "solref", _SOLREF)
        g.solimp = _attr_f(e, "solimp", _SOLIMP)
        g.margin = float(e.get("margin", "0"))
        g.gap = float(e.get("gap", "0"))
        g.pos = _attr_f(e, "pos", [0, 0, 0])
        g.quat = _orientation(e, comp)
        if e.get("fromto") is not None:
            ft = _floats(e.get("fromto"))
            a, b = ft[:3], ft[3:]
            g.pos = 0.5 * (a + b)
            g.quat = _z2quat(b - a)
            g.size[1] = np.linalg.norm(b - a) / 2.0
        vol = _geom_volume(g.type, g.size)
        g.mass = (float(e.get("mass")) if e.get("mass") is not None
                  else float(e.get("density", "1000")) * vol)
        g.rbound = _geom_rbound(g.type, g.size)
        geoms.append(g)
        return len(geoms) - 1

    def parse_site(e, bclass, bodyid):
        e = _apply_defaults(e, defaults_tree.get(bclass, defaults_tree["main"]),
                            "site")
        st = _Spec()
        st.name = e.get("name", "")
        st.bodyid = bodyid
        st.pos = _attr_f(e, "pos", [0, 0, 0])
        st.quat = _orientation(e, comp)
        if e.get("fromto") is not None:
            ft = _floats(e.get("fromto"))
            a, b = ft[:3], ft[3:]
            st.pos = 0.5 * (a + b)
            st.quat = _z2quat(b - a)
        sites.append(st)

    def parse_tendon(e, i):
        """A <fixed> tendon: its joint entries (joint id, coef) and its
        limit, spring, damping and friction-loss parameters, as the JAX
        compiler reads them; a <spatial> tendon raises."""
        name = e.get("name", "") or f"#{i}"
        if e.tag != "fixed":
            raise ValueError(f"tendon '{name}': <{e.tag}> tendons are not supported by "
                             f"the torch port (only <fixed>)")
        e = _apply_defaults(e, defaults_tree.get(e.get("class", "main"),
                                                 defaults_tree["main"]), "tendon")
        t = _Spec()
        t.name = e.get("name", "")
        jnt_names = [j.name for j in jnts]
        t.entries = []
        for we in e:
            if we.tag != "joint" or we.get("joint") not in jnt_names or we.get("coef") is None:
                raise ValueError(f"tendon '{name}': a fixed tendon's entries are "
                                 f"<joint joint=... coef=...> of named joints, got "
                                 f"<{we.tag} {we.attrib}>")
            t.entries.append((jnt_names.index(we.get("joint")), float(we.get("coef"))))
        t.limited = limited(e, "limited", "range")
        t.range = _attr_f(e, "range", [0, 0])
        t.solref = _attr_f(e, "solreflimit", _SOLREF)
        t.solimp = _attr_f(e, "solimplimit", _SOLIMP)
        t.margin = float(e.get("margin", "0"))
        t.stiffness = float(e.get("stiffness", "0"))
        t.damping = float(e.get("damping", "0"))
        t.frictionloss = float(e.get("frictionloss", "0"))
        t.lengthspring = np.array([-1.0, -1.0])
        if e.get("springlength") is not None:
            sl = _floats(e.get("springlength"))
            t.lengthspring = sl if sl.size == 2 else np.array([sl[0], sl[0]])
        return t

    def parse_actuator(e, i):
        """An actuator as the JAX package compiles it: <motor> (gain 1 on
        ctrl, no bias), <position> (gain kp, bias -kp length - kv
        velocity), <velocity> (gain kv, bias -kv velocity), <intvelocity>
        (an integrator activation, gain kp, bias -kp length), <damper>
        (affine gain -kv velocity) or <general>, on a joint, tendon or site
        transmission; muscles raise."""
        name = e.get("name", "") or f"#{i}"
        if e.tag not in _ACTUATORS:
            raise ValueError(f"actuator '{name}': <{e.tag}> is not supported by the "
                             f"torch port (only {', '.join(f'<{t}>' for t in _ACTUATORS)})")
        tag = e.tag
        e = _apply_defaults(e, defaults_tree.get(e.get("class", "main"),
                                                 defaults_tree["main"]), tag)
        a = _Spec()
        a.name = e.get("name", "")
        a.gear = _attr_f(e, "gear", [1, 0, 0, 0, 0, 0], n=6)
        a.dynprm, a.gainprm, a.biasprm = np.zeros(10), np.zeros(10), np.zeros(10)
        a.dynprm[0] = a.gainprm[0] = 1.0
        a.dyntype, a.gaintype, a.biastype = (int(DynType.NONE), int(GainType.FIXED),
                                             int(BiasType.NONE))
        if tag == "position":
            kp, kv = float(e.get("kp", "1")), float(e.get("kv", "0"))
            a.gainprm[0], a.biastype = kp, int(BiasType.AFFINE)
            a.biasprm[1], a.biasprm[2] = -kp, -kv
        elif tag == "velocity":
            kv = float(e.get("kv", "1"))
            a.gainprm[0], a.biastype = kv, int(BiasType.AFFINE)
            a.biasprm[2] = -kv
        elif tag == "intvelocity":
            kp = float(e.get("kp", "1"))
            a.gainprm[0], a.biastype, a.dyntype = kp, int(BiasType.AFFINE), int(DynType.INTEGRATOR)
            a.biasprm[1] = -kp
        elif tag == "damper":
            a.gaintype = int(GainType.AFFINE)
            a.gainprm[:3] = [0.0, 0.0, -float(e.get("kv", "1"))]
        elif tag == "general":
            for attr, table, key in (("dyntype", _DYNTYPES, "none"),
                                     ("gaintype", _GAINTYPES, "fixed"),
                                     ("biastype", _BIASTYPES, "none")):
                if e.get(attr) == "muscle":
                    raise ValueError(f"actuator '{name}': {attr} muscle is not supported "
                                     f"by the torch port")
                setattr(a, attr, int(_choice(e, attr, table, key)))
            for attr in ("dynprm", "gainprm", "biasprm"):
                if e.get(attr) is not None:
                    v = _floats(e.get(attr))
                    getattr(a, attr)[:v.size] = v[:10]
        trn = [(k, e.get(k)) for k in ("joint", "tendon", "site") if e.get(k) is not None]
        if not trn:
            raise ValueError(f"actuator '{name}': needs a joint, tendon or site transmission")
        kind, target = trn[0]
        names = {"joint": [j.name for j in jnts], "tendon": [t.name for t in tendons],
                 "site": [st.name for st in sites]}[kind]
        if target not in names:
            raise ValueError(f"actuator '{name}': unknown {kind} '{target}'")
        a.trntype = int({"joint": TrnType.JOINT, "tendon": TrnType.TENDON,
                         "site": TrnType.SITE}[kind])
        a.trnid = (names.index(target), -1)
        a.ctrlrange = _attr_f(e, "ctrlrange", [0, 0])
        a.forcerange = _attr_f(e, "forcerange", [0, 0])
        a.actrange = _attr_f(e, "actrange", [0, 0])
        for flag, rng in (("ctrllimited", "ctrlrange"), ("forcelimited", "forcerange"),
                          ("actlimited", "actrange")):
            setattr(a, flag, limited(e, flag, rng))
        return a

    def parse_equality(e, i):
        """A <connect>, <weld>, <joint> or <tendon> equality with its
        objects resolved to ids; core/assemble fills eq_data from the pose
        at qpos0."""
        name = e.get("name", "") or f"#{i}"
        if e.tag not in _EQUALITIES:
            raise ValueError(f"equality '{name}': <{e.tag}> is not supported by the "
                             f"torch port (only {', '.join(f'<{t}>' for t in _EQUALITIES)})")
        e = _apply_defaults(e, defaults_tree["main"], "equality")
        q = _Spec()
        q.tag, q.name = e.tag, e.get("name", "")
        q.solref = _attr_f(e, "solref", _SOLREF)
        q.solimp = _attr_f(e, "solimp", _SOLIMP)
        q.active = 1 if e.get("active", "true").lower() in ("true", "1") else 0
        if e.tag == "joint":
            names, keys = [j.name for j in jnts], ("joint1", "joint2")
        elif e.tag == "tendon":
            names, keys = [t.name for t in tendons], ("tendon1", "tendon2")
        else:
            names, keys = [b.name for b in bodies], ("body1", "body2")
        ids = []
        for key in keys:
            if e.get(key) is None:
                ids.append(-1 if key in ("joint2", "tendon2") else 0)
            elif e.get(key) in names:
                ids.append(names.index(e.get(key)))
            else:
                raise ValueError(f"equality '{name}': unknown {key[:-1]} "
                                 f"'{e.get(key)}'")
        if e.get(keys[0]) is None:
            raise ValueError(f"equality '{name}': needs {keys[0]}")
        q.obj1id, q.obj2id = ids
        q.anchor = _attr_f(e, "anchor", [0, 0, 0])
        q.relpose = _floats(e.get("relpose")) if e.get("relpose") is not None else None
        q.torquescale = float(e.get("torquescale", "1"))
        q.polycoef = _attr_f(e, "polycoef", [0, 1, 0, 0, 0], n=5)
        return q

    def walk_body(e: ET.Element, parentid: int, parent_class: str):
        b = _Body()
        b.name = e.get("name", "")
        b.parentid = parentid
        bclass = e.get("childclass", parent_class)
        b.pos = _attr_f(e, "pos", [0, 0, 0])
        b.quat = _orientation(e, comp)
        b.mocap = _attr_b(e, "mocap", False)
        if b.mocap and (parentid != 0 or e.find("joint") is not None
                        or e.find("freejoint") is not None):
            raise ValueError(f"body '{b.name}': a mocap body must be a child of the "
                             f"world without joints")
        if float(e.get("gravcomp", "0")) != 0.0:
            raise ValueError(f"body '{b.name}': gravcomp is not supported")
        bodies.append(b)
        bid = len(bodies) - 1

        for child in e:
            if child.tag in ("joint", "freejoint"):
                b.joints.append(parse_joint(child, bclass, bid))
            elif child.tag == "geom":
                b.geoms.append(parse_geom(child, bclass, bid))
            elif child.tag == "site":
                parse_site(child, bclass, bid)
            elif child.tag == "body":
                walk_body(child, bid, bclass)
            elif child.tag == "inertial":
                b.explicit_inertial = True
                b.ipos = _attr_f(child, "pos", [0, 0, 0])
                b.iquat = _orientation(child, comp)
                b.mass = float(child.get("mass"))
                if child.get("diaginertia") is not None:
                    b.inertia = _floats(child.get("diaginertia"))
                elif child.get("fullinertia") is not None:
                    fi = _floats(child.get("fullinertia"))
                    M = np.array([[fi[0], fi[3], fi[4]],
                                  [fi[3], fi[1], fi[5]],
                                  [fi[4], fi[5], fi[2]]])
                    w, q = _principal_inertia(M)
                    b.inertia = w
                    b.iquat = _quat_mul(b.iquat, q)
            else:
                raise ValueError(f"body '{b.name}': <{child.tag}> is not "
                                 f"supported by the torch port")

    wb = root.find("worldbody")
    if wb is None:
        raise ValueError("no <worldbody>")
    for child in wb:
        if child.tag == "geom":
            world.geoms.append(parse_geom(child, "main", 0))
        elif child.tag == "site":
            parse_site(child, "main", 0)
        elif child.tag == "body":
            walk_body(child, 0, "main")
        else:
            raise ValueError(f"worldbody <{child.tag}> is not supported by "
                             f"the torch port")

    # ---------------- inertia from geoms ----------------
    for b in bodies[1:]:
        use_geom = (comp.inertiafromgeom == "true"
                    or (comp.inertiafromgeom == "auto" and not b.explicit_inertial))
        if use_geom and b.geoms:
            masses = np.array([geoms[g].mass for g in b.geoms])
            coms = np.stack([geoms[g].pos for g in b.geoms])
            mass = masses.sum()
            com = ((masses[:, None] * coms).sum(0) / mass) if mass > 1e-15 else np.zeros(3)
            full = np.zeros((3, 3))
            for gi in b.geoms:
                g = geoms[gi]
                R = _quat_to_mat(g.quat)
                I_g = np.diag(_geom_inertia_diag(g.type, g.size, g.mass))
                d = g.pos - com
                full += (R @ I_g @ R.T
                         + g.mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d)))
            w, q = _principal_inertia(full)
            b.mass = float(mass)
            b.inertia = np.maximum(w, 0.0)
            b.ipos = com
            b.iquat = q
        elif not b.explicit_inertial:
            b.mass = 0.0
            b.inertia = np.zeros(3)
        b.mass = max(b.mass, comp.boundmass)
        b.inertia = np.maximum(b.inertia, comp.boundinertia)

    tendons = [parse_tendon(e, i) for te in root.findall("tendon")
               for i, e in enumerate(te)]
    acts = [parse_actuator(e, i) for ae in root.iter("actuator")
            for i, e in enumerate(ae)]
    sensors = [e for se in root.iter("sensor") for e in se]
    for e in sensors:
        if SensorType.__members__.get(e.tag.upper()) not in SENSOR_DIM:
            raise ValueError(f"sensor '{e.get('name', '')}': <{e.tag}> is not "
                             f"supported by the torch port")
    eqs = [parse_equality(e, i) for ee in root.iter("equality")
           for i, e in enumerate(ee)]
    return assemble(root.get("model", ""), bodies, jnts, geoms, acts, opt,
                    sites, sensors, eqs, tendons)
