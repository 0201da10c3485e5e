"""MJCF parser + model compiler (numpy), the subset the torch port runs.

Counterpart of mujoco_ros_pkgs_tpu/core/mjcf.py, kept numpy-for-numpy so the
two compile a model to the same numbers. Supported elements:

- `<include file=...>` anywhere (spliced before parsing, paths relative to
  the model's directory, nested up to 16 deep), and repeated top-level
  sections, merged into the first;
- `<option>` (with `<flag>`; `collision="all|predefined|dynamic"`),
  `<compiler>` (angle, eulerseq, autolimits, inertiafromgeom, boundmass,
  boundinertia, meshdir), `<default>` classes;
- `<asset>` with `<mesh>` (inline `vertex=`, or a binary or ASCII STL, OBJ
  or legacy MSH file; `scale`), compiled to its convex hull in the hull's
  principal frame, and `<hfield>` (inline `elevation=`, MuJoCo's binary
  file or a PNG, decoded by utils/png.py), its data normalised to [0, 1];
  `<texture>` and `<material>` are visual and ignored;
- `<worldbody>` static geoms, sites and cameras and nested `<body>` with
  `<joint>`, `<freejoint>`, `<site>`, `<camera>` and `<inertial>`;
  `mocap="true"` on a joint-less child of the world;
- geom types plane, sphere, capsule, ellipsoid, cylinder, box (a capsule or
  a cylinder also by `fromto`), mesh (the geom frame folds in the hull's
  centre and principal axes, mass and inertia from its volume) and hfield,
  with mass or density, friction, condim, priority, solmix, solref, solimp,
  margin, gap, contype, conaffinity and rgba (the renderer's albedo);
- sites: name, pos, orientation (quat, axisangle, euler, zaxis, xyaxes)
  or `fromto`, `<default><site>` classes;
- `<contact>` with `<exclude body1 body2>` and `<pair geom1 geom2>`;
- `<keyframe>` with `<key>` (time, qpos, qvel, act, ctrl, mpos, mquat);
- `<tendon>` with `<fixed>` tendons (joint entries with coef) and
  `<spatial>` tendons (`<site>`, `<geom>` with an optional `sidesite` on a
  sphere or a cylinder, and `<pulley divisor>` entries), each with limited,
  range, margin, solreflimit, solimplimit, stiffness, damping,
  frictionloss, springlength and their `<default>` classes;
- `<actuator>` with `<motor>`, `<position>` (kp, kv), `<velocity>` (kv),
  `<intvelocity>` (kp; an integrator activation), `<damper>` (kv; an
  affine gain), `<muscle>` (timeconst, tausmooth, range, force, scale,
  lmin, lmax, vmax, fpmax, fvmax) and `<general>` (dyntype none /
  integrator / filter / filterexact / muscle, gaintype fixed / affine /
  muscle, biastype none / affine / muscle, dynprm, gainprm, biasprm) on a
  joint (any type), tendon or site transmission (gear, ctrlrange,
  forcerange, actrange and their limited flags, lengthrange: a muscle
  without one has it computed at load, core/lengthrange.py), and their
  `<default>` classes;
- `<equality>` with `<connect>`, `<weld>`, `<joint>` and `<tendon>`
  (solref, solimp, active, anchor, relpose, torquescale, polycoef),
  `<default><equality>`;
- the fluid medium (`<option density viscosity wind>`) and a primitive
  geom's `fluidshape="ellipsoid"` with `fluidcoef`;
- `<sensor>` of all 36 types (core/assemble.SENSOR_DIM), with `cutoff` and
  `noise`.

Anything else (mesh-fitting (`mesh=` on a geom that is not a mesh), a
`<pair>`'s own contact parameters, fluidshape on a plane, height field or
mesh, gravcomp) raises ValueError naming the feature, rather than being
dropped silently.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from mujoco_ros_pkgs_tpu_torch.core import lengthrange, types
from mujoco_ros_pkgs_tpu_torch.core.assemble import SENSOR_DIM, assemble
from mujoco_ros_pkgs_tpu_torch.core.types import (
    BiasType, DynType, GainType, GeomType, IntegratorType, JointType, SensorType,
    TrnType, WrapType,
)

_SOLREF = (0.02, 1.0)
_SOLIMP = (0.9, 0.95, 0.001, 0.5, 2.0)

_TOP_LEVEL = ("option", "compiler", "default", "worldbody", "tendon", "actuator",
              "sensor", "equality", "size", "visual", "statistic", "asset", "contact",
              "keyframe")
# sections whose repeats (hand-written or made by <include>) merge by
# appending their children to the first; attribute-bearing singletons merge
# their attributes, the later winning (libmujoco's repeated sections)
_MERGE_SECTIONS = ("worldbody", "asset", "contact", "tendon", "actuator",
                   "sensor", "equality", "default", "keyframe", "custom")
_ATTR_SECTIONS = ("compiler", "option", "size", "visual", "statistic")
_ASSETS = ("mesh", "hfield", "texture", "material")
# a <pair>'s own contact parameters, which the JAX package does not read
_PAIR_PARAMS = ("condim", "friction", "solref", "solimp", "solreffriction", "margin",
                "gap")
_ACTUATORS = ("motor", "position", "velocity", "intvelocity", "damper", "muscle",
              "general")
_DEFAULT_TAGS = ("joint", "geom", "site", "tendon", "equality") + _ACTUATORS
_EQUALITIES = ("connect", "weld", "joint", "tendon")
_DYNTYPES = {"none": DynType.NONE, "integrator": DynType.INTEGRATOR,
             "filter": DynType.FILTER, "filterexact": DynType.FILTEREXACT,
             "muscle": DynType.MUSCLE}
_GAINTYPES = {"fixed": GainType.FIXED, "affine": GainType.AFFINE, "muscle": GainType.MUSCLE}
_BIASTYPES = {"none": BiasType.NONE, "affine": BiasType.AFFINE, "muscle": BiasType.MUSCLE}
# <muscle>'s parameters after its range (gainprm 2-8) and their defaults
_MUSCLE_PRM = (("force", -1.0), ("scale", 200.0), ("lmin", 0.5), ("lmax", 1.6),
               ("vmax", 1.5), ("fpmax", 1.3), ("fvmax", 1.2))
_GEOM_TYPES = {"plane": GeomType.PLANE, "hfield": GeomType.HFIELD,
               "sphere": GeomType.SPHERE, "capsule": GeomType.CAPSULE,
               "ellipsoid": GeomType.ELLIPSOID, "cylinder": GeomType.CYLINDER,
               "box": GeomType.BOX, "mesh": GeomType.MESH}
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
        self.meshdir = ""
        if e is not None:
            self.meshdir = e.get("meshdir", "")
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
    """Bounding radius from the type and size (a mesh geom's compile takes
    its hull's instead; this one serves size edits)."""
    if gtype in (GeomType.PLANE, GeomType.HFIELD):
        return 0.0
    if gtype == GeomType.SPHERE:
        return size[0]
    if gtype == GeomType.CAPSULE:
        return size[0] + size[1]
    if gtype == GeomType.CYLINDER:
        return float(np.sqrt(size[0] ** 2 + size[1] ** 2))
    if gtype == GeomType.ELLIPSOID:
        return float(np.max(size))
    if gtype == GeomType.BOX:
        return float(np.linalg.norm(size))
    return float(np.max(size))


def _fluid_semiaxes(gtype: int, size: np.ndarray) -> np.ndarray:
    """Equivalent-ellipsoid semiaxes of a primitive geom (a capsule's
    include its caps, a box's are its half sizes)."""
    if gtype == GeomType.SPHERE:
        return np.array([size[0], size[0], size[0]])
    if gtype == GeomType.CAPSULE:
        return np.array([size[0], size[0], size[1] + size[0]])
    if gtype == GeomType.CYLINDER:
        return np.array([size[0], size[0], size[1]])
    return np.asarray(size[:3], dtype=np.float64)


@functools.lru_cache(maxsize=1)
def _leggauss400():
    """400-point Gauss-Legendre nodes and weights, made once (an eigenvalue
    problem of order 400)."""
    return np.polynomial.legendre.leggauss(400)


def _fluid_kappa(a: float, b: float, c: float) -> float:
    """Potential-flow added-mass factor of an ellipsoid moving along its
    first semiaxis: the integral over l from 0 to infinity of
    a b c / sqrt((a^2 + l)^3 (b^2 + l) (c^2 + l)), by 400-point
    Gauss-Legendre under l = a^2 u / (1 - u) (2/3 for a sphere)."""
    x, w = _leggauss400()
    u = 0.5 * (x + 1.0)
    lam = a * a * u / (1.0 - u)
    dl = a * a / (1.0 - u) ** 2
    f = a * b * c / np.sqrt((a * a + lam) ** 3 * (b * b + lam) * (c * c + lam))
    return float(np.sum(f * dl * 0.5 * w))


def _fluid_ellipsoid_coefs(semi: np.ndarray, coef: np.ndarray) -> np.ndarray:
    """The 12 numbers of a geom's ellipsoid fluid model: [active,
    blunt_drag, slender_drag, ang_drag, kutta_lift, magnus_lift,
    virtual_mass (3), virtual_inertia (3)], from its equivalent ellipsoid's
    semiaxes and fluidcoef (opt.density multiplies in at run time)."""
    a, b, c = (float(x) for x in semi)
    vol = 4.0 / 3.0 * np.pi * a * b * c
    kx, ky, kz = _fluid_kappa(a, b, c), _fluid_kappa(b, c, a), _fluid_kappa(c, a, b)
    vmass = [vol * k / max(1e-15, 2.0 - k) for k in (kx, ky, kz)]

    def vinertia(d1, d2, k1, k2):
        # the added moment of inertia about the axis normal to (d1, d2);
        # zero where d1 == d2
        num = (d1 * d1 - d2 * d2) ** 2 * (k2 - k1)
        den = 2.0 * (d1 * d1 - d2 * d2) + (d1 * d1 + d2 * d2) * (k1 - k2)
        return 0.0 if abs(den) < 1e-12 else vol / 5.0 * num / den

    vin = [vinertia(b, c, ky, kz), vinertia(c, a, kz, kx), vinertia(a, b, kx, ky)]
    return np.array([1.0, *np.asarray(coef, dtype=np.float64), *vmass, *vin])


# ---------------------------------------------------------------------------
# mesh and height-field assets
# ---------------------------------------------------------------------------

class _Mesh:
    """A mesh asset as collision sees it: the convex hull of its vertices,
    centred at the hull's centre of mass and rotated into its principal
    axes (mjCMesh::Compile); each geom that names it folds that (com,
    quat) into its own frame. Collision reads the hull's vertices alone
    (ops/gjk.py's support function)."""

    def __init__(self, name: str, raw_verts: np.ndarray):
        from scipy.spatial import ConvexHull, QhullError
        if raw_verts.shape[0] < 4:
            raise ValueError(f"mesh '{name}': need >=4 vertices")
        try:
            hull = ConvexHull(raw_verts)
        except QhullError as e:
            raise ValueError(
                f"mesh '{name}': degenerate vertex set (convex hull failed: "
                f"{str(e).splitlines()[0]})") from e
        pts = hull.points
        # orient each simplex outward by qhull's facet normal
        tris = []
        for simplex, eq in zip(hull.simplices, hull.equations):
            a, b, c = pts[simplex]
            n = np.cross(b - a, c - a)
            tris.append(simplex if np.dot(n, eq[:3]) >= 0 else simplex[[0, 2, 1]])
        vol, com, I_full = _poly_mass_properties(pts, np.asarray(tris))
        if vol <= 1e-12:
            raise ValueError(f"mesh '{name}': degenerate (volume {vol})")
        w, vecs = np.linalg.eigh(I_full)
        if np.linalg.det(vecs) < 0:
            vecs[:, 2] = -vecs[:, 2]
        local = (pts[hull.vertices] - com) @ vecs       # R^T (v - com)
        self.name = name
        self.verts = local
        self.com = com
        self.quat = _mat_to_quat(vecs)
        self.volume = float(vol)
        self.inertia_unit = np.maximum(w, 0.0)   # unit density, about the com
        self.rbound = float(np.max(np.linalg.norm(local, axis=1)))
        self.aabb_half = np.max(np.abs(local), axis=0)


def _poly_mass_properties(verts: np.ndarray, tris: np.ndarray):
    """(volume, com, unit-density inertia about the com) of a closed
    polyhedron, by signed tetrahedra about the origin."""
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    v = np.einsum("ij,ij->i", a, np.cross(b, c)) / 6.0       # signed volumes
    vol = v.sum()
    com = (v[:, None] * (a + b + c) / 4.0).sum(0) / vol
    # second moments over the tetrahedra: V/20 (aa' + bb' + cc' + ss'), s = a+b+c
    s = a + b + c
    C = np.einsum("i,ij,ik->jk", v / 20.0, a, a)
    C += np.einsum("i,ij,ik->jk", v / 20.0, b, b)
    C += np.einsum("i,ij,ik->jk", v / 20.0, c, c)
    C += np.einsum("i,ij,ik->jk", v / 20.0, s, s)
    C -= vol * np.outer(com, com)
    return vol, com, np.trace(C) * np.eye(3) - C


def _load_mesh_vertices(path: str) -> np.ndarray:
    """The vertices of a binary or ASCII STL, an OBJ or a legacy MSH file."""
    ext = os.path.splitext(path)[1].lower()
    with open(path, "rb") as f:
        data = f.read()
    if ext == ".obj":
        verts = []
        for line in data.decode("utf-8", errors="replace").splitlines():
            t = line.split()
            if len(t) >= 4 and t[0] == "v":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
        return np.asarray(verts)
    if ext == ".msh":
        nvert = int(np.frombuffer(data[:4], dtype=np.int32)[0])
        off = 16  # the nvert, nnormal, ntexcoord and nface headers
        return np.frombuffer(data[off:off + 12 * nvert],
                             dtype=np.float32).reshape(nvert, 3).astype(np.float64)
    # STL: binary where the size matches the triangle count of its header
    if len(data) >= 84:
        ntri = int(np.frombuffer(data[80:84], dtype=np.uint32)[0])
        if len(data) == 84 + 50 * ntri:
            raw = np.frombuffer(data[84:], dtype=np.uint8).reshape(ntri, 50)
            tris = raw[:, 12:48].copy().view(np.float32).reshape(ntri, 9)
            return tris.reshape(-1, 3).astype(np.float64)
    verts = []
    for line in data.decode("utf-8", errors="replace").splitlines():
        t = line.split()
        if len(t) == 4 and t[0] == "vertex":
            verts.append([float(t[1]), float(t[2]), float(t[3])])
    return np.asarray(verts)


class _HField:
    """A height-field asset: its elevation grid normalised to [0, 1]
    (mjCHField::Compile)."""

    def __init__(self, name: str, size: np.ndarray, nrow: int, ncol: int,
                 data: Optional[np.ndarray]):
        if nrow < 2 or ncol < 2:
            raise ValueError(f"hfield '{name}': need nrow,ncol >= 2")
        if data is None:
            data = np.zeros((nrow, ncol))
        if np.asarray(data).size != nrow * ncol:
            raise ValueError(f"hfield '{name}': {np.asarray(data).size} elevation values "
                             f"for nrow {nrow} x ncol {ncol}")
        data = np.asarray(data, dtype=np.float64).reshape(nrow, ncol)
        lo, hi = data.min(), data.max()
        data = (data - lo) / (hi - lo) if hi - lo > 1e-15 else np.zeros_like(data)
        self.name = name
        self.size = np.asarray(size, dtype=np.float64)
        self.nrow, self.ncol = nrow, ncol
        self.data = data


def _load_hfield_file(path: str):
    """(nrow, ncol, data) of a PNG (its gray values) or of MuJoCo's binary
    height field (int32 nrow, ncol, then float32 data)."""
    from mujoco_ros_pkgs_tpu_torch.utils import png
    if os.path.splitext(path)[1].lower() == ".png":
        arr = png.luminance(png.read(path)).astype(np.float64)
        return arr.shape[0], arr.shape[1], arr
    with open(path, "rb") as f:
        raw = f.read()
    nrow, ncol = np.frombuffer(raw[:8], dtype=np.int32)
    data = np.frombuffer(raw[8:8 + 4 * nrow * ncol], dtype=np.float32)
    return int(nrow), int(ncol), data.reshape(int(nrow), int(ncol)).astype(np.float64)


def _asset_name(e: ET.Element) -> str:
    return e.get("name") or os.path.splitext(os.path.basename(e.get("file", "")))[0]


def _parse_assets(root: ET.Element, base_dir: str, comp: "_Compiler"):
    """({name: _Mesh}, {name: _HField}) of the <asset> section, in order."""
    meshes: Dict[str, _Mesh] = {}
    hfields: Dict[str, _HField] = {}
    asset = root.find("asset")
    if asset is None:
        return meshes, hfields
    for e in asset:
        if e.tag not in _ASSETS:
            raise ValueError(f"<asset> <{e.tag}> is not supported by the torch port")
    for e in asset.iter("mesh"):
        name, file = _asset_name(e), e.get("file", "")
        scale = _attr_f(e, "scale", [1.0, 1.0, 1.0], n=3)
        if e.get("vertex") is not None:
            raw = _floats(e.get("vertex")).reshape(-1, 3)
        elif file:
            raw = _load_mesh_vertices(os.path.join(base_dir, comp.meshdir, file))
        else:
            raise ValueError(f"mesh '{name}': neither file nor vertex data")
        meshes[name] = _Mesh(name, raw * scale)
    for e in asset.iter("hfield"):
        name, file = _asset_name(e), e.get("file", "")
        size = _attr_f(e, "size", None, n=4)
        if size is None:
            raise ValueError(f"hfield '{name}': size attribute required")
        if e.get("elevation") is not None:      # inline grid, row-major
            nrow, ncol = int(e.get("nrow", "0")), int(e.get("ncol", "0"))
            data = _floats(e.get("elevation"))
        elif file:
            nrow, ncol, data = _load_hfield_file(os.path.join(base_dir, comp.meshdir, file))
        else:
            nrow, ncol, data = int(e.get("nrow", "0")), int(e.get("ncol", "0")), None
        hfields[name] = _HField(name, size, nrow, ncol, data)
    return meshes, hfields


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
    """Load and compile an MJCF file (mj_loadXML analogue); includes and
    asset files resolve against its directory."""
    with open(path) as f:
        xml = f.read()
    return load_model_from_string(xml, dtype=dtype, base_dir=os.path.dirname(path),
                                  pair_topk=pair_topk, con_topk=con_topk)


def load_model_from_string(xml: str, dtype=None, base_dir: str = ".",
                           pair_topk: int = 0, con_topk: int = 0) -> types.Model:
    """Compile an MJCF string to a float64 CPU Model (cast with `dtype`),
    with includes and asset files resolved against `base_dir` and the
    broadphase (pair_topk) and active-contact (con_topk) compaction
    capacities set (types.Model; 0 = off)."""
    root = ET.fromstring(xml)
    if root.tag != "mujoco":
        raise ValueError(f"expected <mujoco> root, got <{root.tag}>")
    _expand_includes(root, base_dir)
    _merge_repeated_sections(root)
    for child in root:
        if child.tag not in _TOP_LEVEL:
            raise ValueError(f"<{child.tag}> is not supported by the torch port")
    m = dataclasses.replace(_compile(root, base_dir), pair_topk=int(pair_topk),
                            con_topk=int(con_topk))
    return m.to(dtype=dtype) if dtype is not None else m


def _expand_includes(elem: ET.Element, base_dir: str, depth: int = 0) -> None:
    """Splice <include file=.../> elements in place: the included file's
    root children replace the element, paths resolve against base_dir (the
    main model's directory), includes nest up to 16 deep."""
    if depth > 16:
        raise ValueError("<include> nesting too deep (cycle?)")
    i = 0
    while i < len(elem):
        ch = elem[i]
        if ch.tag == "include":
            fname = ch.get("file")
            if not fname:
                raise ValueError("<include> requires a file attribute")
            path = fname if os.path.isabs(fname) else os.path.join(base_dir, fname)
            try:
                inc = ET.parse(path).getroot()
            except (OSError, ET.ParseError) as exc:
                raise ValueError(f"<include file='{fname}'>: {exc}") from exc
            _expand_includes(inc, base_dir, depth + 1)
            elem.remove(ch)
            for j, sub in enumerate(list(inc)):
                elem.insert(i + j, sub)
            i += len(inc)
        else:
            _expand_includes(ch, base_dir, depth)
            i += 1


def _merge_repeated_sections(root: ET.Element) -> None:
    """Fold repeated top-level sections into their first occurrence."""
    seen: Dict[str, ET.Element] = {}
    for ch in list(root):
        t = ch.tag
        if t in seen and t in _MERGE_SECTIONS + _ATTR_SECTIONS:
            if t in _ATTR_SECTIONS:
                seen[t].attrib.update(ch.attrib)
            for sub in list(ch):
                seen[t].append(sub)
            root.remove(ch)
        else:
            seen[t] = ch


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


def _compile(root: ET.Element, base_dir: str) -> types.Model:
    comp = _Compiler(root.find("compiler"))
    defaults_tree = _collect_defaults(root)
    opt = _parse_option(root.find("option"))
    meshes, hfields = _parse_assets(root, base_dir, comp)

    bodies: List[_Body] = []
    jnts: List[_Spec] = []
    geoms: List[_Spec] = []
    sites: List[_Spec] = []
    cams: List[_Spec] = []
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
        fluidshape = e.get("fluidshape", "none")
        if fluidshape not in ("none", "ellipsoid"):
            raise ValueError(f"geom '{g.name}': unknown fluidshape='{fluidshape}' "
                             f"(expected 'none' or 'ellipsoid')")
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
        g.rgba = _attr_f(e, "rgba", [0.5, 0.5, 0.5, 1.0], n=4)
        g.pos = _attr_f(e, "pos", [0, 0, 0])
        g.quat = _orientation(e, comp)
        if e.get("fromto") is not None:
            ft = _floats(e.get("fromto"))
            a, b = ft[:3], ft[3:]
            g.pos = 0.5 * (a + b)
            g.quat = _z2quat(b - a)
            g.size[1] = np.linalg.norm(b - a) / 2.0
        # geom_dataid: the hfield's or the mesh's index in its table
        g.dataid, g.inertia_diag, mesh = -1, None, None
        hfield_name, mesh_name = e.get("hfield", ""), e.get("mesh", "")
        if g.type == GeomType.HFIELD or hfield_name:
            if g.type != GeomType.HFIELD:
                raise ValueError(f"geom '{g.name}': hfield attr requires type='hfield'")
            if hfield_name not in hfields:
                raise ValueError(f"geom '{g.name}': undefined hfield '{hfield_name}'")
            g.dataid = list(hfields).index(hfield_name)
            g.size = hfields[hfield_name].size[:3].copy()
        if mesh_name:
            if g.type != GeomType.MESH:
                raise ValueError(f"geom '{g.name}': mesh-fitting (mesh attr with "
                                 f"type != mesh) is not supported")
            if mesh_name not in meshes:
                raise ValueError(f"geom '{g.name}': undefined mesh '{mesh_name}' "
                                 f"(no such <asset> mesh)")
            # fold the hull's (com, principal quat) into the geom frame
            mesh = meshes[mesh_name]
            g.dataid = list(meshes).index(mesh_name)
            g.pos = np.asarray(g.pos, dtype=np.float64) + _quat_rot(mesh.com, g.quat)
            g.quat = _quat_mul(g.quat, mesh.quat)
            g.size = mesh.aabb_half.copy()
        elif g.type == GeomType.MESH:
            raise ValueError(f"geom '{g.name}': type mesh without mesh attr")
        vol = mesh.volume if mesh is not None else _geom_volume(g.type, g.size)
        g.mass = (float(e.get("mass")) if e.get("mass") is not None
                  else float(e.get("density", "1000")) * vol)
        if mesh is not None:
            g.inertia_diag = mesh.inertia_unit * (g.mass / mesh.volume)
            g.rbound = mesh.rbound
        else:
            g.rbound = _geom_rbound(g.type, g.size)
        # the ellipsoid fluid model's 12 numbers (mjCGeom::SetFluidCoefs)
        g.fluid = np.zeros(12)
        if fluidshape == "ellipsoid":
            if g.type in (GeomType.PLANE, GeomType.HFIELD, GeomType.MESH):
                raise ValueError(f"geom '{g.name}': fluidshape='ellipsoid' requires a "
                                 f"primitive geom (sphere/capsule/cylinder/ellipsoid/box)")
            g.fluid = _fluid_ellipsoid_coefs(
                _fluid_semiaxes(g.type, g.size),
                _attr_f(e, "fluidcoef", [0.5, 0.25, 1.5, 1.0, 1.0], n=5))
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

    def parse_camera(e, bodyid):
        c = _Spec()
        c.name = e.get("name", "")
        c.bodyid = bodyid
        c.pos = _attr_f(e, "pos", [0, 0, 0])
        c.quat = _orientation(e, comp)
        c.fovy = float(e.get("fovy", "45"))     # degrees whatever the angle unit
        cams.append(c)

    def parse_tendon(e, i):
        """A <fixed> tendon (joint entries with their coef) or a <spatial>
        one (site, geom with an optional sidesite, and pulley entries), as
        its wrap entries (type, object id, prm: a joint's coef, a geom's
        sidesite id or -1, a pulley's divisor), with its limit, spring,
        damping and friction-loss parameters, as the JAX compiler reads
        them."""
        name = e.get("name", "") or f"#{i}"
        if e.tag not in ("fixed", "spatial"):
            raise ValueError(f"tendon '{name}': <{e.tag}> is not a tendon (only <fixed> "
                             f"and <spatial>)")
        e = _apply_defaults(e, defaults_tree.get(e.get("class", "main"),
                                                 defaults_tree["main"]), "tendon")
        t = _Spec()
        t.name = e.get("name", "")
        jnt_names = [j.name for j in jnts]
        site_names, geom_names = [st.name for st in sites], [g.name for g in geoms]
        t.wraps = []
        for we in e:
            if e.tag == "fixed":
                if (we.tag != "joint" or we.get("joint") not in jnt_names
                        or we.get("coef") is None):
                    raise ValueError(f"tendon '{name}': a fixed tendon's entries are "
                                     f"<joint joint=... coef=...> of named joints, got "
                                     f"<{we.tag} {we.attrib}>")
                t.wraps.append((int(WrapType.JOINT), jnt_names.index(we.get("joint")),
                                float(we.get("coef"))))
            elif we.tag == "site":
                if we.get("site") not in site_names:
                    raise ValueError(f"tendon '{name}': unknown site '{we.get('site')}'")
                t.wraps.append((int(WrapType.SITE), site_names.index(we.get("site")), 0.0))
            elif we.tag == "geom":
                if we.get("geom") not in geom_names:
                    raise ValueError(f"tendon '{name}': unknown wrap geom "
                                     f"'{we.get('geom')}'")
                gid = geom_names.index(we.get("geom"))
                kind = {GeomType.SPHERE: WrapType.SPHERE,
                        GeomType.CYLINDER: WrapType.CYLINDER}.get(GeomType(geoms[gid].type))
                if kind is None:
                    raise ValueError(f"tendon '{name}': wrap geom '{we.get('geom')}' must "
                                     f"be a sphere or cylinder")
                side = we.get("sidesite")
                if side is not None and side not in site_names:
                    raise ValueError(f"tendon '{name}': unknown sidesite '{side}'")
                t.wraps.append((int(kind), gid,
                                float(site_names.index(side)) if side is not None else -1.0))
            elif we.tag == "pulley":
                t.wraps.append((int(WrapType.PULLEY), -1, float(we.get("divisor", "1"))))
            else:
                raise ValueError(f"tendon '{name}': <{we.tag}> is not a spatial tendon "
                                 f"entry (only <site>, <geom> and <pulley>)")
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
        (affine gain -kv velocity), <muscle> (muscle dynamics, gain and
        bias with MJCF's defaults, ctrlrange 0 1 unless given) or
        <general> (muscle types too), on a joint, tendon or site
        transmission, with its lengthrange (0 0: a muscle's is computed at
        load, core/lengthrange.py)."""
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
        elif tag == "muscle":
            a.dyntype, a.gaintype, a.biastype = (int(DynType.MUSCLE), int(GainType.MUSCLE),
                                                 int(BiasType.MUSCLE))
            # a partial timeconst or range pads with zeros, as the JAX compiler reads it
            for attr, prm, default in (("timeconst", a.dynprm, (0.01, 0.04)),
                                       ("range", a.gainprm, (0.75, 1.05))):
                v = _floats(e.get(attr)) if e.get(attr) is not None else np.array(default)
                prm[:2] = np.concatenate([v, np.zeros(2)])[:2]
            a.dynprm[2] = float(e.get("tausmooth", "0"))
            for k, (attr, default) in enumerate(_MUSCLE_PRM, start=2):
                a.gainprm[k] = float(e.get(attr, default))
            a.biasprm[:9] = a.gainprm[:9]
            if e.get("ctrlrange") is None:
                e.set("ctrlrange", "0 1")
        elif tag == "general":
            for attr, table, key in (("dyntype", _DYNTYPES, "none"),
                                     ("gaintype", _GAINTYPES, "fixed"),
                                     ("biastype", _BIASTYPES, "none")):
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
        a.lengthrange = _attr_f(e, "lengthrange", [0, 0])
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
            elif child.tag == "camera":
                parse_camera(child, bid)
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
        elif child.tag == "camera":
            parse_camera(child, 0)
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
                I_g = np.diag(g.inertia_diag if g.inertia_diag is not None
                              else _geom_inertia_diag(g.type, g.size, g.mass))
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
                             f"a sensor type")
    eqs = [parse_equality(e, i) for ee in root.iter("equality")
           for i, e in enumerate(ee)]
    excludes, explicit = _parse_contact(root, [b.name for b in bodies],
                                        [g.name for g in geoms])
    keys = [k for ke in root.iter("keyframe") for k in ke]
    for k in keys:
        if k.tag != "key":
            raise ValueError(f"<keyframe> <{k.tag}> is not supported (only <key>)")
    m = assemble(root.get("model", ""), bodies, jnts, geoms, acts, opt,
                 sites, sensors, eqs, tendons, meshes=list(meshes.values()),
                 hfields=list(hfields.values()), cams=cams, keys=keys,
                 excludes=excludes, explicit_pairs=explicit)
    if lengthrange.needs_auto(m).any():
        m = lengthrange.apply_auto_lengthrange(m)
    return m


def _parse_contact(root: ET.Element, body_names, geom_names):
    """<contact>: the <exclude> body pairs (sorted, as a set) and the
    <pair> geom pairs (in order), by name."""
    def index(kind, names, e, key):
        name = e.get(key)
        if name not in names:
            raise ValueError(f"<contact> <{e.tag}>: unknown {kind} '{name}'")
        return names.index(name)

    excludes, explicit = set(), []
    for ce in root.iter("contact"):
        for pe in ce:
            if pe.tag == "exclude":
                excludes.add((index("body", body_names, pe, "body1"),
                              index("body", body_names, pe, "body2")))
            elif pe.tag == "pair":
                own = [a for a in _PAIR_PARAMS if pe.get(a) is not None]
                if own or pe.get("class") is not None:
                    raise ValueError(f"<contact> <pair>: its own contact parameters "
                                     f"({', '.join(own) or 'class'}) are not supported")
                explicit.append((index("geom", geom_names, pe, "geom1"),
                                 index("geom", geom_names, pe, "geom2")))
            else:
                raise ValueError(f"<contact> <{pe.tag}> is not supported "
                                 f"(only <exclude> and <pair>)")
    return tuple(sorted(excludes)), tuple(explicit)
