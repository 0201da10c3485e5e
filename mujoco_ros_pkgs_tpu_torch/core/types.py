"""Core types: enums, Option, Model (static physics constants), Data (batched state).

PyTorch counterpart of mujoco_ros_pkgs_tpu/core/types.py for the subset the
port runs today (world + free/ball/hinge/slide joint trees, mocap bodies,
primitive geoms, contacts, joint limits, connect / weld / joint equality
constraints, joint-transmission motors and position / velocity servos,
sites and sensors).
Static topology stays plain Python ints and tuples; arrays are tensors.
`Data` is batch-first: every field carries a leading env axis, and the step
functions take the whole batch at once.

Integer enum values match mjtJoint/mjtGeom/... of MuJoCo 2.3.7, exactly as in
the JAX package, so the two compile the same model to the same numbers.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Tuple

import torch


class DisableBit(enum.IntFlag):
    """mjtDisableBit (mjmodel.h)."""
    CONSTRAINT = 1 << 0
    EQUALITY = 1 << 1
    FRICTIONLOSS = 1 << 2
    LIMIT = 1 << 3
    CONTACT = 1 << 4
    PASSIVE = 1 << 5
    GRAVITY = 1 << 6
    CLAMPCTRL = 1 << 7
    WARMSTART = 1 << 8
    FILTERPARENT = 1 << 9
    ACTUATION = 1 << 10
    REFSAFE = 1 << 11
    SENSOR = 1 << 12


class JointType(enum.IntEnum):
    FREE = 0
    BALL = 1
    SLIDE = 2
    HINGE = 3

    def nq(self) -> int:
        return {0: 7, 1: 4, 2: 1, 3: 1}[int(self)]

    def nv(self) -> int:
        return {0: 6, 1: 3, 2: 1, 3: 1}[int(self)]


class EqType(enum.IntEnum):
    CONNECT = 0
    WELD = 1
    JOINT = 2
    TENDON = 3


class GeomType(enum.IntEnum):
    PLANE = 0
    HFIELD = 1
    SPHERE = 2
    CAPSULE = 3
    ELLIPSOID = 4
    CYLINDER = 5
    BOX = 6
    MESH = 7


class IntegratorType(enum.IntEnum):
    EULER = 0
    RK4 = 1
    IMPLICIT = 2
    IMPLICITFAST = 3


class ConeType(enum.IntEnum):
    PYRAMIDAL = 0
    ELLIPTIC = 1


class SolverType(enum.IntEnum):
    PGS = 0
    CG = 1
    NEWTON = 2


class TrnType(enum.IntEnum):
    JOINT = 0
    JOINTINPARENT = 1
    SLIDERCRANK = 2
    TENDON = 3
    SITE = 4


class DynType(enum.IntEnum):
    NONE = 0
    INTEGRATOR = 1
    FILTER = 2
    FILTEREXACT = 3
    MUSCLE = 4


class GainType(enum.IntEnum):
    FIXED = 0
    AFFINE = 1
    MUSCLE = 2


class BiasType(enum.IntEnum):
    NONE = 0
    AFFINE = 1
    MUSCLE = 2


class SensorType(enum.IntEnum):
    """mjtSensor; names match the string table the reference sensors plugin maps
    (mujoco_ros_sensors/src/mujoco_sensor_handler_plugin.cpp:70-105)."""
    TOUCH = 0
    ACCELEROMETER = 1
    VELOCIMETER = 2
    GYRO = 3
    FORCE = 4
    TORQUE = 5
    MAGNETOMETER = 6
    RANGEFINDER = 7
    JOINTPOS = 8
    JOINTVEL = 9
    TENDONPOS = 10
    TENDONVEL = 11
    ACTUATORPOS = 12
    ACTUATORVEL = 13
    ACTUATORFRC = 14
    BALLQUAT = 15
    BALLANGVEL = 16
    JOINTLIMITPOS = 17
    JOINTLIMITVEL = 18
    JOINTLIMITFRC = 19
    TENDONLIMITPOS = 20
    TENDONLIMITVEL = 21
    TENDONLIMITFRC = 22
    FRAMEPOS = 23
    FRAMEQUAT = 24
    FRAMEXAXIS = 25
    FRAMEYAXIS = 26
    FRAMEZAXIS = 27
    FRAMELINVEL = 28
    FRAMEANGVEL = 29
    FRAMELINACC = 30
    FRAMEANGACC = 31
    SUBTREECOM = 32
    SUBTREELINVEL = 33
    SUBTREEANGMOM = 34
    CLOCK = 35


class ObjType(enum.IntEnum):
    """mjtObj subset used by sensors/refs."""
    UNKNOWN = 0
    BODY = 1
    XBODY = 2
    JOINT = 3
    GEOM = 5
    SITE = 6
    CAMERA = 7


def _array():
    """A tensor field (moved and cast by `.to`, carried by `model_from_numpy`)."""
    return field(default=None, metadata={"array": True})


def array_fields(cls) -> Tuple[str, ...]:
    return tuple(f.name for f in dataclasses.fields(cls) if f.metadata.get("array"))


def static_fields(cls) -> Tuple[str, ...]:
    return tuple(f.name for f in dataclasses.fields(cls)
                 if not f.metadata.get("array") and f.name != "opt")


def _to(obj, device, dtype):
    upd = {}
    for name in array_fields(type(obj)):
        t = getattr(obj, name)
        upd[name] = t.to(device=device,
                         dtype=dtype if (dtype is not None and t.is_floating_point())
                         else t.dtype)
    return dataclasses.replace(obj, **upd)


@dataclass
class Option:
    """mjOption analogue (MJCF <option>)."""
    timestep: torch.Tensor = _array()
    gravity: torch.Tensor = _array()       # (3,)
    wind: torch.Tensor = _array()          # (3,)
    magnetic: torch.Tensor = _array()      # (3,)
    density: torch.Tensor = _array()
    viscosity: torch.Tensor = _array()
    impratio: torch.Tensor = _array()
    o_margin: torch.Tensor = _array()
    o_solref: torch.Tensor = _array()      # (2,)
    o_solimp: torch.Tensor = _array()      # (5,)
    tolerance: torch.Tensor = _array()
    ls_tolerance: torch.Tensor = _array()
    integrator: int = int(IntegratorType.EULER)
    cone: int = int(ConeType.PYRAMIDAL)
    solver: int = int(SolverType.NEWTON)
    iterations: int = 100
    ls_iterations: int = 50
    disableflags: int = 0

    def to(self, device=None, dtype=None) -> "Option":
        return _to(self, device, dtype)


@dataclass
class Model:
    """mjModel analogue: compiled physics constants of one MJCF model.

    Tensors are float64 after compile; `to(device, dtype)` moves and casts
    them. Tuple and int fields are static structure.
    """
    # ---- sizes ----
    nq: int = 0
    nv: int = 0
    nu: int = 0
    na: int = 0
    nbody: int = 0
    njnt: int = 0
    ngeom: int = 0
    neq: int = 0
    nmocap: int = 0
    nsite: int = 0
    ntendon: int = 0
    nsensor: int = 0
    nsensordata: int = 0

    opt: Option = None

    qpos0: torch.Tensor = _array()            # (nq,)
    qpos_spring: torch.Tensor = _array()      # (nq,)

    # ---- bodies ----
    body_parentid: Tuple[int, ...] = ()
    body_rootid: Tuple[int, ...] = ()
    body_weldid: Tuple[int, ...] = ()
    body_jntnum: Tuple[int, ...] = ()
    body_jntadr: Tuple[int, ...] = ()
    body_dofnum: Tuple[int, ...] = ()
    body_dofadr: Tuple[int, ...] = ()
    body_geomnum: Tuple[int, ...] = ()
    body_geomadr: Tuple[int, ...] = ()
    body_mocapid: Tuple[int, ...] = ()
    body_pos: torch.Tensor = _array()         # (nbody, 3)
    body_quat: torch.Tensor = _array()        # (nbody, 4)
    body_ipos: torch.Tensor = _array()        # (nbody, 3)
    body_iquat: torch.Tensor = _array()       # (nbody, 4)
    body_mass: torch.Tensor = _array()        # (nbody,)
    body_subtreemass: torch.Tensor = _array()
    body_inertia: torch.Tensor = _array()     # (nbody, 3)
    body_invweight0: torch.Tensor = _array()  # (nbody, 2)

    # ---- joints ----
    jnt_type: Tuple[int, ...] = ()
    jnt_qposadr: Tuple[int, ...] = ()
    jnt_dofadr: Tuple[int, ...] = ()
    jnt_bodyid: Tuple[int, ...] = ()
    jnt_limited: Tuple[int, ...] = ()
    jnt_actfrclimited: Tuple[int, ...] = ()
    jnt_pos: torch.Tensor = _array()          # (njnt, 3)
    jnt_axis: torch.Tensor = _array()         # (njnt, 3)
    jnt_stiffness: torch.Tensor = _array()    # (njnt,)
    jnt_range: torch.Tensor = _array()        # (njnt, 2)
    jnt_actfrcrange: torch.Tensor = _array()  # (njnt, 2)
    jnt_solref: torch.Tensor = _array()       # (njnt, 2)
    jnt_solimp: torch.Tensor = _array()       # (njnt, 5)
    jnt_margin: torch.Tensor = _array()       # (njnt,)

    # ---- dofs ----
    dof_bodyid: Tuple[int, ...] = ()
    dof_jntid: Tuple[int, ...] = ()
    dof_parentid: Tuple[int, ...] = ()        # -1 for root dofs
    dof_armature: torch.Tensor = _array()     # (nv,)
    dof_damping: torch.Tensor = _array()      # (nv,)
    dof_invweight0: torch.Tensor = _array()   # (nv,)
    dof_frictionloss: torch.Tensor = _array()
    dof_solref: torch.Tensor = _array()       # (nv, 2)
    dof_solimp: torch.Tensor = _array()       # (nv, 5)

    # ---- geoms ----
    geom_type: Tuple[int, ...] = ()
    geom_bodyid: Tuple[int, ...] = ()
    geom_contype: Tuple[int, ...] = ()
    geom_conaffinity: Tuple[int, ...] = ()
    geom_condim: Tuple[int, ...] = ()
    geom_priority: Tuple[int, ...] = ()
    geom_dataid: Tuple[int, ...] = ()
    geom_size: torch.Tensor = _array()        # (ngeom, 3)
    geom_rbound: torch.Tensor = _array()      # (ngeom,)
    geom_pos: torch.Tensor = _array()         # (ngeom, 3)
    geom_quat: torch.Tensor = _array()        # (ngeom, 4)
    geom_friction: torch.Tensor = _array()    # (ngeom, 3)
    geom_solmix: torch.Tensor = _array()      # (ngeom,)
    geom_solref: torch.Tensor = _array()      # (ngeom, 2)
    geom_solimp: torch.Tensor = _array()      # (ngeom, 5)
    geom_margin: torch.Tensor = _array()      # (ngeom,)
    geom_gap: torch.Tensor = _array()         # (ngeom,)

    # ---- equality constraints (eq_data: connect anchor (0:3) and anchor
    # in body2 at qpos0 (3:6); weld anchor (0:3), relpose pos (3:6) and quat
    # (6:10), torquescale (10); joint polycoef (0:5)) ----
    eq_type: Tuple[int, ...] = ()
    eq_obj1id: Tuple[int, ...] = ()
    eq_obj2id: Tuple[int, ...] = ()
    eq_active0: Tuple[int, ...] = ()
    eq_solref: torch.Tensor = _array()        # (neq, 2)
    eq_solimp: torch.Tensor = _array()        # (neq, 5)
    eq_data: torch.Tensor = _array()          # (neq, 11)

    # ---- sites ----
    site_bodyid: Tuple[int, ...] = ()
    site_pos: torch.Tensor = _array()         # (nsite, 3)
    site_quat: torch.Tensor = _array()        # (nsite, 4)

    # ---- actuators ----
    actuator_trntype: Tuple[int, ...] = ()
    actuator_dyntype: Tuple[int, ...] = ()
    actuator_gaintype: Tuple[int, ...] = ()
    actuator_biastype: Tuple[int, ...] = ()
    actuator_trnid: Tuple[Tuple[int, int], ...] = ()
    actuator_ctrllimited: Tuple[int, ...] = ()
    actuator_forcelimited: Tuple[int, ...] = ()
    actuator_gainprm: torch.Tensor = _array()     # (nu, 10)
    actuator_biasprm: torch.Tensor = _array()     # (nu, 10)
    actuator_ctrlrange: torch.Tensor = _array()   # (nu, 2)
    actuator_forcerange: torch.Tensor = _array()  # (nu, 2)
    actuator_gear: torch.Tensor = _array()        # (nu, 6)

    # ---- sensors ----
    sensor_type: Tuple[int, ...] = ()
    sensor_objtype: Tuple[int, ...] = ()
    sensor_objid: Tuple[int, ...] = ()
    sensor_reftype: Tuple[int, ...] = ()
    sensor_refid: Tuple[int, ...] = ()
    sensor_adr: Tuple[int, ...] = ()
    sensor_dim: Tuple[int, ...] = ()
    sensor_cutoff: torch.Tensor = _array()    # (nsensor,)
    sensor_noise: torch.Tensor = _array()     # (nsensor,)

    # ---- names ----
    name: str = ""
    body_names: Tuple[str, ...] = ()
    jnt_names: Tuple[str, ...] = ()
    geom_names: Tuple[str, ...] = ()
    site_names: Tuple[str, ...] = ()
    actuator_names: Tuple[str, ...] = ()
    sensor_names: Tuple[str, ...] = ()
    eq_names: Tuple[str, ...] = ()

    # ---- static structure flags (decided at compile) ----
    dof_floss_adr: Tuple[int, ...] = ()       # dofs with frictionloss > 0
    has_damping: bool = False
    has_fluid: bool = False
    dof_simple: Tuple[int, ...] = ()

    # ---- collision pair table ----
    collision_pairs: Tuple[Tuple[int, int], ...] = ()
    ncon_max: int = 0
    pair_exclude: Tuple[Tuple[int, int], ...] = ()
    pair_explicit: Tuple[Tuple[int, int], ...] = ()
    collision_mode: str = "all"
    # broadphase compaction: a pair group with more than pair_topk pairs
    # scores every pair's bounding volumes and runs the narrowphase on the
    # pair_topk most-overlapping ones only (ops/broadphase.py; 0 = every
    # pair of the table runs)
    pair_topk: int = 0
    # active-contact compaction: a cone group with more than con_topk slots
    # hands the solver only the con_topk most-penetrating slots of each env,
    # in slot order (ops/efc.make_efc); exact while an env has at most
    # con_topk active slots, the deepest win beyond (0 = off)
    con_topk: int = 0

    def to(self, device=None, dtype=None) -> "Model":
        """Copy with every tensor on `device`, floating tensors cast to `dtype`."""
        m = _to(self, device, dtype)
        return dataclasses.replace(m, opt=self.opt.to(device, dtype))

    @property
    def device(self) -> torch.device:
        return self.qpos0.device

    def body(self, name: str) -> int:
        """Body id by name (mj_name2id)."""
        return self.body_names.index(name)

    def joint(self, name: str) -> int:
        return self.jnt_names.index(name)

    def geom(self, name: str) -> int:
        return self.geom_names.index(name)

    def site(self, name: str) -> int:
        return self.site_names.index(name)

    def sensor(self, name: str) -> int:
        return self.sensor_names.index(name)


@dataclass
class Contact:
    """Fixed-capacity contact set of a batch (mjContact analogue, masked):
    one slot per potential contact in the canonical slot order
    (ops/narrowphase.slot_meta); a slot is active where dist < includemargin.
    Slot metadata (geom ids, condim) is static and shared by the batch."""
    dist: torch.Tensor           # (B, ncon)
    pos: torch.Tensor            # (B, ncon, 3)
    frame: torch.Tensor          # (B, ncon, 3, 3) rows: normal, tangent1, tangent2
    includemargin: torch.Tensor  # (B, ncon)
    friction: torch.Tensor       # (B, ncon, 5)
    solref: torch.Tensor         # (B, ncon, 2)
    solimp: torch.Tensor         # (B, ncon, 5)
    geom1: Tuple[int, ...] = ()
    geom2: Tuple[int, ...] = ()
    dim: Tuple[int, ...] = ()
    # the geom pair (B, n_dyn, 2) int64 of each dynamic slot: slots of a
    # broadphase-compacted group carry geom1 = geom2 = -2, and the j-th of
    # them reads its pair per env from dyn_pair[:, j] (n_dyn = 0 without
    # pair_topk)
    dyn_pair: torch.Tensor = None

    def replace(self, **kw) -> "Contact":
        return dataclasses.replace(self, **kw)


@dataclass
class Data:
    """mjData analogue for a batch of envs: every field has a leading env axis.

    The fused step (ops/step_tpu.py) reads and writes only the integrated
    state; the general path (ops/forward.py) fills the derived fields as
    mj_forward does, and they stay as the last forward left them."""
    time: torch.Tensor           # (B,)
    qpos: torch.Tensor           # (B, nq)
    qvel: torch.Tensor           # (B, nv)
    qacc: torch.Tensor           # (B, nv)
    qacc_warmstart: torch.Tensor  # (B, nv)
    ctrl: torch.Tensor           # (B, nu)
    qfrc_applied: torch.Tensor   # (B, nv)
    xfrc_applied: torch.Tensor   # (B, nbody, 6)
    eq_active: torch.Tensor      # (B, neq) bool
    mocap_pos: torch.Tensor      # (B, nmocap, 3)
    mocap_quat: torch.Tensor     # (B, nmocap, 4)
    # kinematics
    xpos: torch.Tensor           # (B, nbody, 3)
    xquat: torch.Tensor          # (B, nbody, 4)
    xmat: torch.Tensor           # (B, nbody, 3, 3)
    xipos: torch.Tensor          # (B, nbody, 3)
    ximat: torch.Tensor          # (B, nbody, 3, 3)
    xanchor: torch.Tensor        # (B, njnt, 3)
    xaxis: torch.Tensor          # (B, njnt, 3)
    geom_xpos: torch.Tensor      # (B, ngeom, 3)
    geom_xmat: torch.Tensor      # (B, ngeom, 3, 3)
    site_xpos: torch.Tensor      # (B, nsite, 3)
    site_xmat: torch.Tensor      # (B, nsite, 3, 3)
    subtree_com: torch.Tensor    # (B, nbody, 3)
    # com-based quantities and the dense mass matrix
    cinert: torch.Tensor         # (B, nbody, 10)
    cdof: torch.Tensor           # (B, nv, 6)
    cvel: torch.Tensor           # (B, nbody, 6)
    cdof_dot: torch.Tensor       # (B, nv, 6)
    qM: torch.Tensor             # (B, nv, nv)
    # forces
    qfrc_bias: torch.Tensor      # (B, nv)
    qfrc_passive: torch.Tensor   # (B, nv)
    qfrc_actuator: torch.Tensor  # (B, nv)
    qfrc_smooth: torch.Tensor    # (B, nv)
    qacc_smooth: torch.Tensor    # (B, nv)
    qfrc_constraint: torch.Tensor  # (B, nv)
    # actuators: transmission (position stage) and forces (actuation)
    actuator_length: torch.Tensor    # (B, nu)
    actuator_velocity: torch.Tensor  # (B, nu)
    actuator_force: torch.Tensor     # (B, nu)
    actuator_moment: torch.Tensor    # (B, nu, nv)
    # contacts and the solver's row forces
    contact: Contact
    efc_force_contact: torch.Tensor  # (B, nefc), nefc >= 1
    # sensors (ops/sensor.py): ground truth; noise is the sensors plugin's
    sensordata: torch.Tensor     # (B, nsensordata)

    def replace(self, **kw) -> "Data":
        return dataclasses.replace(self, **kw)
