"""Seeded float32 Newton problems, fused-step worlds and general-route
states for holding the port's kernels, their plain versions and the JAX
package against each other (the tests and chip_smoke.py). Imports no JAX.

Importing it caps torch's intra-op threads at TORCH_THREADS for a test
process (the suite runs several workers on one machine, each of which
would otherwise start a thread per core); chip_smoke.py sets its own."""

import os
import subprocess
import sys

import numpy as np
import torch

TORCH_THREADS = 1
torch.set_num_threads(TORCH_THREADS)

from mujoco_ros_pkgs_tpu_torch.models import worlds
from mujoco_ros_pkgs_tpu_torch.msgs import SensorNoiseModel
from mujoco_ros_pkgs_tpu_torch.ops import solver_tpu

# fused-step worlds beside BOXES: a damped free joint with armature, and a
# capsule (condim 6) with a sphere (condim 1) on one body
BOXES_DAMPED = worlds.BOXES.replace(
    "<freejoint/>", '<joint type="free" damping="0.05" armature="0.01"/>')
CAPSULE_CONDIM6 = """
<mujoco>
  <option cone="elliptic"/>
  <worldbody>
    <geom type="plane" size="5 5 1"/>
    <body pos="0 0 0.12">
      <freejoint/>
      <geom type="capsule" fromto="-0.1 0 0 0.1 0 0" size="0.05" condim="6"/>
      <geom type="sphere" pos="0 0.08 0" size="0.04" condim="1" priority="1"/>
    </body>
  </worldbody>
</mujoco>
"""

# rows of every kind the solve takes: 'eq', 'fri', 'lim', a condim-1
# contact and elliptic cones of condim 3, 4 and 6 (20 rows)
MIXED_KINDS = ("eq", "eq", "fri", "fri", "lim", "lim") + ("con",) * 14
MIXED_BASE = ((6, 1), (7, 3), (10, 4), (14, 6))
# 64 rows at nv 16 (the kernel's maxima): the same, then 11 condim-3 cones,
# a condim-6, a condim-4 and a condim-1 contact
FULL_KINDS = MIXED_KINDS + ("con",) * 44
FULL_BASE = (MIXED_BASE + tuple((20 + 3 * i, 3) for i in range(11))
             + ((53, 6), (59, 4), (63, 1)))

# per contact [sliding, sliding, torsional, rolling, rolling]: soft cones,
# where most envs converge in 4 to 15 Newton trips
SOFT_FRICTION = (0.9, 0.9, 0.5, 0.5, 0.5)
# MuJoCo's default friction (1, 0.005, 0.0001): cones so stiff that about
# half of the envs do not converge in 32 trips, and float32 rounding then
# decides where an unconverged solve stops
DEFAULT_FRICTION = (1.0, 1.0, 0.005, 0.0001, 0.0001)


def random_problem(rng, nenv: int, nv: int, kinds, con_base,
                   friction=SOFT_FRICTION) -> dict:
    """A seeded, well-conditioned float32 problem with the given rows, as
    numpy arrays: SPD M, J of scale 0.3, friction loss 0.3 on 'fri' rows,
    `friction` per contact times U(0.5, 1.5), 85% of rows active."""
    nefc, ncon = len(kinds), len(con_base)
    A = rng.normal(size=(nenv, nv, nv))
    mu = np.tile(friction, (nenv, max(ncon, 1), 1))
    arrays = dict(
        J=0.3 * rng.normal(size=(nenv, nefc, nv)),
        aref=rng.normal(size=(nenv, nefc)),
        D=np.abs(rng.normal(size=(nenv, nefc))) + 0.5,
        floss=np.where(np.array(kinds) == "fri", 0.3, 0.0) * np.ones((nenv, 1)),
        active=rng.uniform(size=(nenv, nefc)) < 0.85,
        mu=(mu * rng.uniform(0.5, 1.5, size=(nenv, max(ncon, 1), 1)))[:, :ncon],
        M=A @ A.transpose(0, 2, 1) / nv + np.eye(nv),
        a_s=rng.normal(size=(nenv, nv)), ws=rng.normal(size=(nenv, nv)))
    return {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
            for k, v in arrays.items()}


def solve_cost(kinds, con_base, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The Newton solve's objective at x, in float64: 0.5 (x - a_s)^T M
    (x - a_s) plus the rows' cost. At a converged solve it is well
    conditioned where x is not (stiff cones leave flat directions)."""
    p = {k: torch.as_tensor(v).to(torch.float64) if torch.as_tensor(v).is_floating_point()
         else torch.as_tensor(v) for k, v in p.items()}
    x = torch.as_tensor(x).to(torch.float64)
    dx = x - p["a_s"]
    jar = (p["J"] @ x[..., None])[..., 0] - p["aref"]
    rows = solver_tpu._row_forces(kinds, con_base, p["mu"], p["D"], p["floss"],
                                  p["active"], jar, False)[2]
    return 0.5 * ((p["M"] @ dx[..., None])[..., 0] * dx).sum(-1) + rows


def fused_states(nenv: int, seed: int):
    """Seeded fused-step states (qpos (nenv, 7), qvel (nenv, 6), float32
    numpy): heights 0.02-0.27 over the plane, tilted, random velocities."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((nenv, 7), np.float32)
    qpos[:, 2] = 0.02 + 0.25 * rng.uniform(size=nenv)
    quat = rng.normal(size=(nenv, 4)) * 0.2
    quat[:, 0] += 1.0
    qpos[:, 3:] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qvel = (0.6 * rng.normal(size=(nenv, 6))).astype(np.float32)
    return qpos, qvel


def box_cluster(nbox: int) -> str:
    """BOXES with nbox box geoms on its one body (12 rows each): a fused-step
    world with more rows, for the wider groups of K3."""
    extra = "".join(
        f'<geom type="box" size="0.05 0.05 0.05" pos="{0.15 * k:g} {0.05 * k:g} 0"/>'
        for k in range(1, nbox))
    return worlds.BOXES.replace("</body>", extra + "</body>", 1)


# general-Newton worlds beside PILE: a hinge chain of nv 18 lying on the
# ground, and a walled bin of 2 boxes, 2 spheres and 1 capsule (nv 30)
def _chain(nlink: int) -> str:
    body = ""
    for k in reversed(range(nlink)):
        body = (f'<body pos="{0.1 if k else 0:g} 0 {0 if k else 0.05:g}">'
                '<joint type="hinge" axis="0 1 0"/><joint type="hinge" axis="0 0 1"/>'
                '<joint type="hinge" axis="1 0 0"/>'
                '<geom type="capsule" fromto="0 0 0 0.1 0 0" size="0.02"/>'
                + body + "</body>")
    return ('<mujoco model="chain"><option timestep="0.002" cone="elliptic" '
            'iterations="30"/><worldbody><geom name="ground" type="plane" '
            f'size="2 2 1"/>{body}</worldbody></mujoco>')


CHAIN = _chain(6)

BIN = """
<mujoco model="bin5">
  <option timestep="0.002" gravity="0 0 -9.81" cone="elliptic" iterations="20"/>
  <worldbody>
    <geom name="ground" type="plane" size="1 1 1"/>
    <geom name="wall_x" type="box" pos="0.2 0 0.1" size="0.02 0.25 0.1"/>
    <geom name="wall_y" type="box" pos="0 0.2 0.1" size="0.25 0.02 0.1"/>
    <body name="box0"><freejoint/>
      <geom type="box" size="0.05 0.04 0.035" mass="0.3" friction="0.8 0.005 0.0001"/></body>
    <body name="box1"><freejoint/>
      <geom type="box" size="0.045 0.05 0.04" mass="0.3" friction="0.8 0.005 0.0001"/></body>
    <body name="ball0"><freejoint/>
      <geom type="sphere" size="0.05" mass="0.3" friction="0.8 0.005 0.0001"/></body>
    <body name="ball1"><freejoint/>
      <geom type="sphere" size="0.04" mass="0.3" friction="0.8 0.005 0.0001"/></body>
    <body name="cap"><freejoint/>
      <geom type="capsule" size="0.035 0.05" mass="0.3" friction="0.8 0.005 0.0001"/></body>
  </worldbody>
</mujoco>
"""
# where each BIN body starts: against the walls, the ground and each other
# (box0 on wall_x and box1, ball0 on wall_y and ball1, ball1 on box1, the
# capsule lying along x against ball1 and box1)
_BIN_POS = ((0.14, 0.0, 0.03), (0.05, 0.0, 0.037), (0.0, 0.14, 0.046),
            (0.0, 0.07, 0.037), (-0.06, 0.06, 0.032))
_BIN_QUAT = ((1, 0, 0, 0),) * 4 + ((np.sqrt(0.5), 0, np.sqrt(0.5), 0),)


def bin_states(nenv: int, seed: int):
    """Seeded BIN states (qpos (nenv, 35), qvel (nenv, 30), float64 numpy):
    each body at its start within 1 cm, tilted by about 0.1 rad, moving."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((nenv, 5, 7))
    qpos[..., :3] = np.array(_BIN_POS) + 0.01 * rng.uniform(-1, 1, (nenv, 5, 3))
    quat = np.array(_BIN_QUAT, dtype=float) + 0.05 * rng.normal(size=(nenv, 5, 4))
    qpos[..., 3:] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    return qpos.reshape(nenv, 35), 0.3 * rng.normal(size=(nenv, 30))


def chain_states(nenv: int, seed: int):
    """Seeded CHAIN states (qpos = qvel (nenv, 18), float64 numpy): links
    bent up and down by up to 0.5 rad, so that some rest on the ground,
    folded sideways by 2.4-2.9 rad the one way and the other, so that links
    two apart touch, and rolled by up to 0.3 rad."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((nenv, 18))
    qpos[:, 0::3] = rng.uniform(-0.5, 0.5, (nenv, 6))
    qpos[:, 1::3] = rng.uniform(2.4, 2.9, (nenv, 6)) * (-1.0) ** np.arange(6)
    qpos[:, 2::3] = rng.uniform(-0.3, 0.3, (nenv, 6))
    return qpos, 0.3 * rng.normal(size=(nenv, 18))


# PENDULUM with two limited hinges (2 limit rows ahead of its 33 contact
# rows: K2 takes 35 rows) and a motor on each: a force range on joint1's, a
# total actuator force range on joint2
PENDULUM_LIMITED = (worlds.PENDULUM
                    .replace('pos="0 0 0.6" axis="0 1 0"/>',
                             'pos="0 0 0.6" axis="0 1 0" range="-0.5 0.5"/>')
                    .replace('pos="0 0 0.3" axis="0 1 0"/>',
                             'pos="0 0 0.3" axis="0 1 0" range="-0.4 0.6" '
                             'actuatorfrcrange="-3 2"/>')
                    .replace("</worldbody>", "</worldbody><actuator>"
                             '<motor joint="joint1" gear="5" ctrlrange="-1 1" '
                             'forcerange="-0.6 0.8"/>'
                             '<motor joint="joint2" gear="4" ctrlrange="-1 1"/>'
                             "</actuator>"))


def humanoid_states(m, nenv: int, seed: int, drop: float = 0.0):
    """Seeded float64 HUMANOID states (qpos (nenv, 28), qvel (nenv, 27),
    ctrl (nenv, 21)) for the port's compiled HUMANOID `m`: the root `drop` m
    below its start (the feet hang 0.105 m over the floor there) with a
    small tilt, each hinge drawn from its range widened by 30% on both sides
    (some past their limits), random velocities, ctrl from [-1.5, 1.5] (the
    motors clamp it to [-1, 1])."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(m.qpos0.cpu().double().numpy(), (nenv, 1))
    qpos[:, 2] -= drop
    q = rng.normal(size=(nenv, 4)) * 0.05
    q[:, 0] += 1.0
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    rng_lo, rng_hi = (m.jnt_range[1:, k].cpu().double().numpy() for k in (0, 1))
    w = rng_hi - rng_lo
    qpos[:, 7:] = rng.uniform(rng_lo - 0.3 * w, rng_hi + 0.3 * w, size=(nenv, 21))
    qvel = 0.5 * rng.normal(size=(nenv, 27))
    ctrl = rng.uniform(-1.5, 1.5, size=(nenv, 21))
    return qpos, qvel, ctrl


# bench_config3's three noise models on SENSORS (bench.py:160-189)
SENSORS_NOISE = (SensorNoiseModel("acc", [0.0] * 3, [0.01] * 3, 0x7),
                 SensorNoiseModel("gyr", [0.0] * 3, [0.005] * 3, 0x7),
                 SensorNoiseModel("range", [0.0], [0.002], 0x1))
# SENSORS' sensors of the position and velocity stages
SENSORS_POS_VEL = ("vel", "gyr", "mag", "range", "ajp", "ajv", "probe_pos", "probe_quat")
# SENSORS with a motor on the arm's hinge: config 3's scene with a ctrl for
# the server's control noise to act on (SENSORS itself has no actuator)
SENSORS_MOTOR = worlds.SENSORS.replace("  <sensor>", """  <actuator>
    <motor name="am" joint="aj" gear="2" ctrllimited="true" ctrlrange="-1 1"/>
  </actuator>
  <sensor>""")


def sensors_states(nenv: int, seed: int):
    """Seeded float64 SENSORS states (qpos (nenv, 8), qvel (nenv, 7)): the
    probe box (half size 0.05) 0.02-0.07 m over the floor, tilted so that
    corners touch it in most envs and its rangefinder looks up (misses) in
    some, random velocities, the arm's hinge in [-1.5, 1.5]."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((nenv, 8))
    qpos[:, :2] = rng.uniform(-0.3, 0.3, size=(nenv, 2))
    qpos[:, 2] = rng.uniform(0.02, 0.07, size=nenv)
    q = rng.normal(size=(nenv, 4))
    q[:, 0] += 1.0
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qpos[:, 7] = rng.uniform(-1.5, 1.5, size=nenv)
    qvel = 0.5 * rng.normal(size=(nenv, 7))
    return qpos, qvel


# bench_config4's joint-space target for ARM7 (bench.py:204-205)
ARM7_CTRL = (0.3, -0.5, 0.4, 0.6, 2.0, -1.0, 0.5)


def arm7_states(m, nenv: int, seed: int):
    """Seeded float64 ARM7 states for the port's compiled ARM7 `m`: qpos
    (nenv, 7), qvel (nenv, 7), ctrl (nenv, 7), mocap_pos (nenv, 1, 3),
    mocap_quat (nenv, 1, 4), eq_active (nenv, 1) bool. Each hinge is drawn
    from 40% of its range around 0; every fourth env folds j1 and j3 in
    one plane (j2, j4, j5 at 0) so that the last links reach the floor
    (contacts up to about 0.1 m deep); one hinge per env other than j1 and
    j3 (whose limits would fold the arm into the floor; j6 in the folded
    envs) is put up to 0.03 rad past a limit (an active limit row); random
    velocities; ctrl
    drawn from each actuator's ctrlrange widened by 10% (some clamp). The
    mocap target is placed where the `ee_target` weld holds exactly (its
    relpose from the last link's pose), then moved 0.1-0.3 m in a random
    direction and turned by up to 0.3 rad about a random axis; the weld is
    active in every env but the first."""
    from mujoco_ros_pkgs_tpu_torch.ops import math as mmath
    from mujoco_ros_pkgs_tpu_torch.ops import smooth

    rng = np.random.default_rng(seed)
    lo, hi = (m.jnt_range[:, k].cpu().double().numpy() for k in (0, 1))
    qpos = rng.uniform(0.4 * lo, 0.4 * hi, size=(nenv, 7))
    fold = np.arange(nenv) % 4 == 3
    sign = np.where(rng.uniform(size=nenv) < 0.5, -1.0, 1.0)
    qpos[fold, 1] = (sign * rng.uniform(1.3, 1.45, size=nenv))[fold]
    qpos[fold, 3] = (sign * rng.uniform(0.8, 1.0, size=nenv))[fold]
    qpos[np.ix_(fold, [2, 4, 5])] = 0.0
    j = np.where(fold, 6, rng.choice([0, 2, 4, 5, 6], size=nenv))
    side = rng.integers(0, 2, size=nenv)
    past = rng.uniform(0.0, 0.03, size=nenv)
    qpos[np.arange(nenv), j] = np.where(side == 1, hi[j] + past, lo[j] - past)
    qvel = 0.5 * rng.normal(size=(nenv, 7))
    crng = m.actuator_ctrlrange.cpu().double().numpy()
    wide = 0.1 * (crng[:, 1] - crng[:, 0])
    ctrl = rng.uniform(crng[:, 0] - wide, crng[:, 1] + wide, size=(nenv, 7))

    e = m.eq_names.index("ee_target")
    b2 = m.eq_obj2id[e]
    data = m.eq_data[e].cpu().double()
    kin = smooth.kinematics(m.to(dtype=torch.float64), torch.from_numpy(qpos))
    # body1's pose that satisfies the weld: q1 = q2 relq^-1, p1 = p2 - R1 relpos
    q1 = mmath.quat_mul(kin.xquat[:, b2], mmath.quat_conj(data[6:10]))
    p1 = kin.xpos[:, b2] + kin.xmat[:, b2] @ data[0:3] - mmath.rot_vec_quat(data[3:6], q1)
    step = rng.normal(size=(nenv, 3))
    step *= rng.uniform(0.1, 0.3, size=(nenv, 1)) / np.linalg.norm(step, axis=1,
                                                                   keepdims=True)
    axis = rng.normal(size=(nenv, 3))
    turn = mmath.axis_angle_to_quat(
        torch.from_numpy(axis / np.linalg.norm(axis, axis=1, keepdims=True)),
        torch.from_numpy(rng.uniform(0, 0.3, size=nenv)))
    mocap_pos = (p1.numpy() + step)[:, None]
    mocap_quat = mmath.quat_mul(turn, q1).numpy()[:, None]
    eq_active = np.ones((nenv, 1), dtype=bool)
    eq_active[0] = False
    return qpos, qvel, ctrl, mocap_pos, mocap_quat, eq_active


# PILE's free bodies (models/worlds.PILE), cycled: geom type and size
_PILE_GEOMS = (("box", "0.05 0.045 0.04"), ("sphere", "0.05"),
               ("capsule", "0.04 0.05"), ("box", "0.055 0.05 0.035"),
               ("sphere", "0.045"), ("capsule", "0.035 0.06"),
               ("box", "0.05 0.04 0.05"), ("sphere", "0.055"),
               ("box", "0.045 0.05 0.045"), ("capsule", "0.045 0.045"),
               ("sphere", "0.04"), ("box", "0.04 0.055 0.05"))


def pile_of(nbody: int) -> str:
    """PILE's bin holding nbody of its bodies (nv = 6 nbody), PILE's stack
    continued: body i over the i % 12-th place of its 4 x 3 grid, 0.12 +
    0.11 i m up. pile_of(12) is PILE itself."""
    bodies = "\n".join(
        f"""    <body name="pb{i}" pos="{0.22*(i%4)-0.33:.2f} {0.22*((i%12)//4)-0.22:.2f} {0.12+0.11*i:.2f}">
      <freejoint/>
      <geom name="pg{i}" type="{t}" size="{s}" mass="0.3"
            friction="0.8 0.005 0.0001"/>
    </body>""" for i, (t, s) in ((i, _PILE_GEOMS[i % 12]) for i in range(nbody)))
    head, tail = worlds.PILE.split("  </worldbody>")
    return head[:head.index('    <body name="pb0"')] + bodies + "\n  </worldbody>" + tail


# 17 of PILE's bodies: nv 102, past K1's n = 96 (the library Cholesky's route)
PILE17 = pile_of(17)


def pile_heap(m, nenv: int, seed: int):
    """Seeded float64 heaps in a PILE-like bin for the port's compiled model
    `m` (qpos (nenv, nq), qvel (nenv, nv)): each body over its place in the
    model's 4 x 3 grid drawn 0.45 of the way to the centre (0.1 m apart),
    shifted sideways by up to 2 cm, alternately 4 and 9 cm over the floor
    (a body past the twelfth 10 cm above the one it shares a place with),
    with velocities of 0.2 m/s scale: bodies in the floor and in each other
    (on PILE 18-22 active slots an env, 5-10 of them between bodies)."""
    rng = np.random.default_rng(seed)
    nb = m.nq // 7
    qpos = np.tile(m.qpos0.cpu().double().numpy(), (nenv, 1)).reshape(nenv, nb, 7)
    qpos[..., :2] *= 0.45
    qpos[..., :2] += 0.02 * rng.uniform(-1, 1, (nenv, nb, 2))
    qpos[..., 2] = 0.04 + 0.05 * (np.arange(nb) % 2) + 0.1 * (np.arange(nb) // 12)
    return qpos.reshape(nenv, 7 * nb), 0.2 * rng.normal(size=(nenv, 6 * nb))


# BASELINE config 2's free box (worlds.BOXES: size 0.1, mass 0.5) in PILE's
# walled bin (worlds.PILE's floor and four walls): plane-box with the floor
# (4 slots) and box-box with each wall (4 x 4 slots), 20 slots and 60
# elliptic rows, on the fused step
BOX_BIN = (worlds.BOXES.replace('model="boxes_bench"', 'model="box_bin"')
           .replace('<geom name="ground" type="plane" size="10 10 1"/>',
                    worlds.PILE[worlds.PILE.index('<geom name="ground"'):
                                worlds.PILE.index('\n    <body name="pb0"')]))
# the walls' inner faces are 0.53 m from the bin's centre
_BIN_INNER = 0.53


def box_bin_states(nenv: int, seed: int):
    """Seeded BOX_BIN states (qpos (nenv, 7), qvel (nenv, 6), float32 numpy):
    the box's centre uniform over the bin's floor within 0.1 m (its half
    size) of the walls' inner faces, a uniformly random orientation,
    dropped from 0.15-0.35 m and moving at 0.5 N(0, 1) as bench.py drops
    BOXES (bench.py:148-152, `_prepare`), but for a horizontal speed of
    0.8-1.2 m/s in a random direction. Some 20% of the envs start against a
    wall (a tilted box reaches 0.17 m from its centre); at 1 m/s the rest
    reach one within about 0.4 s."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((nenv, 7), np.float32)
    half = _BIN_INNER - 0.1
    qpos[:, :2] = rng.uniform(-half, half, (nenv, 2))
    qpos[:, 2] = 0.15 + 0.2 * rng.uniform(size=nenv)
    quat = rng.normal(size=(nenv, 4))
    qpos[:, 3:] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qvel = 0.5 * rng.normal(size=(nenv, 6))
    heading = rng.uniform(0, 2 * np.pi, nenv)
    speed = rng.uniform(0.8, 1.2, nenv)
    qvel[:, 0], qvel[:, 1] = speed * np.cos(heading), speed * np.sin(heading)
    return qpos, qvel.astype(np.float32)


# PEGS(t): one free body of geom type t (mass 0.5) over a plane, among the
# static pegs its pairs have an analytic primitive for (a sphere, a
# capsule lying along y and a box turned 30 degrees about x, each 0.3 m up
# and 0.4 m from the centre); with BOX_BIN they take all twelve primitives
# of ops/narrowphase_soa.SOA_FNS onto the fused step:
#   sphere: plane_sphere, sphere_sphere, sphere_capsule, sphere_box;
#   capsule: plane_capsule, sphere_capsule, capsule_capsule, capsule_box;
#   box: plane_box, sphere_box, capsule_box, box_box;
#   cylinder: plane_cylinder, sphere_cylinder (its pairs with a capsule or
#   a box need MPR); ellipsoid: plane_ellipsoid (likewise every other pair)
PEG_GEOMS = {
    "sphere": '<geom name="peg_sphere" type="sphere" pos="0.4 0 0.3" size="0.05"/>',
    "capsule": ('<geom name="peg_capsule" type="capsule" '
                'fromto="-0.4 -0.1 0.3 -0.4 0.1 0.3" size="0.03"/>'),
    "box": ('<geom name="peg_box" type="box" pos="0 0.4 0.3" size="0.05 0.06 0.07" '
            'quat="0.96592583 0.25881905 0 0"/>'),
}
PEG_BODIES = {"sphere": ("0.06", ("sphere", "capsule", "box")),
              "capsule": ("0.04 0.08", ("sphere", "capsule", "box")),
              "box": ("0.06 0.05 0.04", ("sphere", "capsule", "box")),
              "cylinder": ("0.05 0.07", ("sphere",)),
              "ellipsoid": ("0.07 0.05 0.04", ())}


def pegs(body: str) -> str:
    """PEGS(body): the world of one free `body` geom among its pegs."""
    size, peg_types = PEG_BODIES[body]
    pegs_xml = "\n    ".join(PEG_GEOMS[t] for t in peg_types)
    return f"""
<mujoco model="pegs_{body}">
  <option timestep="0.002" gravity="0 0 -9.81" cone="elliptic"/>
  <compiler angle="radian"/>
  <worldbody>
    <geom name="ground" type="plane" size="5 5 1"/>
    {pegs_xml}
    <body name="body" pos="0 0 0.3">
      <freejoint/>
      <geom name="body" type="{body}" size="{size}" mass="0.5"
            friction="1 0.005 0.0001"/>
    </body>
  </worldbody>
</mujoco>
"""


PEGS = {t: pegs(t) for t in PEG_BODIES}


def _quat_mat(q):
    """(..., 4) unit quaternions -> (..., 3, 3) rotation matrices."""
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _pair_depth(m, g, body_geom, pos, quat):
    """The deepest contact distance (B,) of static geom g against the body's
    geom with the body at (pos, quat), by the port's plain primitive."""
    from mujoco_ros_pkgs_tpu_torch.ops import narrowphase, narrowphase_soa

    def frame(geom, bpos, bquat):
        gp = m.geom_pos[geom].double().cpu().numpy()
        gR = _quat_mat(m.geom_quat[geom].double().cpu().numpy())
        if bpos is None:
            return np.broadcast_to(gp, pos.shape), np.broadcast_to(gR, pos.shape + (3,))
        R = _quat_mat(bquat)
        return bpos + R @ gp, R @ gR

    frames = {g: frame(g, None, None), body_geom: frame(body_geom, pos, quat)}
    g1, g2 = sorted((g, body_geom), key=lambda i: (m.geom_type[i], i))
    fn = narrowphase_soa.SOA_FNS[narrowphase._DISPATCH[(m.geom_type[g1],
                                                        m.geom_type[g2])].name]
    args = []
    for geom in (g1, g2):
        p, R = (torch.from_numpy(np.ascontiguousarray(a)) for a in frames[geom])
        size = m.geom_size[geom].double().cpu()
        args += [tuple(p[:, k] for k in range(3)),
                 tuple(tuple(R[:, i, j] for j in range(3)) for i in range(3)),
                 tuple(size[k].expand(p.shape[0]) for k in range(3))]
    return torch.stack(fn(*args)[0], -1).amin(-1).numpy()


def pegs_states(m, nenv: int, seed: int):
    """Seeded PEGS states for the port's compiled PEGS model `m` (qpos
    (nenv, 7), qvel (nenv, 6), float32 numpy): env i reaches for target i %
    (pegs + 1), the plane first, in a uniformly random orientation. It
    moves in from a random direction (straight down onto the plane, 0.3 m
    about the centre) to where its geom touches the target (a bisection on
    the pair's plain primitive), then 2 cm further in to 0.5 cm short of
    it: about 80% of the envs press into their target. Velocities 0.3
    N(0, 1)."""
    rng = np.random.default_rng(seed)
    body_geom = list(m.geom_bodyid).index(1)
    targets = [g for g in range(m.ngeom) if m.geom_bodyid[g] == 0]
    target = np.arange(nenv) % len(targets)
    quat = rng.normal(size=(nenv, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    base = np.zeros((nenv, 3))
    base[:, :2] = rng.uniform(-0.3, 0.3, (nenv, 2))
    direction = rng.normal(size=(nenv, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    depth = rng.uniform(-0.005, 0.02, nenv)
    rb = m.geom_rbound.double().cpu().numpy()
    gpos = m.geom_pos.double().cpu().numpy()
    qpos = np.zeros((nenv, 7))
    for k, g in enumerate(targets):
        sel = target == k
        if m.geom_type[g] == 0:         # the plane: come down from above
            b, d = base[sel], np.broadcast_to([0.0, 0.0, 1.0], (int(sel.sum()), 3))
        else:
            b, d = np.broadcast_to(gpos[g], (int(sel.sum()), 3)), direction[sel]
        lo = np.zeros(len(b))
        hi = np.full(len(b), 2.0 * (rb[g] + rb[body_geom]) + 0.1)
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            into = _pair_depth(m, g, body_geom, b + d * mid[:, None], quat[sel]) < 0
            lo, hi = np.where(into, mid, lo), np.where(into, hi, mid)
        qpos[sel, :3] = b + d * (hi - depth[sel])[:, None]
    qpos[:, 3:] = quat
    return qpos.astype(np.float32), (0.3 * rng.normal(size=(nenv, 6))).astype(np.float32)


# a Panda-style arm with a tendon-coupled parallel gripper, after MuJoCo
# Menagerie's franka_emika_panda/panda.xml: its link offsets, joint ranges,
# inertials (the diagonal of each fullinertia), armature, damping,
# actuators and the `split` tendon; primitive geoms stand in for the
# meshes. Added to panda.xml: frictionloss 0.1 on the arm's joints, the
# tendon's limit, the floor and a free 5 cm box of 0.1 kg. Only the hand,
# the finger pads, the box and the floor collide (contype / conaffinity);
# the pads not with each other. The fingers' equality spells out solimp's
# last two values (MuJoCo's defaults), which panda.xml leaves implied.
_PANDA_JOINT = 'armature="0.1" damping="1" frictionloss="0.1"'
_PANDA_LINKS = (
    # name, body attributes, joint range, inertial pos, mass, diaginertia,
    # stand-in capsule
    ("link1", 'pos="0 0 0.333"', "-2.8973 2.8973", "0.003875 0.002081 -0.04762",
     4.970684, "0.70337 0.70661 0.009117", "0 0 -0.15 0 0 0.05"),
    ("link2", 'quat="1 -1 0 0"', "-1.7628 1.7628", "-0.003141 -0.02872 0.003495",
     0.646926, "0.007962 0.02811 0.025995", "0 0 0 0 -0.316 0"),
    ("link3", 'pos="0 -0.316 0" quat="1 1 0 0"', "-2.8973 2.8973",
     "0.027518 0.039252 -0.066502", 3.228604, "0.037242 0.036155 0.01083",
     "0 0 -0.1 0.0825 0 0"),
    ("link4", 'pos="0.0825 0 0" quat="1 1 0 0"', "-3.0718 -0.0698",
     "-0.05317 0.104419 0.027454", 3.587895, "0.025853 0.019552 0.028323",
     "0 0 0 -0.0825 0.384 0"),
    ("link5", 'pos="-0.0825 0.384 0" quat="1 -1 0 0"', "-2.8973 2.8973",
     "-0.011953 0.041065 -0.038437", 1.225946, "0.035549 0.029474 0.008627",
     "0 0 -0.2 0 0 0"),
    ("link6", 'quat="1 1 0 0"', "-0.0175 3.7525", "0.060149 -0.014117 -0.010517",
     1.666555, "0.001964 0.004354 0.005433", "0 0 0 0.088 0 0"),
    ("link7", 'pos="0.088 0 0" quat="1 1 0 0"', "-2.8973 2.8973",
     "0.010517 -0.004252 0.061597", 0.735522, "0.012516 0.010027 0.004815",
     "0 0 0 0 0 0.08"),
)
_PANDA_GAINS = (4500, 4500, 3500, 3500, 2000, 2000, 2000)


def _panda() -> str:
    hand = """
<body name="hand" pos="0 0 0.107" quat="0.9238795 0 0 -0.3826834">
  <inertial pos="-0.01 0 0.03" mass="0.73" diaginertia="0.001 0.0025 0.0017"/>
  <geom name="hand" type="box" pos="0 0 0.03" size="0.02 0.1 0.025"/>
  <site name="tcp" pos="0 0 0.1034"/>
  <body name="left_finger" pos="0 0 0.0584">
    <inertial pos="0 0 0" mass="0.015" diaginertia="2.375e-06 2.375e-06 7.5e-07"/>
    <joint name="finger_joint1" type="slide" axis="0 1 0" range="0 0.04" armature="0.1"
           damping="1"/>
    <geom name="left_pad" type="box" pos="0 0.006 0.032" size="0.008 0.006 0.022"
          contype="2" conaffinity="1"/>
  </body>
  <body name="right_finger" pos="0 0 0.0584" quat="0 0 0 1">
    <inertial pos="0 0 0" mass="0.015" diaginertia="2.375e-06 2.375e-06 7.5e-07"/>
    <joint name="finger_joint2" type="slide" axis="0 1 0" range="0 0.04" armature="0.1"
           damping="1"/>
    <geom name="right_pad" type="box" pos="0 0.006 0.032" size="0.008 0.006 0.022"
          contype="2" conaffinity="1"/>
  </body>
</body>"""
    body = hand
    for k, (name, attrs, rng, ipos, mass, inertia, capsule) in reversed(
            list(enumerate(_PANDA_LINKS))):
        body = (f'<body name="{name}" {attrs}>'
                f'<inertial pos="{ipos}" mass="{mass}" diaginertia="{inertia}"/>'
                f'<joint name="joint{k + 1}" axis="0 0 1" range="{rng}" {_PANDA_JOINT}/>'
                f'<geom type="capsule" fromto="{capsule}" size="0.05" contype="0" '
                f'conaffinity="0"/>{body}</body>')
    servos = "".join(
        f'<general name="actuator{k + 1}" joint="joint{k + 1}" gainprm="{kp}" '
        f'biastype="affine" biasprm="0 -{kp} -{kp // 10}" ctrlrange="{_PANDA_LINKS[k][2]}" '
        f'forcerange="{"-87 87" if k < 4 else "-12 12"}"/>'
        for k, kp in enumerate(_PANDA_GAINS))
    return f"""
<mujoco model="panda_pick">
  <option timestep="0.002" cone="elliptic"/>
  <compiler angle="radian"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 0.1"/>
    <body name="link0">
      <inertial pos="-0.041018 -0.00014 0.049974" mass="0.629769"
                diaginertia="0.00315 0.00388 0.004285"/>
      <geom type="capsule" fromto="0 0 0 0 0 0.2" size="0.06" contype="0" conaffinity="0"/>
      {body}
    </body>
    <body name="box" pos="0.5 0 0.025">
      <freejoint/>
      <geom name="box" type="box" size="0.025 0.025 0.025" mass="0.1"/>
    </body>
  </worldbody>
  <tendon>
    <fixed name="split" limited="true" range="0 0.04">
      <joint joint="finger_joint1" coef="0.5"/>
      <joint joint="finger_joint2" coef="0.5"/>
    </fixed>
  </tendon>
  <equality>
    <joint joint1="finger_joint1" joint2="finger_joint2" solref="0.005 1"
           solimp="0.95 0.99 0.001 0.5 2"/>
  </equality>
  <actuator>
    {servos}
    <general name="actuator8" tendon="split" ctrlrange="0 255" forcerange="-100 100"
             gainprm="0.01568627451 0 0" biastype="affine" biasprm="0 -100 -10"/>
  </actuator>
</mujoco>
"""


PANDA_PICK = _panda()
# the gripper's ctrl open and closed (actuator8: 0.0157 ctrl - 100 split)
PANDA_OPEN, PANDA_CLOSED = 255.0, 0.0
# panda.xml's `home` keyframe, where the grasp search starts
_PANDA_HOME = (0.0, 0.0, 0.0, -1.57079, 0.0, 1.57079, -0.7853)
# where the pads' midpoint is put: over the box's resting place, 1 cm above
# the box's center (the pads' lower ends 1.3 cm over the floor)
PANDA_GRASP = (0.5, 0.0, 0.035)


def _panda_pose(m, q):
    """The pads' midpoint (B, 3), the hand's x, y and z axes (B, 3) each and
    the box's geom index, from arm poses q (B, 7), fingers closed."""
    from mujoco_ros_pkgs_tpu_torch.ops import smooth

    qpos = m.qpos0.double().cpu().expand(q.shape[0], -1).clone()
    qpos[:, :7] = torch.as_tensor(q, dtype=torch.float64)
    m64 = m.to(device="cpu", dtype=torch.float64)
    kin = smooth.kinematics(m64, qpos)
    pads = [m.geom(n) for n in ("left_pad", "right_pad")]
    mid = kin.geom_xpos[:, pads].mean(1)
    R = kin.xmat[:, m.body("hand")]
    return mid.numpy(), R[..., 0].numpy(), R[..., 1].numpy(), R[..., 2].numpy()


def panda_grasp(m):
    """The arm's pose (7,) that puts the pads' midpoint at PANDA_GRASP with
    the hand pointing down: damped least squares from panda.xml's home
    pose on the model's own kinematics, by finite differences (float64)."""
    q = np.array(_PANDA_HOME)
    lo, hi = (m.jnt_range[:7, k].double().cpu().numpy() for k in (0, 1))

    def residual(qs):
        mid, _, _, z = _panda_pose(m, qs)
        return np.concatenate([mid - PANDA_GRASP, z - (0, 0, -1)], 1)
    for _ in range(60):
        r = residual(q[None])[0]
        dq = 1e-6 * np.eye(7)
        Jac = ((residual(q + dq) - r) / 1e-6).T
        q = np.clip(q - np.linalg.solve(Jac.T @ Jac + 1e-6 * np.eye(7), Jac.T @ r),
                    lo + 1e-3, hi - 1e-3)
    assert np.abs(residual(q[None])).max() < 1e-6, residual(q[None])
    return q


def panda_states(m, nenv: int, seed: int):
    """Seeded float64 PANDA_PICK states: qpos (nenv, 16), qvel (nenv, 15),
    ctrl (nenv, 8). The arm at panda_grasp's pose with each joint moved by
    N(0, 0.005) rad, the box resting on the floor between the pads (its
    center under their midpoint, turned with the hand), the arm's qvel
    N(0, 0.05); ctrl the grasp pose, the gripper open. Each finger's
    opening: every fourth env open past the 0.04 limit (and the tendon's)
    by U(0, 0.002), every fourth short of it by U(0, 0.003), and the odd
    envs closed on the box (pads up to 1 mm into it)."""
    rng = np.random.default_rng(seed)
    grasp = panda_grasp(m)
    q = grasp + 0.005 * rng.normal(size=(nenv, 7))
    mid, x, _, _ = _panda_pose(m, q)
    yaw = np.arctan2(x[:, 1], x[:, 0])
    k = np.arange(nenv) % 4
    u = rng.uniform(size=nenv)
    opening = np.select([k == 0, k == 2], [0.04 + 0.002 * u, 0.04 - 0.003 * u],
                        0.025 - 0.001 * u)
    qpos = np.zeros((nenv, 16))
    qpos[:, :7] = q
    qpos[:, 7:9] = opening[:, None]
    qpos[:, 9:11] = mid[:, :2]
    qpos[:, 11] = 0.025
    qpos[:, 12], qpos[:, 15] = np.cos(yaw / 2), np.sin(yaw / 2)
    qvel = np.zeros((nenv, 15))
    qvel[:, :7] = 0.05 * rng.normal(size=(nenv, 7))
    ctrl = np.tile(np.append(grasp, PANDA_OPEN), (nenv, 1))
    return qpos, qvel, ctrl


# PANDA_PICK on panda.xml's own integrator, implicitfast (Menagerie's arm
# files set it): its <general> servos' velocity terms (biasprm[2] = -kp / 10)
# are integrated implicitly
PANDA_PICK_IF = PANDA_PICK.replace('<option timestep="0.002" cone="elliptic"/>',
                                   '<option timestep="0.002" cone="elliptic" '
                                   'integrator="implicitfast"/>')
assert PANDA_PICK_IF != PANDA_PICK

# the implicit integrators' worlds (after tests/test_integrators_geoms.py):
# two damped hinges with a position and a velocity servo, no contacts
TWO_HINGE = """<mujoco>
<option timestep="0.002" integrator="implicitfast"><flag contact="disable"/></option>
<compiler angle="radian"/>
<worldbody><body pos="0 0 1">
<joint name="j0" type="hinge" axis="0 1 0" damping="2"/>
<geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.04"/>
<body pos="0.4 0 0"><joint name="j1" type="hinge" axis="0 1 0" damping="1"/>
<geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/></body>
</body></worldbody>
<actuator>
  <position joint="j0" kp="30" kv="6"/>
  <velocity joint="j1" kv="2"/>
</actuator></mujoco>"""
# a fast-spinning box on a ball joint with a hinged arm: the gyroscopic
# terms make implicit and implicitfast differ (qvel GYRO_QVEL0)
GYRO = """<mujoco><option timestep="0.004" integrator="implicit">
<flag contact="disable"/></option>
<compiler angle="radian"/>
<worldbody><body pos="0 0 1"><joint name="b" type="ball" damping="0.01"/>
<geom type="box" size="0.3 0.05 0.02" mass="1"/>
<body pos="0.3 0 0"><joint name="h" type="hinge" axis="0 0 1" damping="0.01"/>
<geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.02"/></body>
</body></worldbody></mujoco>"""
GYRO_QVEL0 = (25.0, 3.0, 1.0, 8.0)
# two single-hinge trees coupled by a damped fixed tendon: libmujoco's
# qDeriv holds no entry between the trees, so the coupling is dropped
CROSS_TREE_TENDON = """<mujoco>
<option timestep="0.002" integrator="implicitfast"/>
<compiler angle="radian"/>
<worldbody>
<body pos="0 0 1"><joint name="a" type="hinge" axis="0 1 0"/>
<geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/></body>
<body pos="1 0 1"><joint name="b" type="hinge" axis="0 1 0"/>
<geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/></body>
</worldbody>
<tendon><fixed damping="2"><joint joint="a" coef="1"/>
<joint joint="b" coef="-1"/></fixed></tendon></mujoco>"""


# a companion of PANDA_PICK for K2 (nv 6, at most 64 rows): a ball joint
# (limited) on a hinge chain over a plane, two fixed tendons (t1 limited,
# with friction loss, a spring with a deadband and damping) coupled by a
# tendon equality with a quadratic polycoef, a site thruster (the site
# transmission of quadrotor models such as Menagerie's Skydio X2), an
# <intvelocity>, a <damper> and a <general> with filterexact dynamics and a
# clamped activation on the tendon
TENDON_ACT = """
<mujoco model="tendon_act">
  <option timestep="0.002" cone="elliptic"/>
  <compiler angle="radian"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 0.1"/>
    <body name="base" pos="0 0 0.35">
      <joint name="ball" type="ball" range="0 0.5" damping="0.05"/>
      <geom type="capsule" fromto="0 0 0 0 0 -0.15" size="0.04" contype="1" conaffinity="0"/>
      <body name="l1" pos="0 0 -0.15">
        <joint name="h1" type="hinge" axis="0 1 0" damping="0.1" frictionloss="0.05"/>
        <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.035" contype="1" conaffinity="0"/>
        <body name="l2" pos="0.2 0 0">
          <joint name="h2" type="hinge" axis="0 1 0" damping="0.1"/>
          <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.03" contype="1" conaffinity="0"/>
          <body name="l3" pos="0.2 0 0">
            <joint name="h3" type="hinge" axis="1 0 0" damping="0.02"/>
            <geom name="tip" type="sphere" size="0.04" contype="1" conaffinity="0"/>
            <site name="thrust" pos="0 0 0.04" zaxis="0 0.3 1"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t1" limited="true" range="-0.4 0.4" frictionloss="0.2" stiffness="3"
           damping="0.2" springlength="-0.1 0.1">
      <joint joint="h1" coef="1"/>
      <joint joint="h2" coef="-0.5"/>
    </fixed>
    <fixed name="t2">
      <joint joint="h2" coef="1"/>
      <joint joint="h3" coef="0.3"/>
    </fixed>
  </tendon>
  <equality>
    <tendon tendon1="t2" tendon2="t1" polycoef="0.05 0.4 0.3 0 0" solref="0.02 1"/>
  </equality>
  <actuator>
    <general name="thruster" site="thrust" gear="0 0 1 0 0 0.1" ctrlrange="0 6"/>
    <intvelocity name="iv" joint="h3" kp="5" actrange="-1 1"/>
    <damper name="damp" joint="h2" kv="0.5" ctrlrange="0 1"/>
    <general name="filt" tendon="t1" dyntype="filterexact" dynprm="0.05" gainprm="2"
             biastype="affine" biasprm="0 -1 -0.1" ctrlrange="-1 1" actlimited="true"
             actrange="-0.5 0.5"/>
  </actuator>
</mujoco>
"""


def tendon_act_states(nenv: int, seed: int):
    """Seeded float64 TENDON_ACT states: qpos (nenv, 7), qvel (nenv, 6),
    act (nenv, 2), ctrl (nenv, 4). The ball tilted by up to 0.6 rad about
    a random horizontal axis (past its 0.5 limit in some envs), the hinges
    bent by U(-0.7, 0.7) (the tip on or into the floor and t1 past its
    range in some), random velocities, activations and ctrl (some past
    their ranges)."""
    rng = np.random.default_rng(seed)
    angle = rng.uniform(0.0, 0.6, size=nenv)
    axis = np.zeros((nenv, 3))
    axis[:, :2] = rng.normal(size=(nenv, 2))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    qpos = np.zeros((nenv, 7))
    qpos[:, 0] = np.cos(angle / 2)
    qpos[:, 1:4] = axis * np.sin(angle / 2)[:, None]
    qpos[:, 4:7] = rng.uniform(-0.7, 0.7, size=(nenv, 3))
    qvel = 0.5 * rng.normal(size=(nenv, 6))
    act = rng.uniform(-0.7, 0.7, size=(nenv, 2))
    ctrl = np.stack([rng.uniform(0, 7, nenv), rng.uniform(-1, 1, nenv),
                     rng.uniform(-0.2, 1.2, nenv), rng.uniform(-1.2, 1.2, nenv)], 1)
    return qpos, qvel, act, ctrl


def _fmt(a) -> str:
    return " ".join(f"{x:.6g}" for x in np.ravel(a))


# MESH_PILE: PILE's walled bin and stack (BASELINE config 5's scene) with
# its 12 bodies in turn a 20-point hull drawn on a 5 cm ellipsoid, a wedge
# (a 6-vertex triangular prism), a cylinder and an ellipsoid; pb0 and pb4
# do not collide (<exclude>), pg11 collides with the floor alone (contype 2
# and an explicit <pair>). Every MPR pair type (mesh-mesh of each pair of
# meshes, mesh-cylinder, cylinder-cylinder, ellipsoid against all, the
# walls' boxes against all), plane_convex and the analytic plane pairs; a
# rangefinder on a world site looks down into the bin. It starts from
# <key name="drop">: each body over its place of the stack's 4 x 3 grid,
# 7 to 10 cm over the floor, turned by a seeded rotation.
_HULL20 = np.random.default_rng(16).normal(size=(20, 3))
_HULL20 = _HULL20 / np.linalg.norm(_HULL20, axis=1, keepdims=True) * (0.05, 0.04, 0.035)
_WEDGE = ((-0.05, -0.04, -0.03), (0.05, -0.04, -0.03), (-0.05, -0.04, 0.03),
          (-0.05, 0.04, -0.03), (0.05, 0.04, -0.03), (-0.05, 0.04, 0.03))
_MESH_PILE_GEOMS = ('type="mesh" mesh="hull20"', 'type="mesh" mesh="wedge"',
                    'type="cylinder" size="0.04 0.05"',
                    'type="ellipsoid" size="0.05 0.04 0.035"')


def _mesh_pile() -> str:
    bodies = []
    for i in range(12):
        own = ' contype="2" conaffinity="2"' if i == 11 else ""
        bodies.append(
            f"""    <body name="pb{i}" pos="{0.22*(i%4)-0.33:.2f} {0.22*(i//4)-0.22:.2f} {0.12+0.11*i:.2f}">
      <freejoint/>
      <geom name="pg{i}" {_MESH_PILE_GEOMS[i % 4]} mass="0.3"
            friction="0.8 0.005 0.0001"{own}/>
    </body>""")
    rng = np.random.default_rng(17)
    qpos = []
    for i in range(12):
        q = rng.normal(size=4)
        qpos += [0.22 * (i % 4) - 0.33, 0.22 * (i // 4) - 0.22, 0.07 + 0.01 * (i % 4),
                 *(q / np.linalg.norm(q))]
    head, tail = worlds.PILE.split("  </worldbody>")
    head = head[:head.index('    <body name="pb0"')]
    head = head.replace('iterations="12"', 'iterations="12" ls_iterations="8"')
    head = head.replace('model="pile_bench"', 'model="mesh_pile"')
    head = head.replace("  <worldbody>\n", f"""  <asset>
    <mesh name="hull20" vertex="{_fmt(_HULL20)}"/>
    <mesh name="wedge" vertex="{_fmt(_WEDGE)}"/>
  </asset>
  <worldbody>
    <site name="rf" pos="0.05 0.03 1.5" zaxis="0 0 -1"/>
""")
    return (head + "\n".join(bodies) + "\n  </worldbody>" + tail.replace("</mujoco>", f"""  <contact>
    <exclude body1="pb0" body2="pb4"/>
    <pair geom1="pg11" geom2="ground"/>
  </contact>
  <sensor>
    <rangefinder name="range" site="rf"/>
  </sensor>
  <keyframe>
    <key name="drop" qpos="{_fmt(qpos)}"/>
  </keyframe>
</mujoco>"""))


MESH_PILE = _mesh_pile()
MESH_PILE_NENV = 512


def mesh_pile_heap(m, nenv: int, seed: int):
    """pile_heap's heaps turned: each body at a seeded random orientation,
    alternately 3 and 8 cm over the floor, so that hulls, cylinders and
    ellipsoids lie in the floor and in each other (float64 qpos, qvel)."""
    qpos, qvel = pile_heap(m, nenv, seed)
    rng = np.random.default_rng(seed + 1)
    nb = m.nq // 7
    qpos = qpos.reshape(nenv, nb, 7)
    q = rng.normal(size=(nenv, nb, 4))
    qpos[..., 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    qpos[..., 2] = 0.03 + 0.05 * (np.arange(nb) % 2)
    return qpos.reshape(nenv, 7 * nb), qvel


# TERRAIN: HUMANOID at its bench's batch on a 32 x 32 height field (20 m x
# 20 m, 0.3 m high, 0.1 m deep) in place of its floor, the elevation a
# seeded sum of waves and noise; the feet and limbs meet it through
# hfield_pair (a capsule 2 contacts, a sphere 1, a box 4), a rangefinder on
# the torso looks down at it; <key name="drop"> holds the humanoid's feet 2
# cm over the terrain at the centre
def _terrain() -> str:
    from mujoco_ros_pkgs_tpu_torch.models import humanoid
    rng = np.random.default_rng(18)
    u = np.linspace(0.0, 2.0 * np.pi, 32)
    elev = (np.sin(2.0 * u)[:, None] * np.cos(3.0 * u)[None, :]
            + 0.3 * rng.uniform(-1.0, 1.0, (32, 32)))
    xml = humanoid.HUMANOID.replace('model="humanoid_bench"', 'model="terrain"')
    xml = xml.replace('    <geom name="floor" type="plane" size="20 20 1"/>',
                      '    <geom name="floor" type="hfield" hfield="terrain"/>')
    xml = xml.replace("  <worldbody>", f"""  <asset>
    <hfield name="terrain" nrow="32" ncol="32" size="10 10 0.3 0.1"
            elevation="{_fmt(elev)}"/>
  </asset>
  <worldbody>""")
    xml = xml.replace('      <freejoint name="root"/>', '''      <freejoint name="root"/>
      <site name="rf" pos="0 0 -0.1" zaxis="0 0 -1"/>''')
    # the feet hang 0.105 m over z = 0 at the model's start (torso 1.3 m):
    # the key holds them 2 cm over the terrain's highest point within a
    # cell of the centre, so that they land within some 0.1 s
    norm = (elev - elev.min()) / (elev.max() - elev.min())
    top = 0.3 * float(norm[14:18, 14:18].max())
    key = np.zeros(7 + 21)
    key[:7] = (0.0, 0.0, 1.3 - 0.105 + top + 0.02, 1.0, 0.0, 0.0, 0.0)
    return xml.replace("</mujoco>", f"""  <sensor>
    <rangefinder name="range" site="rf"/>
  </sensor>
  <keyframe>
    <key name="drop" qpos="{_fmt(key)}"/>
  </keyframe>
</mujoco>""")


TERRAIN = _terrain()
TERRAIN_NENV = 1024


def look_at(pos, target) -> str:
    """The wxyz quaternion (as MJCF text) of a camera at `pos` looking at
    `target`: its -z along the view, x to the right, y up (the world's z up;
    y up when looking straight down)."""
    f = np.asarray(target, np.float64) - np.asarray(pos, np.float64)
    f /= np.linalg.norm(f)
    up = np.array([0.0, 0.0, 1.0]) if abs(f[2]) < 0.999 else np.array([0.0, 1.0, 0.0])
    x = np.cross(f, up)
    x /= np.linalg.norm(x)
    rot = np.stack([x, np.cross(x, f), -f], axis=1)         # columns: the camera's axes
    w = np.sqrt(max(1.0 + np.trace(rot), 1e-12)) / 2.0
    if w > 1e-3:
        q = np.array([w, (rot[2, 1] - rot[1, 2]) / (4 * w), (rot[0, 2] - rot[2, 0]) / (4 * w),
                      (rot[1, 0] - rot[0, 1]) / (4 * w)])
    else:                               # a half turn: from the largest diagonal
        i = int(np.argmax(np.diag(rot)))
        j, k = (i + 1) % 3, (i + 2) % 3
        r = np.sqrt(1.0 + rot[i, i] - rot[j, j] - rot[k, k])
        q = np.zeros(4)
        q[0], q[1 + i] = (rot[k, j] - rot[j, k]) / (2 * r), r / 2
        q[1 + j], q[1 + k] = (rot[j, i] + rot[i, j]) / (2 * r), (rot[k, i] + rot[i, k]) / (2 * r)
    return _fmt(q / np.linalg.norm(q))


# MESH_PILE_CAM and TERRAIN_CAM: the worlds above with cameras, which change
# no physics. MESH_PILE_CAM: a world camera over the bin looking into it, at
# pb6's place in the stack (the image's centre is on a body),
# twice at one pose: `overview` for the reference's default stream (RGB,
# 720 x 480, env 0) and `overview_px` for pixel observations of every env
# (RGB, depth and segmentation at 64 x 64); its pixels meet the floor, the
# walls' boxes, the hulls, cylinders and ellipsoids. TERRAIN_CAM: an `ego`
# camera on the humanoid's torso looking down ahead of its feet (RGB and
# depth of every env at 64 x 64): the height field, the legs' capsules and
# the feet's boxes.
_OVERVIEW = f'pos="0.11 -0.75 1.25" quat="{look_at((0.11, -0.75, 1.25), (0.11, 0.0, 0.03))}" fovy="60"'
MESH_PILE_CAM = MESH_PILE.replace(
    'model="mesh_pile"', 'model="mesh_pile_cam"').replace(
    '    <site name="rf" pos="0.05 0.03 1.5" zaxis="0 0 -1"/>\n',
    '    <site name="rf" pos="0.05 0.03 1.5" zaxis="0 0 -1"/>\n'
    f'    <camera name="overview" {_OVERVIEW}/>\n'
    f'    <camera name="overview_px" {_OVERVIEW}/>\n')
MESH_PILE_CAM_CONFIG = {
    "overview": {},
    "overview_px": {"stream_type": "RGB|DEPTH|SEGMENTED", "width": 64, "height": 64,
                    "env_ids": tuple(range(MESH_PILE_NENV))}}
TERRAIN_CAM = TERRAIN.replace('model="terrain"', 'model="terrain_cam"').replace(
    '      <site name="rf" pos="0 0 -0.1" zaxis="0 0 -1"/>\n',
    '      <site name="rf" pos="0 0 -0.1" zaxis="0 0 -1"/>\n'
    f'      <camera name="ego" pos="0.12 0 0.05" quat="{look_at((0.12, 0, 0.05), (0.8, 0, -1.2))}"'
    ' fovy="75"/>\n')
TERRAIN_CAM_CONFIG = {"ego": {"stream_type": "RGB|DEPTH", "width": 64, "height": 64,
                              "env_ids": tuple(range(TERRAIN_NENV))}}


# XLA's CPU backend contracts a multiply and an add into one FMA where the
# host has FMA instructions, so a jitted JAX function rounds otherwise than
# the same ops one at a time; MPR's discrete portal updates amplify that to
# 1e-8 in a contact's depth (the JAX package's own jit against its eager
# evaluation). Under this flag the jitted JAX package equals its op-by-op
# evaluation, which is what the port computes.
JAX_REFERENCE_XLA_FLAGS = "--xla_cpu_max_isa=AVX"


def run_jax_reference(module: str, out_path, timeout: float = 900.0) -> dict:
    """Run `python -m <module> <out_path>` from the repo's root in a process
    of its own, with JAX on the CPU in float64 and JAX_REFERENCE_XLA_FLAGS
    (a flag that must be set before XLA starts, so not in a test process
    that shares JAX with other tests); returns the arrays it saved with
    np.savez."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               XLA_FLAGS=JAX_REFERENCE_XLA_FLAGS,
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-m", module, str(out_path)], cwd=root, env=env,
                   check=True, timeout=timeout)
    with np.load(out_path) as f:
        return dict(f)


def terrain_states(m, nenv: int, seed: int):
    """humanoid_states for TERRAIN's compiled `m` (qpos, qvel, ctrl): the
    humanoid at a seeded place within 4 m of the field's centre, lowered
    until its lowest geom reaches 2 cm below the terrain's height under
    that geom's centre, so that a foot or a limb is in the terrain."""
    from mujoco_ros_pkgs_tpu_torch.ops import smooth
    from mujoco_ros_pkgs_tpu_torch.ops.hfield import sample_height
    qpos, qvel, ctrl = humanoid_states(m, nenv, seed)
    rng = np.random.default_rng(seed + 1)
    qpos[:, :2] = rng.uniform(-4.0, 4.0, size=(nenv, 2))
    m64 = m.to("cpu", torch.float64)
    kin = smooth.kinematics(m64, torch.from_numpy(qpos))
    xpos, zrow = kin.geom_xpos[:, 1:], kin.geom_xmat[:, 1:, 2].abs()   # |R[2, :]|
    size = m64.geom_size[1:]
    # each geom's reach below its centre: a sphere's radius, a capsule's
    # radius and its axis's drop, a box's half sizes along the vertical
    reach = torch.stack([size[:, 0].expand(nenv, -1),
                         size[:, 0] + size[:, 1] * zrow[..., 2], (size * zrow).sum(-1)], -1)
    kind = torch.tensor([{2: 0, 3: 1, 6: 2}[t] for t in m.geom_type[1:]])
    reach = torch.take_along_dim(reach, kind[None, :, None].expand(nenv, -1, 1), -1)[..., 0]
    z, _, _ = sample_height(m64, 0, xpos[..., 0], xpos[..., 1])
    clearance = (xpos[..., 2] - reach - z).min(1).values
    qpos[:, 2] -= clearance.numpy() + 0.02
    return qpos, qvel, ctrl


# MUSCLE_ARM: a MyoSuite-class arm of seven muscles (BASELINE config 4's
# batch, 2048 envs): a limited ball shoulder, a limited hinge elbow and
# wrist, a fingertip that presses on a table. Six muscles pull spatial
# tendons with sites on every link: over a sphere at the shoulder, round a
# cylinder at the elbow with an outside sidesite (both sides of it), round
# a sphere at the wrist with its sidesite inside, through a pulley that
# branches one tendon in two, and along a limited tendon; the seventh acts
# on the wrist joint. The probe computes the lengthrange of the wrist-joint
# muscle and of the biceps (left out below); the rest are explicit. Euler
# and Newton over at most 8 rows (4 limits, 4 rows of the fingertip's
# pyramidal cone), so K2 takes the solve. Its sensors cover all 36 types.
MUSCLE_ARM_TABLE_TOP = 0.42
MUSCLE_ARM = f"""
<mujoco model="muscle_arm">
  <option timestep="0.002"/>
  <default>
    <geom contype="0" conaffinity="0"/>
    <muscle ctrllimited="true" ctrlrange="0 1"/>
  </default>
  <worldbody>
    <geom name="table" type="box" pos="0.45 0 {MUSCLE_ARM_TABLE_TOP - 0.02}" size="0.3 0.3 0.02"
          contype="1" conaffinity="1"/>
    <site name="s_torso_hi" pos="-0.04 0 0.95"/>
    <site name="s_torso_front" pos="-0.03 0 0.86"/>
    <site name="s_torso_lo" pos="-0.02 0 0.68"/>
    <body name="upper" pos="0 0 0.8">
      <joint name="shoulder" type="ball" range="0 70" damping="0.3"/>
      <geom name="upper_arm" type="capsule" fromto="0 0 0 0.28 0 -0.1" size="0.03"/>
      <geom name="shoulder_wrap" type="sphere" size="0.045" mass="0.01"/>
      <geom name="elbow_wrap" type="cylinder" pos="0.28 0 -0.1" zaxis="0 1 0"
            size="0.03 0.04" mass="0.01"/>
      <site name="ss_shoulder" pos="0.02 0 0.07"/>
      <site name="s_upper_front" pos="0.16 0 -0.02"/>
      <site name="s_upper_mid" pos="0.12 0.02 -0.07"/>
      <site name="s_upper_back" pos="0.18 0 -0.1"/>
      <site name="ss_elbow_front" pos="0.3 0 -0.04"/>
      <site name="ss_elbow_back" pos="0.25 0 -0.16"/>
      <site name="imu_upper" pos="0.14 0 -0.05"/>
      <body name="fore" pos="0.28 0 -0.1">
        <joint name="elbow" type="hinge" axis="0 1 0" range="-5 125" damping="0.1"/>
        <geom name="forearm" type="capsule" fromto="0 0 0 0.25 0 0" size="0.025"/>
        <geom name="wrist_wrap" type="sphere" pos="0.25 0 0" size="0.02" mass="0.005"/>
        <site name="s_fore_prox" pos="0.06 0 0.03"/>
        <site name="s_fore_dist" pos="0.2 0 0.025"/>
        <site name="s_fore_under" pos="0.14 0 -0.03"/>
        <site name="ss_wrist_in" pos="0.252 0 -0.004"/>
        <body name="hand" pos="0.25 0 0">
          <joint name="wrist" type="hinge" axis="0 1 0" range="-60 60" damping="0.05"/>
          <geom name="palm" type="box" pos="0.04 0 0" size="0.04 0.03 0.01"/>
          <geom name="tip" type="sphere" pos="0.09 0 0" size="0.015" contype="1"
                conaffinity="1"/>
          <site name="s_hand_top" pos="0.04 0 0.02"/>
          <site name="s_hand_bot" pos="0.04 0 -0.02"/>
          <site name="fingertip" pos="0.09 0 0"/>
          <site name="range" pos="0.05 0 -0.012" zaxis="0 0 -1"/>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
    <spatial name="t_delt">
      <site site="s_torso_front"/><geom geom="shoulder_wrap" sidesite="ss_shoulder"/>
      <site site="s_upper_front"/>
    </spatial>
    <spatial name="t_biceps">
      <site site="s_torso_hi"/><site site="s_upper_front"/>
      <geom geom="elbow_wrap" sidesite="ss_elbow_front"/><site site="s_fore_prox"/>
    </spatial>
    <spatial name="t_triceps">
      <site site="s_torso_lo"/><site site="s_upper_back"/>
      <geom geom="elbow_wrap" sidesite="ss_elbow_back"/><site site="s_fore_under"/>
    </spatial>
    <spatial name="t_flexor">
      <site site="s_fore_under"/><geom geom="wrist_wrap" sidesite="ss_wrist_in"/>
      <site site="s_hand_bot"/>
    </spatial>
    <spatial name="t_extensor" limited="true" range="0.08 0.12">
      <site site="s_fore_dist"/><site site="s_hand_top"/>
    </spatial>
    <spatial name="t_brach">
      <site site="s_torso_lo"/><site site="s_upper_mid"/>
      <pulley divisor="2"/>
      <site site="s_upper_mid"/><site site="s_fore_prox"/>
      <pulley divisor="2"/>
      <site site="s_upper_mid"/><site site="s_fore_under"/>
    </spatial>
  </tendon>
  <actuator>
    <muscle name="delt" tendon="t_delt" lengthrange="0.1 0.3" force="60"/>
    <muscle name="biceps" tendon="t_biceps" force="80" tausmooth="0.02"/>
    <muscle name="triceps" tendon="t_triceps" lengthrange="0.15 0.45" force="80"/>
    <muscle name="flexor" tendon="t_flexor" lengthrange="0.08 0.18" scale="300"/>
    <muscle name="extensor" tendon="t_extensor" lengthrange="0.05 0.12" force="30"/>
    <muscle name="brach" tendon="t_brach" lengthrange="0.2 0.45" force="50"/>
    <muscle name="wrist_m" joint="wrist" gear="0.03" force="20"/>
  </actuator>
  <sensor>
    <touch name="touch" site="fingertip"/>
    <accelerometer name="acc" site="imu_upper"/>
    <velocimeter name="vel" site="imu_upper"/>
    <gyro name="gyro" site="imu_upper"/>
    <force name="force" site="imu_upper"/>
    <torque name="torque" site="imu_upper"/>
    <magnetometer name="mag" site="fingertip"/>
    <rangefinder name="range" site="range"/>
    <jointpos name="elbow_pos" joint="elbow"/>
    <jointvel name="elbow_vel" joint="elbow"/>
    <tendonpos name="biceps_len" tendon="t_biceps"/>
    <tendonvel name="biceps_vel" tendon="t_biceps"/>
    <actuatorpos name="flexor_len" actuator="flexor"/>
    <actuatorvel name="flexor_vel" actuator="flexor"/>
    <actuatorfrc name="biceps_frc" actuator="biceps"/>
    <actuatorfrc name="wrist_frc" actuator="wrist_m"/>
    <ballquat name="shoulder_quat" joint="shoulder"/>
    <ballangvel name="shoulder_angvel" joint="shoulder"/>
    <jointlimitpos name="elbow_lim_pos" joint="elbow"/>
    <jointlimitvel name="elbow_lim_vel" joint="elbow"/>
    <jointlimitfrc name="elbow_lim_frc" joint="elbow"/>
    <jointlimitfrc name="wrist_lim_frc" joint="wrist"/>
    <tendonlimitpos name="ext_lim_pos" tendon="t_extensor"/>
    <tendonlimitvel name="ext_lim_vel" tendon="t_extensor"/>
    <tendonlimitfrc name="ext_lim_frc" tendon="t_extensor"/>
    <framepos name="tip_pos" objtype="site" objname="fingertip"/>
    <framepos name="tip_in_fore" objtype="site" objname="fingertip" reftype="body" refname="fore"/>
    <framequat name="hand_quat" objtype="xbody" objname="hand"/>
    <framexaxis name="hand_x" objtype="body" objname="hand"/>
    <frameyaxis name="fore_y" objtype="geom" objname="forearm" reftype="site" refname="imu_upper"/>
    <framezaxis name="range_z" objtype="site" objname="range"/>
    <framelinvel name="tip_vel" objtype="site" objname="fingertip"/>
    <framelinvel name="tip_vel_rel" objtype="site" objname="fingertip" reftype="xbody" refname="upper"/>
    <frameangvel name="hand_angvel" objtype="body" objname="hand"/>
    <frameangvel name="hand_angvel_rel" objtype="body" objname="hand" reftype="body" refname="fore"/>
    <framelinacc name="tip_acc" objtype="site" objname="fingertip"/>
    <frameangacc name="hand_angacc" objtype="xbody" objname="hand"/>
    <subtreecom name="arm_com" body="upper"/>
    <subtreelinvel name="fore_linvel" body="fore"/>
    <subtreeangmom name="arm_angmom" body="upper"/>
    <clock name="clock"/>
  </sensor>
</mujoco>
"""
MUSCLE_ARM_NENV = 2048

# SWIMMER: dm_control suite's swimmer (suite/swimmer.xml, six links) in a
# medium (BASELINE config 1's batch, 4096 envs): a planar head (two slides
# and a hinge) and a chain of six links on motorised hinges, the head and
# the first three links under the inertia-box model, the last three under
# the ellipsoid model (fluidshape on their capsules), implicitfast. Contacts
# are off, as in the suite; the joints' limits give 6 rows.
SWIMMER_NLINK = 6


def _swimmer() -> str:
    def link(i: int) -> str:
        fluid = ' fluidshape="ellipsoid" fluidcoef="0.5 0.25 1.5 1.0 1.0"' \
            if i >= SWIMMER_NLINK // 2 else ""
        inner = link(i + 1) if i + 1 < SWIMMER_NLINK else ""
        return f"""
      <body name="segment_{i}" pos="0 -0.1 0">
        <joint name="joint_{i}" type="hinge" pos="0 0.05 0" axis="0 0 1" limited="true"
               range="-100 100" solreflimit="0.05 1" solimplimit="0 0.8 0.1 0.5 2" armature="1e-6"/>
        <geom name="inertial_{i}" type="box" size="0.001 0.05 0.01" mass="0.01"/>
        <geom name="visual_{i}" type="capsule" size="0.01" fromto="0 0.05 0 0 -0.05 0"
              mass="0"{fluid}/>
        <site name="site_{i}"/>{inner}
      </body>"""
    motors = "\n".join(f'    <motor name="motor_{i}" joint="joint_{i}"/>'
                       for i in range(SWIMMER_NLINK))
    return f"""
<mujoco model="swimmer">
  <option timestep="0.002" density="3000" viscosity="0.0009" wind="0.02 -0.01 0"
          integrator="implicitfast">
    <flag contact="disable"/>
  </option>
  <default>
    <motor gear="5e-4" ctrllimited="true" ctrlrange="-1 1"/>
  </default>
  <worldbody>
    <geom name="ground" type="plane" size="2 2 0.1"/>
    <body name="head" pos="0 0 0.05">
      <joint name="rootx" type="slide" axis="1 0 0"/>
      <joint name="rooty" type="slide" axis="0 1 0"/>
      <joint name="rootz" type="hinge" axis="0 0 1"/>
      <geom name="head_inertial" type="box" size="0.001 0.05 0.01" mass="0.01"/>
      <geom name="head_visual" type="capsule" size="0.01" fromto="0 0.05 0 0 -0.05 0" mass="0"/>
      <geom name="nose" type="sphere" pos="0 0.065 0" size="0.004" mass="0"/>
      <site name="head"/>{link(0)}
    </body>
  </worldbody>
  <actuator>
{motors}
  </actuator>
  <sensor>
    <framepos name="nose_pos" objtype="geom" objname="nose"/>
    <framequat name="head_quat" objtype="xbody" objname="head"/>
    <framexaxis name="head_x" objtype="xbody" objname="head"/>
    <framezaxis name="tail_z" objtype="body" objname="segment_{SWIMMER_NLINK - 1}"/>
    <framelinvel name="head_vel" objtype="site" objname="head"/>
    <frameangvel name="head_angvel" objtype="site" objname="head"/>
    <framelinacc name="head_acc" objtype="site" objname="head"/>
    <frameangacc name="head_angacc" objtype="body" objname="head"/>
    <velocimeter name="head_velocimeter" site="head"/>
    <gyro name="head_gyro" site="head"/>
    <accelerometer name="head_accel" site="head"/>
    <subtreecom name="com" body="head"/>
    <subtreelinvel name="com_vel" body="head"/>
    <subtreeangmom name="angmom" body="head"/>
    <jointpos name="joint_0_pos" joint="joint_0"/>
    <jointvel name="joint_0_vel" joint="joint_0"/>
    <actuatorfrc name="motor_0_frc" actuator="motor_0"/>
    <jointlimitpos name="joint_5_lim" joint="joint_{SWIMMER_NLINK - 1}"/>
    <clock name="clock"/>
  </sensor>
</mujoco>
"""


SWIMMER = _swimmer()
SWIMMER_NENV = 4096


# full-ctrl travelling waves along SWIMMER's links, as a swimming policy
# drives them: (Hz, bang-bang or sine)
SWIMMER_GAITS = ((0.5, True), (1.0, False), (1.5, True))


def swimmer_gait_states(nstep: int = 4000, every: int = 10):
    """libmujoco's SWIMMER (the `mujoco` package, CPU) from rest under each
    of SWIMMER_GAITS for nstep steps: (the links' speeds at every step
    (len(SWIMMER_GAITS) nstep, 6), and qpos, qvel, ctrl of every `every`th
    step)."""
    import mujoco

    mm = mujoco.MjModel.from_xml_string(SWIMMER)
    md = mujoco.MjData(mm)
    wave = -2 * np.pi * np.arange(mm.nu) / mm.nu
    speeds, visited = [], []
    for freq, bang in SWIMMER_GAITS:
        mujoco.mj_resetData(mm, md)
        for k in range(nstep):
            u = np.sin(2 * np.pi * freq * k * mm.opt.timestep + wave)
            md.ctrl[:] = np.sign(u) if bang else u
            mujoco.mj_step(mm, md)
            speeds.append(np.abs(md.qvel[3:]))
            if k % every == 0:
                visited.append((md.qpos.copy(), md.qvel.copy(), md.ctrl.copy()))
    return np.asarray(speeds), tuple(np.array(x) for x in zip(*visited))


def with_lengthranges(xml: str, ranges: dict) -> str:
    """`xml` with lengthrange="lo hi" (full precision) written into each
    <muscle> or <general> named in `ranges` ({name: (lo, hi)}) that has
    none, so that a compile of the result runs no lengthrange probe."""
    import re

    def fill(match):
        tag = match.group(0)
        name = re.search(r'name="([^"]*)"', tag)
        if name is None or "lengthrange=" in tag or name.group(1) not in ranges:
            return tag
        lo, hi = ranges[name.group(1)]
        return tag.replace(f'name="{name.group(1)}"', f'name="{name.group(1)}" '
                           f'lengthrange="{float(lo)!r} {float(hi)!r}"', 1)
    return re.sub(r"<(muscle|general)\b[^>]*>", fill, xml)


# the lengthranges the port's probe computes for MUSCLE_ARM's two automatic
# muscles (float64 on the CPU; tests/test_torch_muscle.py holds the probe to
# them) and MUSCLE_ARM with them written in, which compiles without a probe
MUSCLE_ARM_PROBED = {"biceps": (0.31999426013797505, 0.5688555596012015),
                     "wrist_m": (-0.03141592653589793, 0.03141592653589793)}
MUSCLE_ARM_EXPLICIT = with_lengthranges(MUSCLE_ARM, MUSCLE_ARM_PROBED)


def muscle_arm_states(m, nenv: int, seed: int):
    """Seeded float64 MUSCLE_ARM states (qpos, qvel, act, ctrl): the
    shoulder turned by up to 20 degrees about z, the elbow bent by 0-100
    degrees (-12 to -6 in every eighth env: past its -5 limit) and the wrist by -30-30, then the shoulder pitched about y (by
    bisection on the port's kinematics) until the fingertip's lowest point
    is U(-4, 20) mm above the table (in contact in about a sixth of the
    envs); small random velocities, activations U(0, 0.6), ctrl U(0, 1)."""
    from mujoco_ros_pkgs_tpu_torch.ops import smooth
    rng = np.random.default_rng(seed)
    yaw = np.deg2rad(rng.uniform(-20, 20, nenv))
    qpos = np.zeros((nenv, m.nq))
    qpos[:, 4] = np.deg2rad(rng.uniform(0, 100, nenv))
    qpos[::8, 4] = np.deg2rad(rng.uniform(-12, -6, len(qpos[::8])))   # past the limit
    qpos[:, 5] = np.deg2rad(rng.uniform(-30, 30, nenv))
    target = MUSCLE_ARM_TABLE_TOP + 0.015 + rng.uniform(-0.004, 0.02, nenv)
    m64 = m.to("cpu", torch.float64)
    tip = m.geom("tip")
    lo, hi = np.full(nenv, np.deg2rad(-40.0)), np.full(nenv, np.deg2rad(50.0))
    for _ in range(50):
        pitch = 0.5 * (lo + hi)
        # q = q_yaw(z) q_pitch(y)
        cy, sy, cp, sp = np.cos(yaw / 2), np.sin(yaw / 2), np.cos(pitch / 2), np.sin(pitch / 2)
        qpos[:, :4] = np.stack([cy * cp, -sy * sp, cy * sp, sy * cp], 1)
        z = smooth.kinematics(m64, torch.from_numpy(qpos)).geom_xpos[:, tip, 2].numpy()
        low = z < target             # pitched too far down: pitch less
        hi = np.where(low, pitch, hi)
        lo = np.where(low, lo, pitch)
    qvel = 0.3 * rng.normal(size=(nenv, m.nv))
    act = rng.uniform(0.0, 0.6, size=(nenv, m.na))
    ctrl = rng.uniform(0.0, 1.0, size=(nenv, m.nu))
    return qpos, qvel, act, ctrl


def swimmer_states(m, nenv: int, seed: int, link_speed: float = 2.0):
    """Seeded float64 SWIMMER states (qpos, qvel, ctrl): the head anywhere
    within 0.5 m and at any heading, each link bent by U(-60, 60) degrees,
    normal velocities (0.04 m/s of the head, 0.8 rad/s of its heading,
    `link_speed` rad/s of each link) and ctrl U(-1, 1). At the default the
    links' speeds have a higher 99th percentile (5.2 rad/s) and peak than
    libmujoco's swimmer reaches under SWIMMER_GAITS
    (tests/test_torch_fluid.py::test_swimmer_states_cover_libmujoco_gaits).
    Unlike a gait's, these speeds are uncorrelated from link to link, and
    in about 1 env in 1000 they make implicitfast's M - h qD indefinite, in
    the JAX package as in the port (ROADMAP C14;
    scripts/swimmer_definiteness.py counts them)."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((nenv, m.nq))
    qpos[:, :2] = rng.uniform(-0.5, 0.5, size=(nenv, 2))
    qpos[:, 2] = rng.uniform(-np.pi, np.pi, nenv)
    qpos[:, 3:] = np.deg2rad(rng.uniform(-60, 60, size=(nenv, m.nq - 3)))
    qvel = rng.normal(size=(nenv, m.nv)) * np.r_[0.04, 0.04, 0.8,
                                                 [link_speed] * (m.nv - 3)]
    ctrl = rng.uniform(-1.0, 1.0, size=(nenv, m.nu))
    return qpos, qvel, ctrl
