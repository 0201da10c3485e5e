"""Forward entry points: batched Data construction, forward and the step.

Counterpart of mujoco_ros_pkgs_tpu/ops/forward.py. `step` takes one of two
routes, chosen once per model by `make_plan`:

- the fused route (ops/step_tpu.py) for single-free-body models it
  supports, one launch of the K3 kernel per step on CUDA;
- the general route: `forward` (smooth dynamics, collision, contact rows,
  the constraint solve) then the model's integrator: `euler`, `implicitfast`
  (K1 on the damped matrix), `implicit` (d qfrc_bias / d qvel by
  forward-mode AD, an LU solve) or `rk4` (four forward calls a step). The
  K1 kernel runs the mass-matrix and damping solves on CUDA; a Newton
  solve runs the K2 kernel where it takes the system (nv <= 16, at most 64
  rows: PENDULUM) and otherwise the general Newton of ops/solver.py, whose
  Hessian solves run K1 (PILE: nv 72, 783 rows; 192 with con_topk=64); CG
  and PGS (ops/solver.py) run K1 for their M^-1 solves. Past nv = 96
  every solve takes the library Cholesky (linalg_tpu.solve), as the JAX
  package's XLA solve.
  The broadphase (pair_topk) and active-contact (con_topk) compactions
  run on the general route; pair_topk refuses the fused route.

The general route takes joint-limit rows of hinges, slides and ball
joints, friction-loss rows of dofs and fixed tendons, tendon limits,
joint-transmission motors (HUMANOID: nv 27, 21 limit rows, 21 motors),
position and velocity servos, `<general>` / `<intvelocity>` / `<damper>`
and `<muscle>` actuators with their activations (integrated by `_advance`)
on joint, tendon and site transmissions, fixed and spatial tendons
(PANDA_PICK's gripper, MUSCLE_ARM's wrapped muscles), fluid forces of both
models (SWIMMER, with their d / d qvel in the implicit integrators), mocap
bodies and connect, weld, joint and tendon equality rows (ARM7: nv 7, a
mocap-target weld, 100 rows), all 36 sensor types (SENSORS, MUSCLE_ARM,
SWIMMER) and step hooks: a control hook before actuation and a passive
hook after the passive forces, pure functions of (m, d) or, with a hook
state, of (m, d, hstate) returning (d, hstate). Any hook forces the
general route, as in the JAX package. Every geom pair collides on the
general route: MPR pairs, meshes and height fields (ops/gjk.py,
ops/hfield.py) keep a model off the fused route.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch
from torch.autograd import forward_ad as fwAD

from mujoco_ros_pkgs_tpu_torch.core.assemble import SENSOR_DIM
from mujoco_ros_pkgs_tpu_torch.core.types import (
    BiasType, Data, DisableBit, DynType, GainType, IntegratorType, JointType, Model,
    SensorType,
)
from mujoco_ros_pkgs_tpu_torch.ops import collision, constraint, efc
from mujoco_ros_pkgs_tpu_torch.ops import linalg_tpu, narrowphase
from mujoco_ros_pkgs_tpu_torch.ops import math as mmath
from mujoco_ros_pkgs_tpu_torch.ops import sensor, sensor_impl, smooth, step_tpu

# (m, d) -> d, or (m, d, hstate) -> (d, hstate) when a hook state is threaded
Hook = Optional[Callable[..., Any]]


def make_data(m: Model, nenv: int) -> Data:
    """A batch of `nenv` envs at qpos0 (mj_makeData + mj_resetData), on the
    model's device, in the model's float dtype: the mocap bodies at their
    model pose, the equalities active as eq_active0 says, activations 0."""
    dev = m.device
    dtype = m.qpos0.dtype

    def z(*shape):
        return torch.zeros((nenv,) + shape, dtype=dtype, device=dev)

    def eye(n, k):
        return torch.eye(k, dtype=dtype, device=dev).expand(nenv, n, k, k).clone()
    xquat = z(m.nbody, 4)
    xquat[..., 0] = 1.0
    nefc = max(efc.row_layout(m)["nrow"], 1)
    mocap_pos, mocap_quat = smooth.mocap_defaults(m, nenv, dtype, dev)
    return Data(
        time=z(), qpos=m.qpos0.expand(nenv, m.nq).clone(),
        qvel=z(m.nv), act=z(m.na), qacc=z(m.nv), qacc_warmstart=z(m.nv), ctrl=z(m.nu),
        qfrc_applied=z(m.nv), xfrc_applied=z(m.nbody, 6),
        eq_active=torch.tensor(m.eq_active0, dtype=torch.bool, device=dev)
        .reshape(1, m.neq).expand(nenv, m.neq).clone(),
        mocap_pos=mocap_pos.clone(), mocap_quat=mocap_quat.clone(),
        xpos=z(m.nbody, 3), xquat=xquat, xmat=eye(m.nbody, 3),
        xipos=z(m.nbody, 3), ximat=eye(m.nbody, 3), xanchor=z(m.njnt, 3),
        xaxis=z(m.njnt, 3), geom_xpos=z(m.ngeom, 3), geom_xmat=eye(m.ngeom, 3),
        site_xpos=z(m.nsite, 3), site_xmat=eye(m.nsite, 3),
        subtree_com=z(m.nbody, 3), cinert=z(m.nbody, 10), cdof=z(m.nv, 6),
        cvel=z(m.nbody, 6), cdof_dot=z(m.nv, 6), qM=z(m.nv, m.nv),
        qfrc_bias=z(m.nv), qfrc_passive=z(m.nv), qfrc_actuator=z(m.nv),
        qfrc_smooth=z(m.nv), qacc_smooth=z(m.nv), qfrc_constraint=z(m.nv),
        actuator_length=z(m.nu), actuator_velocity=z(m.nu), actuator_force=z(m.nu),
        actuator_moment=z(m.nu, m.nv), act_dot=z(m.na),
        ten_length=z(m.ntendon), ten_J=z(m.ntendon, m.nv), ten_velocity=z(m.ntendon),
        contact=narrowphase.empty_contact(m, nenv, dtype, dev),
        efc_force_contact=z(nefc), sensordata=z(m.nsensordata))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _call(hook, m, d, hstate, stateful):
    if stateful:
        return hook(m, d, hstate)
    return hook(m, d), hstate


def forward(m: Model, d: Data, control_hook: Hook = None,
            passive_hook: Hook = None, hstate=None):
    """mj_forward: the whole dynamics computation, no integration, with the
    sensor stages and the hooks where the JAX package puts them. Returns
    (d, hstate) when a hook state is given, else d."""
    stateful = hstate is not None
    d = smooth.fwd_position_smooth(m, d)
    d = collision.collide(m, d)
    d = sensor.sensor_pos(m, d)
    d = smooth.passive(m, smooth.com_vel(m, d))
    if passive_hook is not None:
        d, hstate = _call(passive_hook, m, d, hstate, stateful)
    d = smooth.rne(m, d)
    d = sensor.sensor_vel(m, d)
    if control_hook is not None:
        d, hstate = _call(control_hook, m, d, hstate, stateful)
    d = smooth.actuation(m, d)
    d = smooth.fwd_acceleration_smooth(m, d)
    d = constraint.fwd_constraint(m, d)
    d = sensor.sensor_acc(m, d)
    return (d, hstate) if stateful else d


# ---------------------------------------------------------------------------
# position integration (mj_integratePos) and Euler
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=128)
def _intpos_meta(jnt_type, jnt_qposadr, jnt_dofadr):
    """Static index groups: 1-dof joints and free translations (one batched
    update), quaternion blocks of ball and free joints (qpos (k, 4), qvel
    (k, 3))."""
    lin_q, lin_v, quat_q, quat_v = [], [], [], []
    for jt, qadr, vadr in zip(jnt_type, jnt_qposadr, jnt_dofadr):
        if jt == int(JointType.FREE):
            lin_q += [qadr, qadr + 1, qadr + 2]
            lin_v += [vadr, vadr + 1, vadr + 2]
            quat_q.append(qadr + 3)
            quat_v.append(vadr + 3)
        elif jt == int(JointType.BALL):
            quat_q.append(qadr)
            quat_v.append(vadr)
        else:
            lin_q.append(qadr)
            lin_v.append(vadr)
    qq = np.array(quat_q, dtype=np.int64)
    return (np.array(lin_q, dtype=np.int64), np.array(lin_v, dtype=np.int64),
            qq[:, None] + np.arange(4), np.array(quat_v, dtype=np.int64)[:, None]
            + np.arange(3))


def integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor, dt) -> torch.Tensor:
    lin_q, lin_v, quat_q, quat_v = _intpos_meta(m.jnt_type, m.jnt_qposadr,
                                                m.jnt_dofadr)
    dev = qpos.device
    out = qpos.clone()
    if lin_q.size:
        lq = mmath.static_tensor(lin_q, dev)
        out[:, lq] = qpos[:, lq] + dt * qvel[:, mmath.static_tensor(lin_v, dev)]
    if quat_q.size:
        qq = mmath.static_tensor(quat_q, dev)
        out[:, qq] = mmath.quat_integrate(
            qpos[:, qq], qvel[:, mmath.static_tensor(quat_v, dev)], dt)
    return out


@functools.lru_cache(maxsize=128)
def _act_slot_meta(actuator_dyntype, actuator_actadr, actuator_actlimited, na):
    """Per activation slot: its actuator, whether its dynamics are
    FILTEREXACT and whether actrange clamps it (mj_advance)."""
    src = np.zeros(na, dtype=np.int64)
    exact = np.zeros(na, dtype=bool)
    lim = np.zeros(na, dtype=bool)
    for i, (dyn, adr) in enumerate(zip(actuator_dyntype, actuator_actadr)):
        if adr >= 0:
            src[adr] = i
            exact[adr] = dyn == int(DynType.FILTEREXACT)
            lim[adr] = bool(actuator_actlimited[i])
    return src, exact, lim


def _advance(m: Model, d: Data, qacc: torch.Tensor) -> Data:
    """mj_advance: qvel += h qacc, qpos integrated with the new qvel, act
    += h act_dot (FILTEREXACT's activations by the exact update act +=
    act_dot tau (1 - exp(-h / tau))), clamped to actrange where
    actlimited."""
    h = m.opt.timestep.to(d.qpos.dtype)
    qvel = d.qvel + h * qacc
    act = d.act
    if m.na:
        src, exact, lim = _act_slot_meta(m.actuator_dyntype, m.actuator_actadr,
                                         m.actuator_actlimited, m.na)
        dev = d.qpos.device
        srct = mmath.static_tensor(src, dev)
        act = d.act + h * d.act_dot
        if exact.any():
            tau = torch.clamp(m.actuator_dynprm[srct, 0], min=mmath.MINVAL)
            act = torch.where(mmath.static_tensor(exact, dev),
                              d.act + d.act_dot * tau * (1.0 - torch.exp(-h / tau)), act)
        if lim.any():
            rng = m.actuator_actrange[srct]
            act = torch.where(mmath.static_tensor(lim, dev),
                              torch.clamp(act, rng[:, 0], rng[:, 1]), act)
    return d.replace(qpos=integrate_pos(m, d.qpos, qvel, h), qvel=qvel, act=act,
                     time=d.time + h)


def euler(m: Model, d: Data) -> Data:
    """mj_Euler: semi-implicit, implicit in joint damping when present (a
    solve of M + h diag(damping), K1 up to nv = 96)."""
    qacc = d.qacc
    if m.has_damping:
        h = m.opt.timestep.to(d.qpos.dtype)
        MhB = d.qM + torch.diag_embed(h * m.dof_damping.to(d.qpos.dtype))
        qacc = linalg_tpu.solve(MhB, d.qfrc_smooth + d.qfrc_constraint)
    return _advance(m, d, qacc)


# ---------------------------------------------------------------------------
# implicitfast, implicit and RK4
# ---------------------------------------------------------------------------

def _qderiv_smooth(m: Model, d: Data) -> torch.Tensor:
    """d (qfrc_passive + qfrc_actuator) / d qvel (B, nv, nv), the terms of
    mjd_smooth_vel that implicitfast and implicit share: joint damping,
    tendon damping through ten_J^T ten_J, and the affine actuators'
    dgain input + dbias through moment^T (dfdv moment), with ctrl clamped
    as actuation clamps it and the activation as input where an actuator
    has dynamics, and where the model has a medium the fluid forces' d
    qfrc_fluid / d qvel through com_vel (fluid_jacobian)."""
    dtype = d.qpos.dtype
    dev = d.qpos.device
    qD = -torch.diag_embed(m.dof_damping.to(dtype)).expand(d.qvel.shape[0], -1, -1)
    if m.ntendon:
        qD = qD - torch.einsum("btv,t,btw->bvw", d.ten_J, m.tendon_damping.to(dtype), d.ten_J)
    if m.nu:
        ctrl = d.ctrl
        if not m.opt.disableflags & DisableBit.CLAMPCTRL:
            rng = m.actuator_ctrlrange
            ctrl = torch.where(
                mmath.static_tensor(np.array(m.actuator_ctrllimited, dtype=bool), dev),
                torch.clamp(ctrl, rng[:, 0], rng[:, 1]), ctrl)
        inp = ctrl
        dyn = np.asarray(m.actuator_dyntype)
        if (dyn != int(DynType.NONE)).any():
            adr = np.where(dyn != int(DynType.NONE), np.asarray(m.actuator_actadr), 0)
            inp = torch.where(mmath.static_tensor(dyn != int(DynType.NONE), dev),
                              d.act[:, mmath.static_tensor(adr, dev)], ctrl)
        dgain = torch.where(mmath.static_tensor(
            np.asarray(m.actuator_gaintype) == int(GainType.AFFINE), dev),
            m.actuator_gainprm[:, 2], 0.0)
        dbias = torch.where(mmath.static_tensor(
            np.asarray(m.actuator_biastype) == int(BiasType.AFFINE), dev),
            m.actuator_biasprm[:, 2], 0.0)
        dfdv = dgain * inp + dbias                                    # (B, nu)
        qD = qD + d.actuator_moment.mT @ (dfdv[..., None] * d.actuator_moment)
    if m.has_fluid:
        qD = qD + fluid_jacobian(m, d)
    return qD


@functools.lru_cache(maxsize=128)
def _qderiv_sparsity_meta(body_parentid, body_dofnum, body_dofadr, dof_simple, nv,
                          simple_truncate):
    """The structural mask of libmujoco's sparse qDeriv (the JAX package's
    rule, pinned there against libmujoco): entries only for pairs of dofs
    on one chain to the root, so a fixed tendon's damping between two trees
    is dropped; implicitfast, which stores its matrix in qM's sparsity,
    also drops every off-diagonal entry of a 'simple' dof (dof_simple);
    implicit keeps the ancestor pairs alone."""
    nbody = len(body_parentid)
    amask = np.zeros((nv, nv), dtype=bool)
    body_dofs = [list(range(body_dofadr[b], body_dofadr[b] + body_dofnum[b]))
                 for b in range(nbody)]
    for b in range(nbody):
        chain = []
        p = b
        while p != 0:
            chain = body_dofs[p] + chain
            p = body_parentid[p]
        for x, i in enumerate(chain):
            amask[i, chain[:x + 1]] = True
    mask = amask | amask.T
    if simple_truncate and dof_simple:
        simple = np.zeros(nv, dtype=bool)
        simple[list(dof_simple)] = True
        offdiag = ~np.eye(nv, dtype=bool)
        mask = mask & ~(offdiag & (simple[:, None] | simple[None, :]))
    return mask


def qderiv_sparsity(m: Model, simple_truncate: bool) -> np.ndarray:
    """(nv, nv) bool: the entries of qDeriv libmujoco stores
    (_qderiv_sparsity_meta)."""
    return _qderiv_sparsity_meta(m.body_parentid, m.body_dofnum, m.body_dofadr,
                                 m.dof_simple, m.nv, simple_truncate)


def implicitfast_matrix(m: Model, d: Data) -> torch.Tensor:
    """implicitfast's (B, nv, nv) M - h qD: qD = _qderiv_smooth masked by
    qderiv_sparsity (simple dofs truncated), the matrix symmetrised. The
    ellipsoid fluid model's qD can make it indefinite (ROADMAP C14)."""
    dtype = d.qpos.dtype
    qD = _qderiv_smooth(m, d) * mmath.static_tensor(
        qderiv_sparsity(m, simple_truncate=True), d.qpos.device, dtype)
    A = d.qM - m.opt.timestep.to(dtype) * qD
    return 0.5 * (A + A.mT)


def implicitfast(m: Model, d: Data) -> Data:
    """mj_implicit's fast variant: solve implicitfast_matrix(m, d) qacc =
    qfrc_smooth + qfrc_constraint; the solve is K1 up to nv = 96
    (linalg_tpu.solve)."""
    return _advance(m, d, linalg_tpu.solve(implicitfast_matrix(m, d),
                                           d.qfrc_smooth + d.qfrc_constraint))


def bias_jacobian(m: Model, d: Data) -> torch.Tensor:
    """d qfrc_bias / d qvel (B, nv, nv) by forward-mode AD through com_vel
    and rne, over B nv copies of the batch in one pass, copy (b, j) with
    the unit tangent e_j. qfrc_bias is quadratic in qvel, so the tangent
    is exact (the JAX package's jax.jacfwd of the same two stages)."""
    B, nv = d.qvel.shape

    def rep(t):
        return t.repeat_interleave(nv, 0)
    tangent = torch.eye(nv, dtype=d.qvel.dtype, device=d.qvel.device).repeat(B, 1)
    with fwAD.dual_level():
        dd = d.replace(qpos=rep(d.qpos), qvel=fwAD.make_dual(rep(d.qvel), tangent),
                       cdof=rep(d.cdof), cinert=rep(d.cinert))
        jac = fwAD.unpack_dual(smooth.rne(m, smooth.com_vel(m, dd)).qfrc_bias).tangent
    return jac.view(B, nv, nv).mT


def fluid_jacobian(m: Model, d: Data) -> torch.Tensor:
    """d qfrc_fluid / d qvel (B, nv, nv) by forward-mode AD through both
    fluid models over B nv copies. cvel is linear in qvel, so copy (b, j)
    takes its exact tangent, cdof_j on every body dof j moves
    (body_dof_mask), with no pass through com_vel: the numbers of the JAX
    package's jax.jacfwd through com_vel and the fluid models."""
    B, nv = d.qvel.shape
    mask = mmath.static_tensor(smooth.body_dof_mask(m), d.qpos.device, d.qpos.dtype)

    def rep(t):
        return t.repeat_interleave(nv, 0)
    tangent = (mask[None, :, :, None] * d.cdof[:, :, None, :]).reshape(B * nv, m.nbody, 6)
    with fwAD.dual_level():
        dd = d.replace(cvel=fwAD.make_dual(rep(d.cvel), tangent),
                       **{f: rep(getattr(d, f)) for f in (
                           "qpos", "cdof", "xipos", "ximat", "subtree_com", "geom_xpos",
                           "geom_xmat")})
        jac = fwAD.unpack_dual(smooth.fluid_qfrc(m, dd)).tangent
    return jac.view(B, nv, nv).mT


def implicit(m: Model, d: Data) -> Data:
    """mj_implicit: as implicitfast with d qfrc_bias / d qvel folded in
    (bias_jacobian), masked by the ancestor pairs alone (no truncation),
    and the matrix, not symmetric, solved by LU (torch.linalg.solve_ex,
    the JAX package's jnp.linalg.solve; no Pallas kernel there)."""
    dtype = d.qpos.dtype
    h = m.opt.timestep.to(dtype)
    mask = mmath.static_tensor(qderiv_sparsity(m, simple_truncate=False), d.qpos.device,
                               dtype)
    A = d.qM - h * ((_qderiv_smooth(m, d) - bias_jacobian(m, d)) * mask)
    qacc = torch.linalg.solve_ex(A, d.qfrc_smooth + d.qfrc_constraint)[0]
    return _advance(m, d, qacc)


_RK4_A = np.array([[0.5, 0, 0], [0, 0.5, 0], [0, 0, 1.0]])
_RK4_B = np.array([1 / 6, 1 / 3, 1 / 3, 1 / 6])


def rk4(m: Model, d: Data, control_hook: Hook = None, passive_hook: Hook = None,
        hstate=None):
    """mj_RungeKutta(4) from d, stage 0's forward already done: three more
    forward calls (the hooks and their state threaded through each), then
    qpos, qvel, act and time from the weighted stages. The rest of the
    returned Data is stage 0's (its qacc, contacts, sensordata and warm
    start), as in the JAX package. Returns (d, hstate) when hstate is given."""
    stateful = hstate is not None
    h = m.opt.timestep.to(d.qpos.dtype)
    d0 = d
    qvels, qaccs, act_dots = [d.qvel], [d.qacc], [d.act_dot]
    for i in range(3):
        a = _RK4_A[i]
        dqvel = sum(float(a[j]) * qvels[j] for j in range(i + 1))
        dqacc = sum(float(a[j]) * qaccs[j] for j in range(i + 1))
        dact = sum(float(a[j]) * act_dots[j] for j in range(i + 1))
        di = d0.replace(qpos=integrate_pos(m, d0.qpos, dqvel, h), qvel=d0.qvel + h * dqacc,
                        act=d0.act + h * dact if m.na else d0.act,
                        time=d0.time + float(np.sum(_RK4_A[i])) * h)
        out = forward(m, di, control_hook, passive_hook, hstate)
        di, hstate = out if stateful else (out, hstate)
        qvels.append(di.qvel)
        qaccs.append(di.qacc)
        act_dots.append(di.act_dot)
    Fv = sum(float(_RK4_B[j]) * qvels[j] for j in range(4))
    Fa = sum(float(_RK4_B[j]) * qaccs[j] for j in range(4))
    Fd = sum(float(_RK4_B[j]) * act_dots[j] for j in range(4))
    d = d0.replace(qpos=integrate_pos(m, d0.qpos, Fv, h), qvel=d0.qvel + h * Fa,
                   act=d0.act + h * Fd if m.na else d0.act, time=d0.time + h)
    return (d, hstate) if stateful else d


# ---------------------------------------------------------------------------
# routes and the step
# ---------------------------------------------------------------------------

class GeneralPlan(NamedTuple):
    """The general route: it needs nothing beyond the model and the state."""


Plan = Union[step_tpu.Plan, GeneralPlan]


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to the torch package")


def check_general(m: Model) -> None:
    """Raise for what the general route cannot step: NotImplementedError
    for a sensor type or a transmission it does not know, ValueError for a
    malformed spatial tendon. Every integrator (Euler, RK4, implicit,
    implicitfast), every solver (Newton, CG, PGS), every geom pair of the
    pair table, spatial tendons, muscles, both fluid models and all 36
    sensor types step here."""
    for st in m.sensor_type:
        if st not in SENSOR_DIM:
            _not_ported(f"sensor type {st}")
    smooth.check_actuators(m)
    smooth.check_tendons(m)
    if constraint._has_constraints(m):
        efc._check_rows(m)


def make_plan(m: Model) -> Plan:
    """The route `step` takes for this model and what it needs: the fused
    route's packed params and kernel metadata, or the general route (whose
    rangefinders' mesh faces are computed here, so that no step copies the
    hulls to the host). Raises NotImplementedError for a model the port
    cannot step."""
    if step_tpu.supports(m):
        return step_tpu.make_plan(m)
    check_general(m)
    if SensorType.RANGEFINDER in m.sensor_type:
        for did in range(m.nmesh):
            sensor_impl.hull_faces(m, did)
    return GeneralPlan()


def step(m: Model, d: Data, plan: Optional[Plan] = None, control_hook: Hook = None,
         passive_hook: Hook = None, hstate=None):
    """mj_step of the whole batch. A `plan` from make_plan(m) may be made
    once and reused across steps. A hook or a hook state forces the general
    route, which runs forward and then m.opt.integrator's update (RK4 runs
    three more forward calls and sets no warm start of its own); returns
    (d, hstate) when hstate is given, else d."""
    plan = plan if plan is not None else make_plan(m)
    stateful = hstate is not None
    hooked = control_hook is not None or passive_hook is not None or stateful
    if isinstance(plan, step_tpu.Plan):
        if not hooked:
            return step_tpu.step(m, d, plan)
        check_general(m)
    out = forward(m, d, control_hook, passive_hook, hstate)
    d, hstate = out if stateful else (out, hstate)
    integrator = m.opt.integrator
    if integrator == int(IntegratorType.RK4):
        return rk4(m, d, control_hook, passive_hook, hstate)
    d = d.replace(qacc_warmstart=d.qacc)
    if integrator == int(IntegratorType.IMPLICIT):
        d = implicit(m, d)
    elif integrator == int(IntegratorType.IMPLICITFAST):
        d = implicitfast(m, d)
    else:
        d = euler(m, d)
    return (d, hstate) if stateful else d
