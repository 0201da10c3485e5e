"""Whole-step fused path for single-free-body models (BOXES class).

Counterpart of mujoco_ros_pkgs_tpu/ops/step_tpu.py. On a CUDA tensor the
step runs as one hand-written kernel (csrc/step_fused.cu, bound in
kernels.py): kinematics, single-body CRB and RNE, static-vs-body
narrowphase, contact efc rows with the `_kbi` impedance, the Newton solve
(the group body K2 runs too) and Euler with implicit damping, a group of
lanes per env. On a CPU tensor it runs
`step_batched_plain`, the same computation in plain torch, which is also the
kernel's reference on the card.

Scope (`supports`): world + one free-joint body; pairs between the world
and the body with any of the twelve analytic primitives (planes, spheres,
capsules, ellipsoids against a plane, cylinders against a plane or a sphere,
boxes; ops/narrowphase_soa.SOA_FNS); elliptic cone, condim 1/3/4/6,
at most 64 rows; Euler, Newton; no actuators, tendons, sensors, equality,
limits, friction loss or fluid. Like the JAX kernel it reads neither
qfrc_applied nor xfrc_applied.

Every env-invariant scalar the step needs rides in one packed float32
params vector (`_pack_params`); the kernel reads it from device memory, so
edits such as set_gravity take effect with no rebuild. The model's static
structure (pairs, slots, trip counts, flags, param offsets) rides in a small
int32 vector (`kernel_meta`), which ends with the solve's own block
(`solver_tpu.kernel_meta`: row codes, and first row and condim per contact).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core.types import (
    Data, DisableBit, IntegratorType, JointType, Model,
)
from mujoco_ros_pkgs_tpu_torch.ops import linalg_tpu
from mujoco_ros_pkgs_tpu_torch.ops import narrowphase as nphase
from mujoco_ros_pkgs_tpu_torch.ops import narrowphase_soa as soa
from mujoco_ros_pkgs_tpu_torch.ops import solver_tpu
from mujoco_ros_pkgs_tpu_torch.ops.math import MINVAL

MINIMP, MAXIMP = 0.0001, 0.9999
MAX_ROWS = solver_tpu.MAX_ROWS     # the Newton body's maximum


def supports(m: Model) -> bool:
    """Static qualification of the model for the fused whole step: the JAX
    package's gate (step_tpu.supports there). World + one free body; every
    collision pair between the world and the body, with one of the twelve
    analytic primitives (narrowphase_soa.SOA_FNS; MPR, mesh and height-field
    pairs keep the general route); elliptic cones, the Newton solver, Euler,
    condim 1/3/4/6, 1 to 64 rows; no actuators, tendons, equality rows,
    sensors, mocap bodies, limits, friction loss, fluid or pair compaction."""
    if not (m.nbody == 2 and m.njnt == 1 and m.jnt_type[0] == int(JointType.FREE)):
        return False
    if m.nu or m.na or m.ntendon or m.neq or m.nsensor or m.nsensordata:
        return False
    if any(mc >= 0 for mc in m.body_mocapid):
        return False
    if any(m.jnt_limited) or len(m.dof_floss_adr):
        return False
    if m.opt.integrator != int(IntegratorType.EULER) or m.has_fluid:
        return False
    if int(m.opt.cone) == 0 or int(m.opt.solver) != 2 or m.pair_topk:
        return False
    if m.opt.disableflags & (DisableBit.CONSTRAINT | DisableBit.CONTACT):
        return False
    gb = m.geom_bodyid
    for grp in nphase.pair_groups(m):
        if nphase._DISPATCH[grp["key"][1:3]].name not in soa.SOA_FNS:
            return False
        if any({gb[g1], gb[g2]} != {0, 1} for g1, g2 in grp["pairs"]):
            return False
    g1s, _, dims = nphase.slot_meta(m)
    if not g1s or not 1 <= sum(dims) <= MAX_ROWS:
        return False
    return all(d in (1, 3, 4, 6) for d in dims)


# ---------------------------------------------------------------------------
# model metadata
# ---------------------------------------------------------------------------


def _slot_table(m: Model):
    """Canonical contact-slot table: per slot (pair index, contact index
    within pair, sign, dim); per pair dict(fn, g1, g2, body_is_g2, cap, dim)
    in pair-group order (the JAX package's layout)."""
    pairs = []
    slots = [None] * len(nphase.slot_meta(m)[0])
    gb = m.geom_bodyid
    for grp in nphase.pair_groups(m):
        routine = nphase._DISPATCH[grp["key"][1:3]]
        for (g1, g2), base in zip(grp["pairs"], grp["bases"]):
            pi = len(pairs)
            body_is_g2 = gb[g2] == 1
            dim = nphase._pair_condim(m, g1, g2)
            pairs.append(dict(fn=routine.name, g1=g1, g2=g2,
                              body_is_g2=body_is_g2, cap=routine.cap, dim=dim))
            for k in range(routine.cap):
                slots[int(base) + k] = (pi, k, 1.0 if body_is_g2 else -1.0, dim)
    return pairs, slots


def _pack_params(m: Model, dtype=torch.float32):
    """Every env-invariant scalar of the step in one vector on the model's
    device; returns (params (NP,), {name: (offset, length)})."""
    vals, idx = [], {}
    off = 0

    def put(name, t):
        nonlocal off
        t = torch.as_tensor(t, device=m.device).to(dtype).reshape(-1)
        idx[name] = (off, t.shape[0])
        off += t.shape[0]
        vals.append(t)

    put("dt", m.opt.timestep)
    gravity_on = 0.0 if m.opt.disableflags & DisableBit.GRAVITY else 1.0
    put("gravity", gravity_on * m.opt.gravity)
    put("tol", m.opt.tolerance)
    put("impratio", m.opt.impratio)
    put("mass", m.body_mass[1])
    put("inertia", m.body_inertia[1])
    put("ipos", m.body_ipos[1])
    put("iquat", m.body_iquat[1])
    put("invw0", m.body_invweight0[0, 0])
    put("invw1", m.body_invweight0[1, 0])
    put("damping", m.dof_damping)
    put("armature", m.dof_armature)
    for g in range(m.ngeom):
        put(f"gsize{g}", m.geom_size[g])
        put(f"gpos{g}", m.geom_pos[g])
        put(f"gquat{g}", m.geom_quat[g])
    pairs, _ = _slot_table(m)
    g1s = np.array([p["g1"] for p in pairs])
    g2s = np.array([p["g2"] for p in pairs])
    fric5, solref, solimp, margin, gap = nphase._contact_params_vec(
        m, g1s, g2s, dtype)
    put("fric5", fric5)
    put("solref", solref)
    put("solimp", solimp)
    put("incm", margin - gap)
    return torch.cat(vals), idx


# kernel_meta layout (csrc/step_fused.cu reads it the same way)
_META_HEADER = ("npairs", "nrows", "niter", "nls", "warmstart", "refsafe",
                "has_damping")
_META_PARAMS = ("dt", "gravity", "tol", "impratio", "mass", "inertia", "ipos",
                "iquat", "invw0", "invw1", "damping", "armature", "fric5",
                "solref", "solimp", "incm")
_PAIR_STRIDE = 8     # prim, pi, g1 param offset, g1 on body, g2 offset,
                     # g2 on body, sign (+1 body is g2, -1 otherwise), dim


def contact_layout(m: Model) -> tuple:
    """(first row, condim) per contact slot: the rows of each slot follow
    one another in slot order."""
    out, row = [], 0
    for _, _, _, dim in _slot_table(m)[1]:
        out.append((row, dim))
        row += dim
    return tuple(out)


def kernel_meta(m: Model, idx: dict) -> list:
    """Static structure of the model for the CUDA kernel, as int32 values:
    the header, the param offsets, one record per pair in slot order (each
    pair's `cap` contacts occupy consecutive slots), then the solve's block
    (solver_tpu.kernel_meta of the contact rows)."""
    pairs, slots = _slot_table(m)
    nrows = sum(s[3] for s in slots)
    if nrows > MAX_ROWS:
        raise ValueError(f"fused step: {nrows} constraint rows exceed the "
                         f"kernel maximum of {MAX_ROWS}")
    niter, nls = solver_tpu.trip_counts(m)
    flags = m.opt.disableflags
    warmstart = int(not flags & DisableBit.WARMSTART)
    meta = [len(pairs), nrows, niter, nls, warmstart,
            int(not flags & DisableBit.REFSAFE), int(bool(m.has_damping))]
    meta += [idx[name][0] for name in _META_PARAMS]
    first_slot = {}
    for si, (pi, k, _, _) in enumerate(slots):
        first_slot.setdefault(pi, si)
    for pi in sorted(first_slot, key=first_slot.get):
        p = pairs[pi]
        meta += [soa.PRIM_ID[p["fn"]], pi,
                 idx[f"gsize{p['g1']}"][0], int(m.geom_bodyid[p["g1"]] == 1),
                 idx[f"gsize{p['g2']}"][0], int(m.geom_bodyid[p["g2"]] == 1),
                 1 if p["body_is_g2"] else -1, p["dim"]]
    meta += solver_tpu.kernel_meta(("con",) * nrows, contact_layout(m), 6, niter, nls,
                                   warmstart)
    return meta


class Plan(NamedTuple):
    """What the fused step needs beyond the state: packed params, their
    layout, (on CUDA) the kernel's metadata vector, and the model's
    (constraint rows, contact slots)."""
    params: torch.Tensor
    idx: dict
    meta: Optional[torch.Tensor]
    rows: Tuple[int, int]


def make_plan(m: Model) -> Plan:
    params, idx = _pack_params(m)
    meta = None
    if m.device.type == "cuda":
        meta = torch.tensor(kernel_meta(m, idx), dtype=torch.int32,
                            device=m.device)
    base = contact_layout(m)
    return Plan(params, idx, meta, (sum(d for _, d in base), len(base)))


# ---------------------------------------------------------------------------
# plain-torch step (the kernel's reference)
# ---------------------------------------------------------------------------


def _quat_to_mat(q):
    w, x, y, z = q
    return ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
            (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)))


def _quat_mul(u, v):
    return (u[0] * v[0] - u[1] * v[1] - u[2] * v[2] - u[3] * v[3],
            u[0] * v[1] + u[1] * v[0] + u[2] * v[3] - u[3] * v[2],
            u[0] * v[2] - u[1] * v[3] + u[2] * v[0] + u[3] * v[1],
            u[0] * v[3] + u[1] * v[2] - u[2] * v[1] + u[3] * v[0])


def _mat_mul(A, B):
    return tuple(tuple(sum(A[i][k] * B[k][j] for k in range(3))
                       for j in range(3)) for i in range(3))


def _inert_vec_mul(cin, v):
    """(10,) spatial inertia components x svec6 (mju_mulInertVec)."""
    Ixx, Iyy, Izz, Ixy, Ixz, Iyz, hx, hy, hz, mass = cin
    w, l = v
    Iw = (Ixx * w[0] + Ixy * w[1] + Ixz * w[2],
          Ixy * w[0] + Iyy * w[1] + Iyz * w[2],
          Ixz * w[0] + Iyz * w[1] + Izz * w[2])
    h = (hx, hy, hz)
    return (soa.v_add(Iw, soa.v_cross(h, l)),
            soa.v_sub(soa.v_scale(l, mass), soa.v_cross(h, w)))


def _force_cross(u, f):
    return (soa.v_add(soa.v_cross(u[0], f[0]), soa.v_cross(u[1], f[1])),
            soa.v_cross(u[0], f[1]))


def _motion_cross(u, v):
    return (soa.v_cross(u[0], v[0]),
            soa.v_add(soa.v_cross(u[0], v[1]), soa.v_cross(u[1], v[0])))


def _sv_dot(a, b):
    return soa.v_dot(a[0], b[0]) + soa.v_dot(a[1], b[1])


def _pow(x, p):
    """x**p for x >= 0 as exp(p log x), the formula the JAX kernel uses (and
    csrc/step_fused.cu); exactly 0 at x == 0."""
    return torch.where(x <= 0.0, torch.zeros_like(x + p),
                       torch.exp(p * torch.log(torch.clamp(x, min=1e-30))))


def _kbi(solref, solimp, pos, margin, timestep, refsafe):
    """Stiffness, damping and impedance of one row class (efc._kbi twin)."""
    d0, dmax, width, mid, power = solimp
    x = torch.abs(pos - margin) / torch.clamp(width, min=MINVAL)
    x = torch.clamp(x, 0.0, 1.0)
    mid = torch.clamp(mid, MINIMP, MAXIMP)
    power = torch.clamp(power, min=1.0)
    a = 1.0 / _pow(mid, power - 1.0)
    b = 1.0 / _pow(1.0 - mid, power - 1.0)
    y = torch.where(x < mid, a * _pow(x, power), 1.0 - b * _pow(1.0 - x, power))
    imp = torch.clamp(d0 + y * (dmax - d0), MINIMP, MAXIMP)
    dmax_c = torch.clamp(dmax, MINIMP, MAXIMP)
    timeconst, dampratio = solref
    if refsafe:
        timeconst = torch.maximum(timeconst, 2.0 * timestep)
    k_std = 1.0 / torch.clamp(dmax_c * dmax_c * timeconst * timeconst
                              * dampratio * dampratio, min=MINVAL)
    b_std = 2.0 / torch.clamp(dmax_c * timeconst, min=MINVAL)
    direct = (solref[0] <= 0) | (solref[1] <= 0)
    k = torch.where(direct, -solref[0] / (dmax_c * dmax_c), k_std)
    b = torch.where(direct, -solref[1], b_std)
    return k, b, imp


class _Problem(NamedTuple):
    """One env batch's smooth quantities and contact rows at (qpos, qvel)."""
    pos: tuple            # (3,) of (B,)
    quat: tuple           # normalized, (4,) of (B,)
    M: torch.Tensor       # (B, 6, 6)
    qfrc_smooth: torch.Tensor   # (B, 6)
    a_s: torch.Tensor     # (B, 6) unconstrained acceleration
    J: torch.Tensor       # (B, nrows, 6)
    aref: torch.Tensor    # (B, nrows)
    D: torch.Tensor       # (B, nrows)
    act: torch.Tensor     # (B, nrows) bool
    mu: torch.Tensor      # (B, ncon, 5)
    con_base: tuple       # (first row, condim) per contact


def _problem(m: Model, qpos, qvel, params, idx) -> _Problem:
    """Kinematics, CRB, RNE, narrowphase and contact rows of the fused step,
    op for op the JAX kernel's computation (the mass-matrix solve factors
    right-looking, as linalg_tpu.chol_solve_plain does)."""
    pairs, slots = _slot_table(m)
    refsafe = not m.opt.disableflags & DisableBit.REFSAFE
    nv = 6

    def P(name, k=0):
        return params[idx[name][0] + k]

    def Pv(name):
        return tuple(P(name, k) for k in range(idx[name][1]))

    q = qpos.unbind(-1)
    pos = q[:3]
    n = torch.sqrt(torch.clamp(sum(c * c for c in q[3:7]), min=MINVAL * MINVAL))
    quat = tuple(c / n for c in q[3:7])
    qv = qvel.unbind(-1)
    dt = P("dt")
    R = _quat_to_mat(quat)
    zero = torch.zeros_like(pos[0])

    # ---- com quantities (free body: ref = com = xipos) ----
    ipos_w = soa.m_matvec(R, Pv("ipos"))
    iR = _mat_mul(R, _quat_to_mat(Pv("iquat")))
    Ib = Pv("inertia")

    def Iw(a, b):
        return sum(iR[a][k] * Ib[k] * iR[b][k] for k in range(3))
    mass = P("mass")
    cin = (Iw(0, 0), Iw(1, 1), Iw(2, 2), Iw(0, 1), Iw(0, 2), Iw(1, 2),
           zero, zero, zero, mass)

    # cdof rows (ang, lin): translations e_v, then body-axis rotations
    cdof = []
    for v in range(3):
        cdof.append(((zero, zero, zero),
                     tuple(zero + (1.0 if k == v else 0.0) for k in range(3))))
    for k in range(3):
        ang = soa.m_col(R, k)
        cdof.append((ang, soa.v_cross(ang, ipos_w)))

    # ---- qM (crb on one body) ----
    F = [_inert_vec_mul(cin, cdof[i]) for i in range(nv)]
    arma = Pv("armature")
    M = [[None] * nv for _ in range(nv)]
    for i in range(nv):
        for j in range(i + 1):
            g = _sv_dot(F[i], cdof[j])
            M[i][j] = M[j][i] = g + arma[i] if i == j else g
    M = torch.stack([torch.stack(row, -1) for row in M], -2)

    # ---- rne bias ----
    grav = Pv("gravity")
    cvel = ((zero, zero, zero), qv[:3])
    vmid = cvel
    cacc = ((zero, zero, zero), tuple(-g + zero for g in grav))
    for k in range(3):
        dot = _motion_cross(vmid, cdof[3 + k])
        cacc = (soa.v_add(cacc[0], soa.v_scale(dot[0], qv[3 + k])),
                soa.v_add(cacc[1], soa.v_scale(dot[1], qv[3 + k])))
        cvel = (soa.v_add(cvel[0], soa.v_scale(cdof[3 + k][0], qv[3 + k])),
                soa.v_add(cvel[1], soa.v_scale(cdof[3 + k][1], qv[3 + k])))
    cfrc_a = _inert_vec_mul(cin, cacc)
    cfrc_b = _force_cross(cvel, _inert_vec_mul(cin, cvel))
    cfrc = (soa.v_add(cfrc_a[0], cfrc_b[0]), soa.v_add(cfrc_a[1], cfrc_b[1]))
    damping = Pv("damping")
    qfrc_smooth = torch.stack([-damping[v] * qv[v] - _sv_dot(cdof[v], cfrc)
                               for v in range(nv)], -1)
    a_s = linalg_tpu.chol_solve_plain(M, qfrc_smooth)

    # ---- narrowphase ----
    def geom_frame(g):
        gp = Pv(f"gpos{g}")
        gR = _quat_to_mat(Pv(f"gquat{g}"))
        if m.geom_bodyid[g] == 0:
            return (tuple(zero + c for c in gp),
                    tuple(tuple(zero + gR[i][j] for j in range(3)) for i in range(3)))
        return soa.v_add(pos, soa.m_matvec(R, gp)), _mat_mul(R, gR)

    pair_out = []
    for p in pairs:
        P1, M1 = geom_frame(p["g1"])
        P2, M2 = geom_frame(p["g2"])
        pair_out.append(soa.SOA_FNS[p["fn"]](
            P1, M1, Pv(f"gsize{p['g1']}"), P2, M2, Pv(f"gsize{p['g2']}")))

    # ---- efc rows per slot ----
    impratio = P("impratio")
    invw = P("invw0") + P("invw1")
    J, aref, D, act, mu, con_base = [], [], [], [], [], []
    for pi, k, sgn, dim in slots:
        dists, poss, frames = pair_out[pi]
        dist, cpos, frame = dists[k], poss[k], frames[k]
        incm = P("incm", pi)
        solref = (P("solref", pi * 2), P("solref", pi * 2 + 1))
        solimp = tuple(P("solimp", pi * 5 + j) for j in range(5))
        fr5 = tuple(P("fric5", pi * 5 + j) for j in range(5))
        a_act = dist < incm
        k_, b_, imp_ = _kbi(solref, solimp, dist, incm, dt, refsafe)
        off = soa.v_sub(cpos, soa.v_add(pos, ipos_w))

        def trans_row(axis):
            offxa = soa.v_cross(off, axis)
            return ([sgn * axis[v] for v in range(3)]
                    + [sgn * (soa.v_dot(axis, cdof[3 + kk][1])
                              + soa.v_dot(offxa, cdof[3 + kk][0]))
                       for kk in range(3)])

        def rot_row(axis):
            return [zero, zero, zero] + [sgn * soa.v_dot(axis, cdof[3 + kk][0])
                                         for kk in range(3)]

        rows = [trans_row(frame[0])]
        if dim > 1:
            rows += [trans_row(frame[1]), trans_row(frame[2])]
        rows += [rot_row(frame[rr]) for rr in range(dim - 3)]

        con_base.append((len(J), dim))
        R_base = (1.0 - imp_) / imp_ * invw
        for rr, row in enumerate(rows):
            jv = sum(row[v] * qv[v] for v in range(nv))
            if rr == 0:
                aref.append(-b_ * jv - k_ * imp_ * (dist - incm))
                D.append(1.0 / torch.clamp(R_base, min=MINVAL))
            else:
                scale = impratio
                if rr >= 3:
                    scale = scale * fr5[rr - 1] * fr5[rr - 1]
                aref.append(-b_ * jv)
                D.append(1.0 / torch.clamp(R_base / scale, min=MINVAL))
            J.append(torch.stack(row, -1))
            act.append(a_act)
        mu.append(torch.stack([zero + f for f in fr5], -1))

    return _Problem(pos, quat, M, qfrc_smooth, a_s, torch.stack(J, -2),
                    torch.stack(aref, -1), torch.stack(D, -1),
                    torch.stack(act, -1), torch.stack(mu, -2), tuple(con_base))


def step_batched_plain(m: Model, qpos, qvel, ws, params, idx):
    """(B, 7), (B, 6), (B, 6) float32 + params -> (qpos', qvel', x_solver),
    in plain torch, op for op the computation of the JAX kernel but for the
    order of the Cholesky factorisations (linalg_tpu.chol_solve_plain)."""
    flags = m.opt.disableflags
    niter, nls = solver_tpu.trip_counts(m)
    pr = _problem(m, qpos, qvel, params, idx)
    dt = params[idx["dt"][0]]
    x, f = solver_tpu.newton_tiles(
        6, ("con",) * pr.J.shape[-2], pr.con_base, niter, nls,
        not flags & DisableBit.WARMSTART, params[idx["tol"][0]], pr.J, pr.aref,
        pr.D, torch.zeros_like(pr.D), pr.act, pr.mu, pr.M, pr.a_s, ws)

    # ---- Euler (implicit in joint damping) ----
    qacc = x
    if m.has_damping:
        qfrc_con = (pr.J * f[..., None]).sum(-2)
        damping = params[idx["damping"][0]:idx["damping"][0] + 6]
        MhB = pr.M + torch.diag_embed(dt * damping)
        qacc = linalg_tpu.chol_solve_plain(MhB, pr.qfrc_smooth + qfrc_con)
    pos, quat = pr.pos, pr.quat
    qvel_new = qvel + dt * qacc
    qv = qvel_new.unbind(-1)
    pos_new = tuple(pos[k] + dt * qv[k] for k in range(3))
    wvel = qv[3:6]
    wn = torch.sqrt(torch.clamp(soa.v_dot(wvel, wvel), min=MINVAL * MINVAL))
    axis = soa.v_scale(wvel, 1.0 / wn)
    half = 0.5 * (wn * dt)
    dq = (torch.cos(half),) + tuple(c * torch.sin(half) for c in axis)
    quat_new = _quat_mul(quat, dq)
    return torch.stack(pos_new + quat_new, -1), qvel_new, x


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def step_batched(m: Model, qpos, qvel, ws, plan: Plan):
    """Fused step of a batch: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (qpos', qvel', x_solver)."""
    if qpos.device.type == "cuda":
        from mujoco_ros_pkgs_tpu_torch import kernels
        if plan.meta is None:
            raise ValueError("fused step: the plan has no kernel metadata "
                             "(make the plan from a model on the CUDA device)")
        return kernels.step_fused(plan.meta, plan.params, qpos, qvel, ws, plan.rows)
    if qpos.device.type == "cpu":
        return step_batched_plain(m, qpos, qvel, ws, plan.params, plan.idx)
    raise ValueError(f"fused step: unsupported device {qpos.device}")


def step(m: Model, d: Data, plan: Plan) -> Data:
    """Fused whole step for a qualifying model: updates qpos, qvel, qacc,
    qacc_warmstart and time. Derived fields are not kept in `Data`, as
    mj_step leaves them stale in mjData."""
    qp, qv, x = step_batched(m, d.qpos, d.qvel, d.qacc_warmstart, plan)
    return d.replace(qpos=qp, qvel=qv, qacc=x, qacc_warmstart=x,
                     time=d.time + plan.params[plan.idx["dt"][0]])
