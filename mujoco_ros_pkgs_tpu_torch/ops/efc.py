"""Constraint rows of equalities, friction loss, limits and contacts, with
the solref/solimp impedance model.

Counterpart of mujoco_ros_pkgs_tpu/ops/efc.py: the rows of every connect
(3), weld (6), joint (1) and tendon (1) equality, gated by d.eq_active
(always present, so the layout does not change when one is switched), one
friction-loss row per dof and per fixed tendon with frictionloss > 0
(always active), one limit row per limited hinge, slide or ball joint (on
the nearer side of its range; a ball joint's about its rotation axis) and
per limited tendon, then elliptic cones of condim 1/3/4/6 and pyramidal
facets, every slot of the contact set a row block (inactive rows masked),
in libmujoco's row order so the rows compare 1:1 with the JAX package's.
All tensors are batch-first; the row layout is static and shared by the
batch. With m.con_topk, a cone group the general Newton or CG takes is
built at each env's K deepest slots only (Efc.cb), their canonical rows
per env.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core.types import (Data, DisableBit, EqType, JointType, Model,
                                                   SolverType)
from mujoco_ros_pkgs_tpu_torch.ops import math as mmath
from mujoco_ros_pkgs_tpu_torch.ops import smooth, solver, solver_tpu
from mujoco_ros_pkgs_tpu_torch.ops.narrowphase import slot_meta

# impedance clamps (mjMINIMP/mjMAXIMP)
MINIMP, MAXIMP = 0.0001, 0.9999


class Efc(NamedTuple):
    """The efc rows of a batch in canonical row order."""
    J: torch.Tensor              # (B, nefc, nv)
    pos: torch.Tensor            # (B, nefc) constraint violation
    margin: torch.Tensor         # (B, nefc)
    D: torch.Tensor              # (B, nefc)
    R: torch.Tensor              # (B, nefc)
    aref: torch.Tensor           # (B, nefc)
    frictionloss: torch.Tensor   # (B, nefc)
    active: torch.Tensor         # (B, nefc) bool
    kinds: Tuple[str, ...]       # 'eq' per equality row, 'fri' per friction-loss
    #                              row, 'lim' per limit row and facet, 'con'
    #                              per elliptic row
    con_base: Tuple[int, ...]    # first row of each elliptic contact
    con_dim: Tuple[int, ...]     # its condim
    con_mu: torch.Tensor         # (B, ncon_ell, 5) friction of each
    con_active: torch.Tensor     # (B, ncon_ell)
    # the elliptic cone groups of condim > 1 in the solver's order, slots
    # grouped by (condim, dynamic): (dim, indices into con_base) each
    groups: Tuple[Tuple[int, Tuple[int, ...]], ...]
    # per group, None, or its rows at its K = m.con_topk most-penetrating
    # slots of each env, in slot order (solver.Cones, row indices per env);
    # the canonical rows of a compacted group are left empty (zero and
    # inactive)
    cb: Tuple[Optional[solver.Cones], ...]


# ---------------------------------------------------------------------------
# impedance / reference acceleration (mj_makeImpedance)
# ---------------------------------------------------------------------------

def _impedance(solimp, pos, margin):
    d0, dmax, width, mid, power = solimp.unbind(-1)
    x = torch.abs(pos - margin) / torch.clamp(width, min=mmath.MINVAL)
    x = torch.clamp(x, 0.0, 1.0)
    mid = torch.clamp(mid, MINIMP, MAXIMP)
    power = torch.clamp(power, min=1.0)
    # two-sided power spline through (mid, mid)
    a = 1.0 / torch.pow(mid, power - 1.0)
    b = 1.0 / torch.pow(1.0 - mid, power - 1.0)
    y = torch.where(x < mid, a * torch.pow(x, power),
                    1.0 - b * torch.pow(1.0 - x, power))
    return torch.clamp(d0 + y * (dmax - d0), MINIMP, MAXIMP)


def _kbi(m: Model, solref, solimp, pos, margin):
    """Stiffness, damping and impedance from solref (..., 2) and solimp
    (..., 5) at violation pos and margin (...)."""
    imp = _impedance(solimp, pos, margin)
    dmax = torch.clamp(solimp[..., 1], MINIMP, MAXIMP)
    timeconst, dampratio = solref[..., 0], solref[..., 1]
    if not m.opt.disableflags & DisableBit.REFSAFE:
        timeconst = torch.maximum(timeconst, 2.0 * m.opt.timestep)
    k_std = 1.0 / torch.clamp(dmax * dmax * timeconst * timeconst
                              * dampratio * dampratio, min=mmath.MINVAL)
    b_std = 2.0 / torch.clamp(dmax * timeconst, min=mmath.MINVAL)
    # direct (negative) solref: k = -solref[0], b = -solref[1]
    direct = (solref[..., 0] <= 0) | (solref[..., 1] <= 0)
    k = torch.where(direct, -solref[..., 0] / (dmax * dmax), k_std)
    b = torch.where(direct, -solref[..., 1], b_std)
    return k, b, imp


# ---------------------------------------------------------------------------
# row assembly
# ---------------------------------------------------------------------------

_EQ_ROWS = {int(EqType.CONNECT): 3, int(EqType.WELD): 6, int(EqType.JOINT): 1,
            int(EqType.TENDON): 1}
# the joint types with a limit row (a limited free joint has none)
_LIMIT_TYPES = (int(JointType.HINGE), int(JointType.SLIDE), int(JointType.BALL))


def _check_rows(m: Model):
    """Raise NotImplementedError for the rows of an equality type the JAX
    package's general route lacks (EqType values past TENDON)."""
    if m.opt.disableflags & (DisableBit.CONSTRAINT | DisableBit.EQUALITY):
        return
    for e, t in enumerate(m.eq_type):
        if t not in _EQ_ROWS:
            raise NotImplementedError(
                f"efc: rows of equality type {t} (equality '{m.eq_names[e]}') are not "
                f"ported to the torch package")


def _equalities(m: Model) -> Tuple[int, ...]:
    """The equalities with rows, in order (none when equality or
    constraints are disabled)."""
    if m.opt.disableflags & (DisableBit.CONSTRAINT | DisableBit.EQUALITY):
        return ()
    return tuple(range(m.neq))


def _rows(m: Model, J, pos, margin, invweight, solref, solimp, floss, vel) -> dict:
    """Rows (B, r) each with its own impedance at pos and margin (the JAX
    package's _row): aref = -b vel - k imp (pos - margin)."""
    k, b, imp = _kbi(m, solref, solimp, pos, margin)
    R = torch.clamp((1.0 - imp) / imp * invweight, min=mmath.MINVAL)
    return dict(J=J, pos=pos, margin=margin, D=1.0 / R, R=R,
                aref=-b * vel - k * imp * (pos - margin), frictionloss=floss)


def _row_group(m: Model, J, pos, norm_pos, invweight, solref, solimp, bias, qvel):
    """Rows of one equality (J (B, r, nv), pos and bias (B, r)) sharing the
    impedance of their residual's norm norm_pos (B,) at margin 0, with the
    J-dot qvel bias subtracted from aref (the JAX package's _row_group)."""
    k, b, imp = _kbi(m, solref, solimp, norm_pos, 0.0)
    vel = torch.einsum("brv,bv->br", J, qvel)
    R = torch.clamp((1.0 - imp) / imp * invweight, min=mmath.MINVAL)
    R = R[:, None].expand_as(pos)
    zero = torch.zeros_like(pos)
    return dict(J=J, pos=pos, margin=zero, D=1.0 / R, R=R,
                aref=-b * vel - (k * imp)[:, None] * pos - bias, frictionloss=zero)


def _point_vel_acc(m: Model, d: Data, cacc, body: int, point):
    """Angular velocity, spatial angular acceleration and classical bias
    acceleration of a point (B, 3) fixed to body (mj_objectAcc at qacc = 0)."""
    ref = d.subtree_com[:, m.body_rootid[body]]
    w, v = d.cvel[:, body, :3], d.cvel[:, body, 3:]
    v_p = v + mmath.cross(w, point - ref)
    ca = cacc[:, body]
    return w, ca[:, :3], ca[:, 3:] + mmath.cross(ca[:, :3], point - ref) + mmath.cross(w, v_p)


def _jac(m: Model, d: Data, point, body: int):
    """mj_jac at a world point (B, 3) of body: jacp, jacr (B, nv, 3)."""
    mask = mmath.static_tensor(smooth.body_dof_mask(m)[:, body], d.qpos.device,
                               d.qpos.dtype)[:, None]
    offset = point - d.subtree_com[:, m.body_rootid[body]]
    cdof = d.cdof
    jacp = (cdof[..., 3:] + mmath.cross(cdof[..., :3], offset[:, None, :])) * mask
    return jacp, cdof[..., :3] * mask


def _quat_lmat(q):
    """L(q) (B, 4, 4) with L(q) r = q * r."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([torch.stack(r, -1) for r in (
        (w, -x, -y, -z), (x, w, -z, y), (y, z, w, -x), (z, -y, x, w))], -2)


def _quat_rmat(q):
    """R(q) (B, 4, 4) with R(q) l = l * q."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([torch.stack(r, -1) for r in (
        (w, -x, -y, -z), (x, w, z, -y), (y, -z, w, x), (z, y, -x, w))], -2)


def _pure(v):
    """The quaternion (0, v) of vectors v (B, 3)."""
    return torch.cat([torch.zeros_like(v[:, :1]), v], -1)


def _eq_rows(m: Model, d: Data, eqs) -> dict:
    """The rows of the equalities eqs, in order, as the JAX package builds
    them: connect (3 rows: the anchor's world point on body1 minus body2's
    point, one impedance from the residual's norm), weld (3 translational
    rows from body2's pose predicted in body1's frame, then 3 rotational
    rows ts vec(q2^-1 q1 relq), all six sharing the norm of the 6-vector),
    joint (1 row: qpos1 - qpos1_0 - poly(qpos2 - qpos2_0)), tendon (1 row:
    L1 - L1_0 - poly(L2 - L2_0), J = ten_J1 - poly' ten_J2). The J-dot qvel
    bias of connect and weld rows comes from the bodies' bias accelerations
    (smooth.bias_acc at qacc = 0, no gravity), computed once."""
    B, dtype, dev, nv = d.qpos.shape[0], d.qpos.dtype, d.qpos.device, m.nv
    qvel = d.qvel
    cacc = (smooth.bias_acc(m, d, torch.zeros(6, dtype=dtype, device=dev))
            if any(m.eq_type[e] in (int(EqType.CONNECT), int(EqType.WELD)) for e in eqs)
            else None)
    iw = m.body_invweight0.to(dtype)
    blocks, actives = [], []
    for e in eqs:
        et, b1, b2 = m.eq_type[e], m.eq_obj1id[e], m.eq_obj2id[e]
        solref, solimp, data = m.eq_solref[e], m.eq_solimp[e], m.eq_data[e].to(dtype)
        if et == int(EqType.CONNECT):
            p1 = d.xpos[:, b1] + d.xmat[:, b1] @ data[0:3]
            p2 = d.xpos[:, b2] + d.xmat[:, b2] @ data[3:6]
            jacp1, _ = _jac(m, d, p1, b1)
            jacp2, _ = _jac(m, d, p2, b2)
            pos = p1 - p2
            bias = (_point_vel_acc(m, d, cacc, b1, p1)[2]
                    - _point_vel_acc(m, d, cacc, b2, p2)[2])
            blocks.append(_row_group(m, (jacp1 - jacp2).mT, pos, mmath.norm_safe(pos),
                                     iw[b1, 0] + iw[b2, 0], solref, solimp, bias, qvel))
        elif et == int(EqType.WELD):
            relq, ts = mmath.normalize(data[6:10]), data[10]
            p1 = d.xpos[:, b1] + d.xmat[:, b1] @ data[3:6]
            p2 = d.xpos[:, b2] + d.xmat[:, b2] @ data[0:3]
            jacp1, jacr1 = _jac(m, d, p1, b1)
            jacp2, jacr2 = _jac(m, d, p2, b2)
            post = p1 - p2
            w1, dw1, ap1 = _point_vel_acc(m, d, cacc, b1, p1)
            w2, dw2, ap2 = _point_vel_acc(m, d, cacc, b2, p2)
            q2c = mmath.quat_conj(d.xquat[:, b2])
            Q = mmath.quat_mul(d.xquat[:, b1], relq)
            posr = ts * mmath.quat_mul(q2c, Q)[:, 1:4]
            npos = torch.sqrt(torch.clamp((post * post).sum(-1) + (posr * posr).sum(-1),
                                          min=mmath.MINVAL * mmath.MINVAL))
            # d residual / d omega (world): 0.5 ts vec(q2^-1 (0, e) Q)
            G = 0.5 * (_quat_lmat(q2c) @ _quat_rmat(Q))[:, 1:4, 1:4]
            Jr = ts * (G @ (jacr1 - jacr2).mT)
            # the rotational J-dot qvel bias: the product rule on
            # rdot = 0.5 ts vec(q2^-1 (0, dw) Q), dw = w1 - w2
            dwq, w1q, w2q = _pure(w1 - w2), _pure(w1), _pure(w2)
            term1 = -0.5 * mmath.quat_mul(q2c, mmath.quat_mul(w2q, mmath.quat_mul(dwq, Q)))
            term2 = mmath.quat_mul(q2c, mmath.quat_mul(_pure(dw1 - dw2), Q))
            term3 = 0.5 * mmath.quat_mul(q2c, mmath.quat_mul(dwq, mmath.quat_mul(w1q, Q)))
            bias_r = 0.5 * ts * (term1 + term2 + term3)[:, 1:4]
            t = _row_group(m, (jacp1 - jacp2).mT, post, npos, iw[b1, 0] + iw[b2, 0],
                           solref, solimp, ap1 - ap2, qvel)
            r = _row_group(m, Jr, posr, npos, iw[b1, 1] + iw[b2, 1], solref, solimp,
                           bias_r, qvel)
            blocks.append({k: torch.cat([t[k], r[k]], 1) for k in t})
        else:
            # joint or tendon: coordinate 1 minus a quartic of coordinate 2,
            # each from its reference (qpos0, length0)
            def coord(i):
                if et == int(EqType.JOINT):
                    qa, v = m.jnt_qposadr[i], m.jnt_dofadr[i]
                    Ji = qvel.new_zeros(B, 1, nv)
                    Ji[:, 0, v] = 1.0
                    return d.qpos[:, qa] - m.qpos0[qa], Ji, m.dof_invweight0[v]
                return (d.ten_length[:, i] - m.tendon_length0[i], d.ten_J[:, i:i + 1],
                        m.tendon_invweight0[i])
            c = data[0:5]
            pos, J, invw = coord(b1)
            if b2 >= 0:
                x, J2, invw2 = coord(b2)
                poly = c[0] + x * (c[1] + x * (c[2] + x * (c[3] + x * c[4])))
                dpoly = c[1] + x * (2 * c[2] + x * (3 * c[3] + x * 4 * c[4]))
                pos, J, invw = pos - poly, J - dpoly[:, None, None] * J2, invw + invw2
            else:
                pos = pos - c[0]
            blocks.append(_row_group(m, J, pos[:, None], pos, invw, solref, solimp,
                                     torch.zeros_like(pos[:, None]), qvel))
        actives.append(d.eq_active[:, e:e + 1].expand(B, _EQ_ROWS[et]))
    out = {k: torch.cat([blk[k] for blk in blocks], 1) for k in blocks[0]}
    out["active"] = torch.cat(actives, 1)
    return out


def _frictional(m: Model) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The dofs and the tendons with a friction-loss row, in order (none
    when friction loss or constraints are disabled)."""
    if m.opt.disableflags & (DisableBit.CONSTRAINT | DisableBit.FRICTIONLOSS):
        return (), ()
    return tuple(m.dof_floss_adr), tuple(m.tendon_floss_adr)


def _friction_rows(m: Model, d: Data, dofs, tens) -> dict:
    """One always-active row per dof (J the dof's unit row) and per tendon
    (J its ten_J) with friction loss: pos and margin 0, the dof's solref /
    solimp (a tendon's limit ones, as the JAX package takes them) and
    invweight0, frictionloss the row's Huber threshold."""
    dev, B, nv = d.qpos.device, d.qpos.shape[0], m.nv
    dt, tt = (mmath.static_tensor(np.asarray(a, dtype=np.int64), dev) for a in (dofs, tens))
    J = d.qvel.new_zeros(B, len(dofs), nv)
    J[:, mmath.static_tensor(np.arange(len(dofs)), dev), dt] = 1.0
    J = torch.cat([J, d.ten_J[:, tt]], 1)
    vel = torch.cat([d.qvel[:, dt], torch.einsum("btv,bv->bt", d.ten_J[:, tt], d.qvel)], 1)
    zero = torch.zeros_like(vel)
    rows = _rows(m, J, zero, zero,
                 torch.cat([m.dof_invweight0[dt], m.tendon_invweight0[tt]]),
                 torch.cat([m.dof_solref[dt], m.tendon_solref_lim[tt]]),
                 torch.cat([m.dof_solimp[dt], m.tendon_solimp_lim[tt]]),
                 torch.cat([m.dof_frictionloss[dt], m.tendon_frictionloss[tt]]).expand_as(vel),
                 vel)
    rows["active"] = torch.ones_like(vel, dtype=torch.bool)
    return rows


def _limited(m: Model) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The joints (hinge, slide, ball) and the tendons with a limit row,
    in order (none when limits or constraints are disabled)."""
    if m.opt.disableflags & (DisableBit.CONSTRAINT | DisableBit.LIMIT):
        return (), ()
    return (tuple(j for j, lim in enumerate(m.jnt_limited)
                  if lim and m.jnt_type[j] in _LIMIT_TYPES),
            tuple(t for t, lim in enumerate(m.tendon_limited) if lim))


def _limit_rows(m: Model, d: Data, jnts, tens) -> dict:
    """One row per limited joint, then per limited tendon. A hinge or slide
    (and a tendon) on the nearer side of its range: pos = x - range[0] (J
    = +1 at the dof, or +ten_J) or range[1] - x (J = -1, or -ten_J); a ball
    joint about its rotation axis: pos = max(range) - angle, J = -axis at
    its 3 dofs. Active where pos < margin, with the joint's (tendon's)
    solref / solimp / margin and its dof's (tendon's) invweight0."""
    dev, B, nv, dtype = d.qpos.device, d.qpos.shape[0], m.nv, d.qpos.dtype
    n = len(jnts) + len(tens)
    J = d.qpos.new_zeros(B, n, nv)
    dist = d.qpos.new_zeros(B, n)
    vel = d.qpos.new_zeros(B, n)

    def t(a):
        return mmath.static_tensor(np.asarray(a, dtype=np.int64), dev)

    def nearer(x, rng):
        lo, hi = x - rng[:, 0], rng[:, 1] - x
        lo_closer = lo < hi
        return torch.where(lo_closer, lo, hi), torch.where(lo_closer, 1.0, -1.0).to(dtype)
    one = [k for k, j in enumerate(jnts) if m.jnt_type[j] != int(JointType.BALL)]
    ball = [k for k, j in enumerate(jnts) if m.jnt_type[j] == int(JointType.BALL)]
    if one:
        jt = t([jnts[k] for k in one])
        va = t([m.jnt_dofadr[jnts[k]] for k in one])
        q = d.qpos[:, t([m.jnt_qposadr[jnts[k]] for k in one])]
        dk, sgn = nearer(q, m.jnt_range[jt])
        dist[:, t(one)] = dk
        J[:, t(one), va] = sgn
        vel[:, t(one)] = sgn * d.qvel[:, va]
    if ball:
        jt = t([jnts[k] for k in ball])
        qa = np.asarray([m.jnt_qposadr[jnts[k]] for k in ball])
        va = np.asarray([m.jnt_dofadr[jnts[k]] for k in ball])
        axis_angle = mmath.quat_to_vel(d.qpos[:, t(qa[:, None] + np.arange(4))])
        rng = m.jnt_range[jt]
        dist[:, t(ball)] = torch.maximum(rng[:, 0], rng[:, 1]) - mmath.norm_safe(axis_angle)
        Jb = -mmath.normalize(axis_angle)                          # (B, W, 3)
        J[:, t(ball)[:, None], t(va[:, None] + np.arange(3))] = Jb
        vel[:, t(ball)] = (Jb * d.qvel[:, t(va[:, None] + np.arange(3))]).sum(-1)
    if tens:
        tt = t(tens)
        rows = t(np.arange(len(jnts), n))
        dk, sgn = nearer(d.ten_length[:, tt], m.tendon_range[tt])
        dist[:, rows] = dk
        J[:, rows] = sgn[..., None] * d.ten_J[:, tt]
        vel[:, rows] = torch.einsum("btv,bv->bt", J[:, rows], d.qvel)
    jt, tt = t(jnts), t(tens)
    va = t([m.jnt_dofadr[j] for j in jnts])
    margin = torch.cat([m.jnt_margin[jt], m.tendon_margin[tt]])
    out = _rows(m, J, dist, margin.expand(B, n),
                torch.cat([m.dof_invweight0[va], m.tendon_invweight0[tt]]),
                torch.cat([m.jnt_solref[jt], m.tendon_solref_lim[tt]]),
                torch.cat([m.jnt_solimp[jt], m.tendon_solimp_lim[tt]]),
                torch.zeros_like(dist), vel)
    out["active"] = dist < margin
    return out


def _contact_rows(m: Model, d: Data, dim: int, b1, b2, pos, frame, dist, incm,
                  solref, solimp, fric, act) -> dict:
    """The rows of n contact slots of one condim, each (B, n, nr, ...): J,
    pos, margin, R, aref, act, and for an elliptic cone the friction of its
    tangential rows (sigma). Body ids b1, b2 are static numpy (n,) or per
    env (B, n) (the slots of a compacted group)."""
    B, dtype, dev, nv = d.qpos.shape[0], d.qpos.dtype, d.qpos.device, m.nv
    pyramidal = m.opt.cone == 0
    bdmask = smooth.body_dof_mask(m)                    # (nv, nbody)
    rootid = np.asarray(m.body_rootid, dtype=np.int64)
    qvel = d.qvel
    nc = pos.shape[1]
    iw0 = m.body_invweight0[:, 0]

    def side(bs):
        """The body chain's dof mask (1 or B, n, nv) and the point's offset
        from the body's root subtree com (B, n, 3)."""
        if isinstance(bs, np.ndarray):
            mask = mmath.static_tensor(bdmask[:, bs].T, dev, dtype)[None]
            ref = d.subtree_com[:, mmath.static_tensor(rootid[bs], dev)]
            return mask, pos - ref, iw0[mmath.static_tensor(bs, dev)]
        mask = mmath.static_tensor(bdmask.T, dev, dtype)[bs]
        root = mmath.static_tensor(rootid, dev)[bs]
        ref = torch.take_along_dim(d.subtree_com, root[..., None], 1)
        return mask, pos - ref, iw0[bs]
    mask1, off1, iw1 = side(b1)
    mask2, off2, iw2 = side(b2)
    invw = (iw1 + iw2).to(dtype)

    # translational row along axis a at point p: a . cdof_lin + cdof_ang .
    # (off x a), a dot of cdof with [off x a, a], masked by the body chain
    def trans_rows(off, mask, axes):
        A = torch.cat([mmath.cross(off[:, :, None, :], axes), axes], -1)
        return torch.einsum("bctk,bvk->bctv", A, d.cdof) * mask[:, :, None, :]

    axes_t = frame[:, :, :1] if dim == 1 else frame[:, :, :3]
    Jt_all = trans_rows(off2, mask2, axes_t) - trans_rows(off1, mask1, axes_t)
    Jn = Jt_all[:, :, 0]                                   # (B, nc, nv)
    Jf_list = []
    if dim > 1:
        Jf_list.append(Jt_all[:, :, 1:3])
    if dim > 3:
        Pr = torch.einsum("bcrk,bvk->bcrv", frame[:, :, :dim - 3], d.cdof[..., :3])
        Jf_list.append(Pr * (mask2 - mask1)[:, :, None, :])
    Jf = (torch.cat(Jf_list, 2) if Jf_list
          else torch.zeros(B, nc, 0, nv, dtype=dtype, device=dev))

    k_, b_, imp_ = _kbi(m, solref, solimp, dist, incm)
    rbase = (1.0 - imp_) / imp_
    out = {}
    if pyramidal and dim > 1:
        # facet rows Jn +- mu_k Jt_k, one-sided quadratics ('lim')
        nr = 2 * (dim - 1)
        mu = fric[:, :, :dim - 1]
        sgns = mmath.static_tensor([1.0, -1.0], dev, dtype)
        Jblk = (Jn[:, :, None, None, :] + sgns[None, None, None, :, None]
                * (mu[..., None, None] * Jf[:, :, :, None, :])).reshape(B, nc, nr, nv)
        mu0 = fric[:, :, 0]
        invw_p = 2.0 * mu0 * mu0 * (1.0 + mu0 * mu0) * invw
        aref = (-b_[..., None] * torch.einsum("bcrv,bv->bcr", Jblk, qvel)
                - (k_ * imp_ * (dist - incm))[..., None])
        R = torch.clamp(rbase * invw_p, min=mmath.MINVAL)[..., None].expand(B, nc, nr)
        posb = dist[..., None].expand(B, nc, nr)
        mrgb = incm[..., None].expand(B, nc, nr)
    else:
        # elliptic (or frictionless): normal row, then the cone's rows
        Rn = torch.clamp(rbase * invw, min=mmath.MINVAL)
        aref_n = (-b_ * torch.einsum("bcv,bv->bc", Jn, qvel)
                  - k_ * imp_ * (dist - incm))
        nr = dim
        if dim > 1:
            # friction rows: D = normal D * impratio, rotational rows
            # also scaled by mu_k^2
            scale = m.opt.impratio.to(dtype).expand(B, nc, dim - 1)
            if dim > 3:
                scale = torch.cat([scale[..., :2],
                                   scale[..., 2:] * fric[..., 2:dim - 1] ** 2], -1)
            Rf = torch.clamp((rbase * invw)[..., None] / scale, min=mmath.MINVAL)
            aref_f = -b_[..., None] * torch.einsum("bcrv,bv->bcr", Jf, qvel)
            Jblk = torch.cat([Jn[:, :, None], Jf], 2)
            R = torch.cat([Rn[..., None], Rf], -1)
            aref = torch.cat([aref_n[..., None], aref_f], -1)
            zeros = torch.zeros(B, nc, dim - 1, dtype=dtype, device=dev)
            posb = torch.cat([dist[..., None], zeros], -1)
            mrgb = torch.cat([incm[..., None], zeros], -1)
            scol = mmath.static_tensor(solver_tpu._SIGMA_COL[:dim - 1], dev)
            out["sigma"] = torch.clamp(fric[..., scol], min=mmath.MINVAL)
        else:
            Jblk, R, aref = Jn[:, :, None], Rn[..., None], aref_n[..., None]
            posb, mrgb = dist[..., None], incm[..., None]
    out.update(J=Jblk, pos=posb, margin=mrgb, R=R, aref=aref,
               act=act[..., None].expand(B, nc, nr))
    return out


def _deepest(pen: torch.Tensor, k: int) -> torch.Tensor:
    """The k slots (B, k) of largest penetration pen (B, C) of each env, in
    slot order: lax.top_k's choice (a lower slot first among equal values,
    a stable sort), sorted back."""
    return torch.sort(torch.sort(pen, dim=1, descending=True, stable=True)[1][:, :k],
                      dim=1)[0]


def make_efc(m: Model, d: Data) -> Optional[Efc]:
    """The equality rows, the friction-loss rows, the limit rows, then the
    contact rows of every slot of d.contact (None without rows). Contact slots are grouped by
    (condim, dynamic). With m.con_topk = K, an elliptic cone group of more
    than K slots is built at each env's K deepest slots only (Efc.cb), when
    the rows go to the general Newton or to CG; the fused solver
    (solver_tpu.supports) takes every row, as the JAX package's TPU route
    does, and PGS works on the flat rows, which the JAX package builds at
    every slot."""
    _check_rows(m)
    if m.opt.disableflags & DisableBit.CONSTRAINT:
        return None
    eqs = _equalities(m)
    neq = sum(_EQ_ROWS[m.eq_type[e]] for e in eqs)
    fdofs, ftens = _frictional(m)
    nfri = len(fdofs) + len(ftens)
    jnts, ltens = _limited(m)
    nlim = len(jnts) + len(ltens)
    c = d.contact
    B, dtype, dev, nv = d.qpos.shape[0], d.qpos.dtype, d.qpos.device, m.nv
    solver_id = int(m.opt.solver)
    pyramidal = m.opt.cone == 0
    slots = []
    if m.ncon_max and not m.opt.disableflags & DisableBit.CONTACT:
        slots = [i for i in range(len(c.geom1)) if c.geom1[i] != -1]
    if not slots and not nlim and not neq and not nfri:
        return None

    def nrows(dim):
        return 2 * (dim - 1) if (pyramidal and dim > 1) else dim
    bases, rb = [], neq + nfri + nlim
    kinds = ["eq"] * neq + ["fri"] * nfri + ["lim"] * nlim
    for i in slots:
        bases.append(rb)
        rb += nrows(c.dim[i])
        kinds += ["lim" if pyramidal and c.dim[i] > 1 else "con"] * nrows(c.dim[i])
    nefc = rb
    ell = [k for k, i in enumerate(slots) if not (pyramidal and c.dim[i] > 1)]
    ci_of = {k: ci for ci, k in enumerate(ell)}
    sel = mmath.static_tensor([slots[k] for k in ell], dev, torch.int64)
    con_base = tuple(bases[k] for k in ell)
    con_dim = tuple(int(c.dim[slots[k]]) for k in ell)
    con_mu = c.friction[:, sel]
    con_act = c.dist[:, sel] < c.includemargin[:, sel]
    ktop = int(m.con_topk)
    if solver_id == SolverType.PGS or (solver_id == SolverType.NEWTON
                                       and solver_tpu.supports_rows(kinds, con_dim, nv)):
        ktop = 0

    gb = np.asarray(m.geom_bodyid, dtype=np.int64)
    dyn_rank = {i: r for r, i in enumerate(i for i in range(len(c.geom1))
                                           if c.geom1[i] == -2)}
    out = {name: torch.zeros(B, nefc, dtype=dtype, device=dev)
           for name in ("pos", "margin", "D", "R", "aref", "frictionloss")}
    J = torch.zeros(B, nefc, nv, dtype=dtype, device=dev)
    active = torch.zeros(B, nefc, dtype=torch.bool, device=dev)
    for lo, hi, rows in ((0, neq, neq and _eq_rows(m, d, eqs)),
                         (neq, neq + nfri, nfri and _friction_rows(m, d, fdofs, ftens)),
                         (neq + nfri, neq + nfri + nlim,
                          nlim and _limit_rows(m, d, jnts, ltens))):
        if rows:
            J[:, lo:hi] = rows.pop("J")
            active[:, lo:hi] = rows.pop("active")
            for name, val in rows.items():
                out[name][:, lo:hi] = val

    by_dim: dict = {}
    for k, i in enumerate(slots):
        by_dim.setdefault((int(c.dim[i]), c.geom1[i] == -2), []).append((k, i))
    groups, cbs = [], []
    for (dim, is_dyn), items in sorted(by_dim.items()):
        idx = mmath.static_tensor([i for _, i in items], dev)
        nc, nr = len(items), nrows(dim)
        if is_dyn:
            ranks = mmath.static_tensor([dyn_rank[i] for _, i in items], dev)
            gbt = mmath.static_tensor(gb, dev)
            pair = c.dyn_pair[:, ranks].long()
            b1, b2 = gbt[pair[..., 0]], gbt[pair[..., 1]]      # (B, nc)
        else:
            b1 = gb[np.array([c.geom1[i] for _, i in items])]
            b2 = gb[np.array([c.geom2[i] for _, i in items])]
        fields = [c.pos[:, idx], c.frame[:, idx], c.dist[:, idx],
                  c.includemargin[:, idx], c.solref[:, idx], c.solimp[:, idx],
                  c.friction[:, idx]]
        dest_np = np.concatenate([np.arange(bases[k], bases[k] + nr) for k, _ in items])
        cone = dim > 1 and not pyramidal
        if cone:
            groups.append((dim, tuple(ci_of[k] for k, _ in items)))
        if cone and ktop and nc > ktop:
            # active-contact compaction: each env's K deepest slots, their
            # rows built at size K, with their canonical rows per env
            keep = _deepest(fields[3] - fields[2], ktop)           # (B, K)
            fields = [torch.take_along_dim(f, keep.view(keep.shape + (1,) * (f.dim() - 2)), 1)
                      for f in fields]
            b1, b2 = (torch.take_along_dim(
                b if torch.is_tensor(b) else mmath.static_tensor(b, dev).expand(B, -1),
                keep, 1) for b in (b1, b2))
            rows = _contact_rows(m, d, dim, b1, b2, *fields, fields[2] < fields[3])
            dest = mmath.static_tensor(dest_np.reshape(nc, nr), dev)[keep]
            cbs.append(solver.Cones(dim, dest, rows["J"], rows["aref"], 1.0 / rows["R"],
                                    rows["R"], rows["sigma"], rows["act"][..., 0]))
            continue
        if cone:
            cbs.append(None)
        rows = _contact_rows(m, d, dim, b1, b2, *fields, fields[2] < fields[3])
        dest = mmath.static_tensor(dest_np, dev)
        J[:, dest] = rows["J"].reshape(B, nc * nr, nv)
        for name in ("pos", "margin", "R", "aref"):
            out[name][:, dest] = rows[name].reshape(B, nc * nr)
        out["D"][:, dest] = 1.0 / rows["R"].reshape(B, nc * nr)
        active[:, dest] = rows["act"].reshape(B, nc * nr)
    return Efc(J=J, active=active, kinds=tuple(kinds), con_base=con_base,
               con_dim=con_dim, con_mu=con_mu, con_active=con_act,
               groups=tuple(groups), cb=tuple(cbs), **out)


def row_layout(m: Model) -> dict:
    """Static efc row layout (no Data needed) in assembly order: equality,
    friction loss, joint and tendon limits (the row of each limited joint
    and tendon: 'lim_jnt', 'lim_ten'), then the first row of each contact
    slot, and the total row count."""
    flags = m.opt.disableflags
    nrow = 0
    if not flags & (DisableBit.CONSTRAINT | DisableBit.EQUALITY):
        nrow += sum(_EQ_ROWS.get(t, 1) for t in m.eq_type)
    nrow += sum(map(len, _frictional(m)))
    jnts, tens = _limited(m)
    lim_jnt = {j: nrow + k for k, j in enumerate(jnts)}
    lim_ten = {t: nrow + len(jnts) + k for k, t in enumerate(tens)}
    nrow += len(jnts) + len(tens)
    con_bases, con_nrows = [], []
    if m.ncon_max and not flags & (DisableBit.CONSTRAINT | DisableBit.CONTACT):
        pyramidal = m.opt.cone == 0
        for dim in slot_meta(m)[2]:
            nr = 2 * (dim - 1) if (pyramidal and dim > 1) else dim
            con_bases.append(nrow)
            con_nrows.append(nr)
            nrow += nr
    return dict(lim_jnt=lim_jnt, lim_ten=lim_ten, con=con_bases, con_nrows=con_nrows,
                pyramidal=(m.opt.cone == 0), nrow=nrow)


def fwd_constraint(m: Model, d: Data) -> Data:
    efc = make_efc(m, d)
    if efc is None:
        return d.replace(qacc=d.qacc_smooth,
                         qfrc_constraint=torch.zeros_like(d.qacc_smooth))
    return solver.solve(m, d, efc)
