"""Smooth (unconstrained) dynamics as level-order batch ops.

Counterpart of mujoco_ros_pkgs_tpu/ops/smooth.py: kinematics, com_pos, crb,
com_vel, rne, passive (joint damping and springs), xfrc_accumulate,
solve_m / mul_m and the fwd_*_smooth stages of the general step (the
position stage also places the sites). Tree
recursions are level-order sweeps: bodies grouped by tree depth (static),
each level one gather/compute/scatter over all its bodies. All tensors are
batch-first. `kinematics`, `com_pos` and `crb` take and return tensors (the
compile side uses them at load time, core/constants.py); the stages take
and return `Data`. Mocap bodies take their pose from `mocap_pos` /
`mocap_quat` in the kinematics sweep. Tendons (`tendon`: length, ten_J,
velocity; fixed ones by segment sums, spatial ones through ops/wrap.py in
one pass over every segment and wrap) feed the passive forces (springs
with a deadband, damping), the tendon transmission and the tendon rows.
`passive` adds both fluid models where the model has a medium.
`transmission` takes the JAX package's five groups (1-dof, ball and free
joints, tendons, sites) and `actuation` its activation dynamics
(integrator, filter, filterexact, muscle: act_dot), fixed, affine and
muscle gains and biases (ops/muscle.py) and the force and joint-force
clamps.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core.types import (
    BiasType, Data, DisableBit, DynType, GainType, GeomType, JointType, Model, TrnType,
    WrapType,
)
from mujoco_ros_pkgs_tpu_torch.ops import linalg_tpu, muscle
from mujoco_ros_pkgs_tpu_torch.ops import math as mmath


# ---------------------------------------------------------------------------
# static topology helpers (memoized on static tuples)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=128)
def _dof_ancestor_mask(dof_parentid, nv) -> np.ndarray:
    mask = np.zeros((nv, nv), dtype=bool)
    for i in range(nv):
        j = i
        while j >= 0:
            mask[i, j] = True
            j = dof_parentid[j]
    return mask


@functools.lru_cache(maxsize=128)
def _body_dof_mask(body_parentid, body_dofnum, body_dofadr, nv) -> np.ndarray:
    nbody = len(body_parentid)
    mask = np.zeros((nv, nbody), dtype=bool)
    for b in range(nbody):
        bid = b
        while bid != 0:
            if body_dofnum[bid]:
                adr = body_dofadr[bid]
                mask[adr:adr + body_dofnum[bid], b] = True
            bid = body_parentid[bid]
    return mask


def body_dof_mask(m: Model) -> np.ndarray:
    """mask[j, b] = 1 if dof j moves body b (the dof's body is an ancestor)."""
    return _body_dof_mask(m.body_parentid, m.body_dofnum, m.body_dofadr, m.nv)


class _Level(NamedTuple):
    ids: np.ndarray        # bodies at this depth
    par: np.ndarray        # their parents
    joints: tuple          # per joint slot k: (jid, jmask, jtype) over ids


@functools.lru_cache(maxsize=128)
def _levels(body_parentid, body_jntadr, body_jntnum, jnt_type):
    """Bodies grouped by depth (world excluded), shallowest first, with the
    per-slot joint tables of each level."""
    nbody = len(body_parentid)
    depth = np.zeros(nbody, dtype=np.int64)
    for b in range(1, nbody):
        depth[b] = depth[body_parentid[b]] + 1
    par = np.asarray(body_parentid, dtype=np.int64)
    jadr = np.asarray(body_jntadr, dtype=np.int64)
    jnum = np.asarray(body_jntnum, dtype=np.int64)
    jtype = np.asarray(jnt_type, dtype=np.int64)
    out = []
    for dep in range(1, int(depth.max()) + 1 if nbody > 1 else 1):
        ids = np.nonzero(depth == dep)[0]
        if not ids.size:
            continue
        joints = []
        for k in range(int(jnum[ids].max())):
            jmask = jnum[ids] > k
            jid = np.where(jmask, jadr[ids] + k, 0)
            joints.append((jid, jmask, jtype[jid]))
        out.append(_Level(ids, par[ids], tuple(joints)))
    return tuple(out)


def _model_levels(m: Model):
    return _levels(m.body_parentid, m.body_jntadr, m.body_jntnum, m.jnt_type)


@functools.lru_cache(maxsize=128)
def _dof_meta(jnt_type, jnt_dofadr, dof_jntid):
    """Per-dof kind (0 free translation, 1 body-axis rotation of free/ball,
    2 slide, 3 hinge) and one-hot axis number for kinds 0/1."""
    nv = len(dof_jntid)
    kind = np.zeros(nv, dtype=np.int64)
    axno = np.zeros(nv, dtype=np.int64)
    for v in range(nv):
        j = dof_jntid[v]
        t = jnt_type[j]
        off = v - jnt_dofadr[j]
        if t == int(JointType.FREE):
            kind[v], axno[v] = (0, off) if off < 3 else (1, off - 3)
        elif t == int(JointType.BALL):
            kind[v], axno[v] = 1, off
        else:
            kind[v] = 2 if t == int(JointType.SLIDE) else 3
    return kind, np.eye(3)[axno]


class Kinematics(NamedTuple):
    qpos: torch.Tensor       # (B, nq) with renormalized quaternions
    xpos: torch.Tensor       # (B, nbody, 3)
    xquat: torch.Tensor      # (B, nbody, 4)
    xmat: torch.Tensor       # (B, nbody, 3, 3)
    xipos: torch.Tensor      # (B, nbody, 3)
    ximat: torch.Tensor      # (B, nbody, 3, 3)
    xanchor: torch.Tensor    # (B, njnt, 3)
    xaxis: torch.Tensor      # (B, njnt, 3)
    geom_xpos: torch.Tensor  # (B, ngeom, 3)
    geom_xmat: torch.Tensor  # (B, ngeom, 3, 3)


# ---------------------------------------------------------------------------
# mj_kinematics
# ---------------------------------------------------------------------------

def mocap_defaults(m: Model, B: int, dtype, dev):
    """The mocap bodies' model poses (body_pos, body_quat) in mocap order:
    (B, nmocap, 3), (B, nmocap, 4) (mj_resetData's mocap_pos, mocap_quat)."""
    ids = mmath.static_tensor([b for b in range(m.nbody) if m.body_mocapid[b] >= 0],
                              dev, torch.int64)
    return (m.body_pos[ids].to(dtype).expand(B, -1, -1),
            m.body_quat[ids].to(dtype).expand(B, -1, -1))


def kinematics(m: Model, qpos: torch.Tensor, mocap_pos: torch.Tensor = None,
               mocap_quat: torch.Tensor = None) -> Kinematics:
    """Forward kinematics of a batch (B, nq); renormalizes quaternions in
    qpos as MuJoCo does. One vectorized pass per tree depth: all four joint
    types are computed and mask-selected. Mocap bodies take mocap_pos and
    the normalised mocap_quat (B, nmocap, 3 / 4; the model's body pose
    when not given) before their children are placed."""
    B, dtype, dev = qpos.shape[0], qpos.dtype, qpos.device
    if m.nmocap and mocap_pos is None:
        mocap_pos, mocap_quat = mocap_defaults(m, B, dtype, dev)
    xpos = torch.zeros(B, m.nbody, 3, dtype=dtype, device=dev)
    xquat = torch.zeros(B, m.nbody, 4, dtype=dtype, device=dev)
    xquat[:, 0, 0] = 1.0
    xanchor = torch.zeros(B, m.njnt, 3, dtype=dtype, device=dev)
    xaxis = torch.zeros(B, m.njnt, 3, dtype=dtype, device=dev)
    qpos_out = qpos.clone()
    qposadr = np.asarray(m.jnt_qposadr, dtype=np.int64)
    top = max(m.nq - 1, 0)
    FREE, BALL = int(JointType.FREE), int(JointType.BALL)
    SLIDE, HINGE = int(JointType.SLIDE), int(JointType.HINGE)

    for lv in _model_levels(m):
        par = mmath.static_tensor(lv.par, dev)
        ids = mmath.static_tensor(lv.ids, dev)
        pq, pp = xquat[:, par], xpos[:, par]
        quat = mmath.quat_mul(pq, m.body_quat[ids])
        pos = pp + mmath.rot_vec_quat(m.body_pos[ids], pq)

        for jid_np, jmask_np, jt in lv.joints:
            qa = qposadr[jid_np]
            qi = mmath.static_tensor(np.minimum(qa[:, None] + np.arange(7), top), dev)
            qblk = qpos[:, qi]                                  # (B, W, 7)
            jid = mmath.static_tensor(jid_np, dev)
            jp, ja = m.jnt_pos[jid], m.jnt_axis[jid]
            dq = qblk[..., 0] - m.qpos0[mmath.static_tensor(np.minimum(qa, top), dev)]

            anchor_c = pos + mmath.rot_vec_quat(jp, quat)
            axis_c = mmath.rot_vec_quat(ja, quat)

            def flag(t):
                return mmath.static_tensor(jt == t, dev)[:, None]
            is_free, is_ball = flag(FREE), flag(BALL)
            is_slide, is_hinge = flag(SLIDE), flag(HINGE)

            qloc_h = mmath.axis_angle_to_quat(ja, dq)
            quat_h = mmath.quat_mul(quat, qloc_h)
            pos_h = anchor_c - mmath.rot_vec_quat(jp, quat_h)
            pos_s = pos + axis_c * dq[..., None]
            anchor_s = pos_s + mmath.rot_vec_quat(jp, quat)
            qloc_b = mmath.normalize(qblk[..., :4])
            quat_b = mmath.quat_mul(quat, qloc_b)
            pos_b = anchor_c - mmath.rot_vec_quat(jp, quat_b)
            pos_f = qblk[..., :3]
            quat_f = mmath.normalize(qblk[..., 3:7])

            new_quat = torch.where(is_free, quat_f, torch.where(
                is_ball, quat_b, torch.where(is_hinge, quat_h, quat)))
            new_pos = torch.where(is_free, pos_f, torch.where(
                is_ball, pos_b, torch.where(is_hinge, pos_h, torch.where(
                    is_slide, pos_s, pos))))
            anch = torch.where(is_free, new_pos,
                               torch.where(is_slide, anchor_s, anchor_c))
            axv = torch.where(is_free, ja.expand_as(axis_c), axis_c)

            jmask = mmath.static_tensor(jmask_np, dev)
            quat = torch.where(jmask[:, None], new_quat, quat)
            pos = torch.where(jmask[:, None], new_pos, pos)
            lanes = np.nonzero(jmask_np)[0]
            lanes_t = mmath.static_tensor(lanes, dev)
            jl = mmath.static_tensor(jid_np[lanes], dev)
            xanchor[:, jl] = anch[:, lanes_t]
            xaxis[:, jl] = axv[:, lanes_t]
            # renormalized quaternions go back into qpos (free at +3, ball at +0)
            for w in lanes:
                if jt[w] == FREE:
                    qpos_out[:, qa[w] + 3:qa[w] + 7] = quat_f[:, w]
                elif jt[w] == BALL:
                    qpos_out[:, qa[w]:qa[w] + 4] = qloc_b[:, w]

        mocap = np.asarray(m.body_mocapid)[lv.ids]
        if (mocap >= 0).any():
            mc = mmath.static_tensor(np.maximum(mocap, 0), dev)
            is_mocap = mmath.static_tensor(mocap >= 0, dev)[:, None]
            pos = torch.where(is_mocap, mocap_pos[:, mc], pos)
            quat = torch.where(is_mocap, mmath.normalize(mocap_quat[:, mc]), quat)

        xquat[:, ids] = mmath.normalize(quat)
        xpos[:, ids] = pos

    xmat = mmath.quat_to_mat(xquat)
    xipos = xpos + mmath.rot_vec_quat(m.body_ipos, xquat)
    ximat = xmat @ mmath.quat_to_mat(m.body_iquat)
    gb = mmath.static_tensor(m.geom_bodyid, dev, torch.int64)
    geom_xpos = xpos[:, gb] + torch.einsum("bgij,gj->bgi", xmat[:, gb], m.geom_pos)
    geom_xmat = xmat[:, gb] @ mmath.quat_to_mat(m.geom_quat)
    return Kinematics(qpos_out, xpos, xquat, xmat, xipos, ximat, xanchor,
                      xaxis, geom_xpos, geom_xmat)


# ---------------------------------------------------------------------------
# mj_comPos and mj_crb
# ---------------------------------------------------------------------------

def com_pos(m: Model, kin: Kinematics):
    """mj_comPos: (subtree_com (B,nbody,3), cinert (B,nbody,10), cdof (B,nv,6))."""
    dev = kin.xpos.device
    levels = _model_levels(m)
    wsum = m.body_mass[:, None] * kin.xipos
    for lv in reversed(levels):
        wsum = wsum.index_add(1, mmath.static_tensor(lv.par, dev),
                              wsum[:, mmath.static_tensor(lv.ids, dev)])
    subtree_com = wsum / torch.clamp(m.body_subtreemass, min=mmath.MINVAL)[:, None]
    # a massless world's subtree com is 0 (a select, not a host branch on a
    # device value, so the step does not wait for the card here)
    subtree_com[:, 0] = torch.where(m.body_subtreemass[0] > mmath.MINVAL,
                                    subtree_com[:, 0], 0.0)

    rootid = mmath.static_tensor(m.body_rootid, dev, torch.int64)
    ref = subtree_com[:, rootid]
    I_world = (kin.ximat * m.body_inertia[:, None, :]) @ kin.ximat.transpose(-1, -2)
    cinert = mmath.inert_from_mass_com_fullinertia(
        m.body_mass.expand(kin.xipos.shape[:-1]), I_world, kin.xipos - ref)

    kind, onehot = _dof_meta(m.jnt_type, m.jnt_dofadr, m.dof_jntid)
    db = mmath.static_tensor(m.dof_bodyid, dev, torch.int64)
    dj = mmath.static_tensor(m.dof_jntid, dev, torch.int64)
    oh = mmath.static_tensor(onehot, dev, kin.xpos.dtype)
    offset = ref[:, db] - kin.xanchor[:, dj]
    rot_axis = torch.einsum("bvij,vj->bvi", kin.xmat[:, db], oh)
    jaxis = kin.xaxis[:, dj]
    k = mmath.static_tensor(kind, dev)[:, None]
    ang = torch.where(k == 1, rot_axis, torch.where(k == 3, jaxis, 0.0))
    lin = torch.where(k == 0, oh, torch.where(k == 2, jaxis,
                                              mmath.cross(ang, offset)))
    return subtree_com, cinert, torch.cat([ang, lin], -1)


def crb(m: Model, cinert: torch.Tensor, cdof: torch.Tensor) -> torch.Tensor:
    """Composite rigid body: dense qM (B, nv, nv) = J^T I J by topology masks."""
    dev = cinert.device
    crb_inert = cinert
    for lv in reversed(_model_levels(m)):
        crb_inert = crb_inert.index_add(
            1, mmath.static_tensor(lv.par, dev),
            crb_inert[:, mmath.static_tensor(lv.ids, dev)])
    dof_bodyid = mmath.static_tensor(m.dof_bodyid, dev, torch.int64)
    F = mmath.inert_vec_mul(crb_inert[:, dof_bodyid], cdof)
    G = F @ cdof.transpose(-1, -2)
    amask = _dof_ancestor_mask(m.dof_parentid, m.nv)
    lower = mmath.static_tensor(amask, dev, G.dtype)
    strict = mmath.static_tensor(amask & ~np.eye(m.nv, dtype=bool), dev, G.dtype)
    qM = G * lower + (G * strict).transpose(-1, -2)
    return qM + torch.diag(m.dof_armature)


# ---------------------------------------------------------------------------
# mj_comVel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=128)
def _joint_dof_masks(jt: tuple):
    """Per joint slot of a level: (translation mask, rotation mask) over the
    six dofs read from the joint's dof address (free: 3 + 3, ball: 3, hinge
    and slide: 1)."""
    jt = np.asarray(jt)
    FREE, BALL = int(JointType.FREE), int(JointType.BALL)
    jnv = np.select([jt == FREE, jt == BALL], [6, 3], 1)
    trans = (jt == FREE)[:, None] & (np.arange(6)[None, :] < 3)
    rot = (np.arange(6)[None, :] < jnv[:, None]) & ~trans
    return trans, rot


def com_vel(m: Model, d: Data) -> Data:
    """cvel and cdof_dot by a level-order sweep; each body's joints are folded
    in joint order (engine_core_smooth.c mj_comVel)."""
    B, dtype, dev = d.qpos.shape[0], d.qpos.dtype, d.qpos.device
    cvel = torch.zeros(B, m.nbody, 6, dtype=dtype, device=dev)
    cdof_dot = torch.zeros(B, m.nv, 6, dtype=dtype, device=dev)
    dofadr = np.asarray(m.jnt_dofadr, dtype=np.int64)
    top = max(m.nv - 1, 0)
    for lv in _model_levels(m):
        v = cvel[:, mmath.static_tensor(lv.par, dev)]
        for jid_np, jmask_np, jt in lv.joints:
            adr = dofadr[jid_np]
            didx = mmath.static_tensor(np.minimum(adr[:, None] + np.arange(6), top), dev)
            blk = d.cdof[:, didx]                              # (B, W, 6, 6)
            qv = d.qvel[:, didx]                               # (B, W, 6)
            trans, rot = _joint_dof_masks(tuple(int(t) for t in jt))
            tm = mmath.static_tensor(trans, dev, dtype)
            rm = mmath.static_tensor(rot, dev, dtype)
            # free joints: the rotation rows see the translation part (vmid)
            vmid = v + torch.einsum("bwi,bwij->bwj", qv * tm, blk)
            dots = mmath.motion_cross(vmid[:, :, None, :], blk)
            w_i, k_i = np.nonzero(rot & jmask_np[:, None])
            cdof_dot[:, mmath.static_tensor(adr[w_i] + k_i, dev)] = \
                dots[:, mmath.static_tensor(w_i, dev), mmath.static_tensor(k_i, dev)]
            vout = vmid + torch.einsum("bwi,bwij->bwj", qv * rm, blk)
            v = torch.where(mmath.static_tensor(jmask_np, dev)[:, None], vout, v)
        cvel[:, mmath.static_tensor(lv.ids, dev)] = v
    return d.replace(cvel=cvel, cdof_dot=cdof_dot)


# ---------------------------------------------------------------------------
# mj_rne (flg_acc = 0): qfrc_bias
# ---------------------------------------------------------------------------

def bias_acc(m: Model, d: Data, world_acc: torch.Tensor) -> torch.Tensor:
    """Every body's spatial acceleration at qacc = 0 (B, nbody, 6), the
    world's set to world_acc (6,): mj_rne's forward sweep, cdof_dot qvel
    summed down the tree."""
    B, dtype, dev = d.qpos.shape[0], d.qpos.dtype, d.qpos.device
    cacc = torch.zeros(B, m.nbody, 6, dtype=dtype, device=dev)
    cacc[:, 0] = world_acc
    maxdof = max(list(m.body_dofnum) + [1])
    dofadr = np.asarray(m.body_dofadr, dtype=np.int64)
    dofnum = np.asarray(m.body_dofnum, dtype=np.int64)
    for lv in _model_levels(m):
        a = cacc[:, mmath.static_tensor(lv.par, dev)]
        didx = mmath.static_tensor(np.minimum(dofadr[lv.ids][:, None] + np.arange(maxdof),
                                              max(m.nv - 1, 0)), dev)
        mask = mmath.static_tensor(np.arange(maxdof)[None, :] < dofnum[lv.ids][:, None],
                                   dev, dtype)
        a = a + torch.einsum("bwi,bwij->bwj", d.qvel[:, didx] * mask, d.cdof_dot[:, didx])
        cacc[:, mmath.static_tensor(lv.ids, dev)] = a
    return cacc


def rne(m: Model, d: Data) -> Data:
    dtype, dev = d.qpos.dtype, d.qpos.device
    gravity = (0.0 if m.opt.disableflags & DisableBit.GRAVITY else 1.0) * m.opt.gravity
    world = torch.cat([torch.zeros(3, dtype=dtype, device=dev), -gravity.to(dtype)])
    cacc = bias_acc(m, d, world)
    cfrc = (mmath.inert_vec_mul(d.cinert, cacc)
            + mmath.force_cross(d.cvel, mmath.inert_vec_mul(d.cinert, d.cvel)))
    for lv in reversed(_model_levels(m)):
        cfrc = cfrc.index_add(1, mmath.static_tensor(lv.par, dev),
                              cfrc[:, mmath.static_tensor(lv.ids, dev)])
    dof_bodyid = mmath.static_tensor(m.dof_bodyid, dev, torch.int64)
    return d.replace(qfrc_bias=(d.cdof * cfrc[:, dof_bodyid]).sum(-1))


# ---------------------------------------------------------------------------
# passive forces, applied forces, tendons and actuation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=128)
def _spring_meta(jnt_type, jnt_qposadr, jnt_dofadr):
    """(joint, qpos address, dof address) rows of the 1-dof, ball and free
    joints."""
    g1, gb, gf = [], [], []
    for j, t in enumerate(jnt_type):
        row = (j, jnt_qposadr[j], jnt_dofadr[j])
        if t in (int(JointType.SLIDE), int(JointType.HINGE)):
            g1.append(row)
        elif t == int(JointType.BALL):
            gb.append(row)
        else:
            gf.append(row)
    return tuple(np.asarray(x, dtype=np.int64).reshape(-1, 3) for x in (g1, gb, gf))


def passive(m: Model, d: Data) -> Data:
    """Joint damping, joint springs, the tendons' springs (with the
    deadband [lengthspring0, lengthspring1], -1 meaning length0) and
    damping mapped by ten_J, and the fluid forces where the model has a
    medium (mj_passive)."""
    if m.nv == 0:
        return d
    if m.opt.disableflags & DisableBit.PASSIVE:
        return d.replace(qfrc_passive=torch.zeros_like(d.qvel))
    qfrc = -m.dof_damping * d.qvel
    g1, gb, gf = _spring_meta(m.jnt_type, m.jnt_qposadr, m.jnt_dofadr)
    dev = d.qpos.device
    ar3, ar4 = np.arange(3), np.arange(4)

    def t(a):
        return mmath.static_tensor(a, dev)
    if len(g1):
        j, qa, va = g1.T
        qfrc[:, t(va)] += -m.jnt_stiffness[t(j)] * (d.qpos[:, t(qa)] - m.qpos_spring[t(qa)])
    if len(gb):
        j, qa, va = gb.T
        qi = t(qa[:, None] + ar4)
        dif = mmath.quat_sub(d.qpos[:, qi], m.qpos_spring[qi])
        qfrc[:, t(va[:, None] + ar3)] += -m.jnt_stiffness[t(j)][:, None] * dif
    if len(gf):
        j, qa, va = gf.T
        stiff = m.jnt_stiffness[t(j)][:, None]
        qi = t(qa[:, None] + ar3)
        qfrc[:, t(va[:, None] + ar3)] += -stiff * (d.qpos[:, qi] - m.qpos_spring[qi])
        qi = t(qa[:, None] + 3 + ar4)
        dif = mmath.quat_sub(d.qpos[:, qi], m.qpos_spring[qi])
        qfrc[:, t(va[:, None] + 3 + ar3)] += -stiff * dif
    if m.ntendon:
        spring = m.tendon_lengthspring
        low = torch.where(spring[:, 0] < 0, m.tendon_length0, spring[:, 0])
        high = torch.where(spring[:, 1] < 0, m.tendon_length0, spring[:, 1])
        L = d.ten_length
        displ = torch.where(L > high, high - L, torch.where(L < low, low - L, 0.0))
        frc = m.tendon_stiffness * displ - m.tendon_damping * d.ten_velocity
        qfrc = qfrc + torch.einsum("btv,bt->bv", d.ten_J, frc)
    if m.has_fluid:
        qfrc = qfrc + fluid_qfrc(m, d)
    return d.replace(qfrc_passive=qfrc)


@functools.lru_cache(maxsize=128)
def _fluid_meta(geom_fluid_active, geom_bodyid, geom_type, nbody):
    """The ellipsoid model's geoms, their bodies and semiaxis rules (the
    geom type), and the bodies the inertia-box model takes: every body but
    the world and those with a fluid-active geom, whose geoms all go to the
    ellipsoid model."""
    act = np.asarray([g for g, a in enumerate(geom_fluid_active) if a], dtype=np.int64)
    bodies = np.asarray(geom_bodyid, dtype=np.int64)[act]
    box_live = np.arange(nbody) > 0
    box_live[bodies] = False
    return act, bodies, np.asarray(geom_type, dtype=np.int64)[act], box_live


def fluid_qfrc(m: Model, d: Data) -> torch.Tensor:
    """Fluid forces from opt.density, opt.viscosity and opt.wind mapped to
    joint space (B, nv): the inertia-box model (mj_inertiaBoxFluidModel: the
    body's equivalent box, a viscous sphere of its mean size and quadratic
    drag on its faces, in the inertia frame, at the com) for every body
    without a fluid-active geom, the ellipsoid model (_fluid_ellipsoid_xfrc)
    for the rest."""
    dtype, dev = d.qpos.dtype, d.qpos.device
    act, _, _, box_live = _fluid_meta(m.geom_fluid_active, m.geom_bodyid, m.geom_type,
                                      m.nbody)
    mass = torch.clamp(m.body_mass, min=mmath.MINVAL).to(dtype)
    I = m.body_inertia.to(dtype)                                      # (nbody, 3)
    Isum = I.sum(1, keepdim=True)
    box = torch.sqrt(torch.clamp(Isum - 2 * I, min=mmath.MINVAL) / mass[:, None] * 6.0) / 2.0
    ref = d.subtree_com[:, mmath.static_tensor(m.body_rootid, dev, torch.int64)]
    ang_w = d.cvel[..., :3]
    lin_w = d.cvel[..., 3:] + mmath.cross(ang_w, d.xipos - ref)
    wind = m.opt.wind.to(dtype)
    ang = torch.einsum("bnij,bni->bnj", d.ximat, ang_w)
    lin = torch.einsum("bnij,bni->bnj", d.ximat, lin_w - wind)
    viscosity = m.opt.viscosity.to(dtype)
    density = m.opt.density.to(dtype)
    diam = box.mean(1) * 2.0
    lfrc_ang = -(np.pi * diam[:, None] ** 3 * viscosity * ang)
    lfrc_lin = -(3.0 * np.pi * diam[:, None] * viscosity * lin)
    b0, b1, b2 = box[:, 0], box[:, 1], box[:, 2]
    area = torch.stack([b1 * b2, b0 * b2, b0 * b1], 1)
    lfrc_lin = lfrc_lin - 2.0 * density * area * torch.abs(lin) * lin
    plate = torch.stack([b0 * (b1 ** 4 + b2 ** 4), b1 * (b0 ** 4 + b2 ** 4),
                         b2 * (b0 ** 4 + b1 ** 4)], 1)
    lfrc_ang = lfrc_ang - 0.5 * density * plate * torch.abs(ang) * ang
    frc_w = torch.einsum("bnij,bnj->bni", d.ximat, lfrc_lin)
    trq_w = torch.einsum("bnij,bnj->bni", d.ximat, lfrc_ang)
    xfrc = torch.cat([frc_w, trq_w], -1) * mmath.static_tensor(box_live, dev, dtype)[:, None]
    if act.size:
        xfrc = xfrc + _fluid_ellipsoid_xfrc(m, d)
    return body_frc_accumulate(m, d, xfrc)


def _fluid_ellipsoid_xfrc(m: Model, d: Data) -> torch.Tensor:
    """The ellipsoid model's forces per body (B, nbody, 6), [force, torque]
    at the com in the world frame (mj_ellipsoidFluidModel: added mass,
    Magnus and Kutta lift, viscous and quadratic drag of each fluid-active
    geom's equivalent ellipsoid, from the 12 numbers core/mjcf packs)."""
    dtype, dev = d.qpos.dtype, d.qpos.device
    act_np, bid_np, gtype, _ = _fluid_meta(m.geom_fluid_active, m.geom_bodyid,
                                           m.geom_type, m.nbody)
    act = mmath.static_tensor(act_np, dev)
    bidx = mmath.static_tensor(bid_np, dev)
    root = mmath.static_tensor(np.asarray(m.body_rootid, dtype=np.int64)[bid_np], dev)
    # equivalent-ellipsoid semiaxes: a capsule's include its caps
    s = m.geom_size[act].to(dtype)

    def is_(*kinds):
        return mmath.static_tensor(np.isin(gtype, [int(k) for k in kinds]), dev)
    round_ = is_(GeomType.SPHERE, GeomType.CAPSULE, GeomType.CYLINDER)
    semi = torch.stack([
        s[:, 0], torch.where(round_, s[:, 0], s[:, 1]),
        torch.where(is_(GeomType.SPHERE), s[:, 0], torch.where(
            is_(GeomType.CAPSULE), s[:, 1] + s[:, 0],
            torch.where(is_(GeomType.CYLINDER), s[:, 1], s[:, 2])))], 1)
    gf = m.geom_fluid[act].to(dtype)
    blunt, slender, angd = gf[:, 1], gf[:, 2], gf[:, 3]
    kutta, magnus = gf[:, 4], gf[:, 5]
    vmass, vinertia = gf[:, 6:9], gf[:, 9:12]

    ref = d.subtree_com[:, root]
    R = d.geom_xmat[:, act]
    p = d.geom_xpos[:, act]
    ang_w = d.cvel[:, bidx, :3]
    lin_w = d.cvel[:, bidx, 3:] + mmath.cross(ang_w, p - ref)
    ang = torch.einsum("bgij,bgi->bgj", R, ang_w)
    lin = torch.einsum("bgij,bgi->bgj", R, lin_w - m.opt.wind.to(dtype))
    density = m.opt.density.to(dtype)
    viscosity = m.opt.viscosity.to(dtype)
    pi = np.pi

    # added mass: the gyroscopic coupling of the virtual momenta
    plin = density * vmass * lin
    pang = density * vinertia * ang
    f_l = mmath.cross(plin, ang)
    t_l = mmath.cross(plin, lin) + mmath.cross(pang, ang)

    vol = 4.0 / 3.0 * pi * torch.prod(semi, 1)
    d_max = semi.max(1).values
    d_min = semi.min(1).values
    d_mid = semi.sum(1) - d_max - d_min
    a_max = pi * d_max * d_mid
    magnus_f = mmath.cross(ang, lin) * (magnus * density * vol)[..., None]
    faces = torch.stack([semi[:, 1] * semi[:, 2], semi[:, 2] * semi[:, 0],
                         semi[:, 0] * semi[:, 1]], 1)
    proj_denom = (faces ** 4 * lin ** 2).sum(-1)
    proj_num = (faces ** 2 * lin ** 2).sum(-1)
    ratio = proj_denom / torch.clamp(proj_num, min=mmath.MINVAL)
    a_proj = pi * torch.sqrt(torch.clamp(ratio, min=mmath.MINVAL ** 2))
    norm_v = faces ** 2 * lin
    lin_norm = mmath.norm_safe(lin)
    cos_alpha = proj_num / torch.clamp(lin_norm * proj_denom, min=mmath.MINVAL)
    kutta_circ = mmath.cross(norm_v, lin) * (kutta * density * cos_alpha * a_proj)[..., None]
    kutta_f = mmath.cross(kutta_circ, lin)
    eq_d = 2.0 / 3.0 * semi.sum(1)
    i_max = 8.0 / 15.0 * pi * d_mid * d_max ** 4
    ii = 8.0 / 15.0 * pi * semi * torch.stack(
        [torch.maximum(semi[:, 1], semi[:, 2]), torch.maximum(semi[:, 2], semi[:, 0]),
         torch.maximum(semi[:, 0], semi[:, 1])], 1) ** 4
    mom_visc = ang * (angd[:, None] * ii + slender[:, None] * (i_max[:, None] - ii))
    drag_lin = (viscosity * 3.0 * pi * eq_d
                + density * lin_norm * (a_proj * blunt + slender * (a_max - a_proj)))
    drag_ang = viscosity * pi * eq_d ** 3 + density * mmath.norm_safe(mom_visc)
    t_l = t_l - drag_ang[..., None] * ang
    f_l = f_l + magnus_f + kutta_f - drag_lin[..., None] * lin

    f_w = torch.einsum("bgij,bgj->bgi", R, f_l)
    t_w = torch.einsum("bgij,bgj->bgi", R, t_l) + mmath.cross(p - d.xipos[:, bidx], f_w)
    return d.qpos.new_zeros(d.qpos.shape[0], m.nbody, 6).index_add(
        1, bidx, torch.cat([f_w, t_w], -1))


def body_frc_accumulate(m: Model, d: Data, xfrc: torch.Tensor) -> torch.Tensor:
    """Per-body [force, torque] (B, nbody, 6) at each body's com, world
    frame, mapped to joint space (mj_applyFT at xipos for every body):
    (B, nv)."""
    dev = d.qpos.device
    rootid = mmath.static_tensor(m.body_rootid, dev, torch.int64)
    vec = torch.cat([xfrc[..., 3:], xfrc[..., :3]], -1)
    fs = mmath.transform_force(vec, d.subtree_com[:, rootid], d.xipos)
    mask = mmath.static_tensor(body_dof_mask(m), dev, d.qpos.dtype)
    return ((d.cdof @ fs.transpose(-1, -2)) * mask).sum(-1)


def xfrc_accumulate(m: Model, d: Data) -> torch.Tensor:
    """xfrc_applied ([force, torque] at each body's com, world frame) mapped
    to joint space: (B, nv)."""
    return body_frc_accumulate(m, d, d.xfrc_applied)


@functools.lru_cache(maxsize=128)
def _tendon_meta(tendon_adr, tendon_num, wrap_type, wrap_objid, wrap_sidesite,
                 wrap_divisor, jnt_qposadr, jnt_dofadr, site_bodyid, geom_bodyid, nsite):
    """The tendons' static structure (the JAX package's _tendon_meta, as
    index arrays). Fixed tendons: (tendon, wrap entry, qpos address, dof
    address) of every joint entry. Spatial tendons: their paths walked once
    (a pulley starts a branch with its divisor; a wrap geom sits between two
    sites) into 'wrap' columns (tendon, geom, sidesite or -1, sphere or not,
    the sites before and after, divisor) and 'seg' columns, one per straight
    segment: its endpoints as indices into [sites, wrap tangent points t0,
    wrap tangent points t1], their bodies, its tendon and divisor. A
    spatial path that does not start and end at a site, a wrap geom not
    between two sites, or joint entries mixed into a path raise
    ValueError."""
    fixed = []
    wrap = {k: [] for k in ("ten", "geom", "side", "sphere", "prev", "next", "div")}
    seg = {k: [] for k in ("a", "b", "abody", "bbody", "ten", "div")}
    spatial = []
    SITE, SPHERE, CYL = int(WrapType.SITE), int(WrapType.SPHERE), int(WrapType.CYLINDER)
    for t, (adr, num) in enumerate(zip(tendon_adr, tendon_num)):
        kinds = [wrap_type[k] for k in range(adr, adr + num)]
        if all(k == int(WrapType.JOINT) for k in kinds):
            for k in range(adr, adr + num):
                j = wrap_objid[k]
                fixed.append((t, k, jnt_qposadr[j], jnt_dofadr[j]))
            continue
        path = []
        for k in range(adr, adr + num):
            kind = wrap_type[k]
            if kind == SITE:
                path.append(("site", wrap_objid[k]))
            elif kind in (SPHERE, CYL):
                path.append(("geom", wrap_objid[k], wrap_sidesite[k], kind == SPHERE))
            elif kind == int(WrapType.PULLEY):
                path.append(("pulley", wrap_divisor[k]))
            else:
                raise ValueError(f"tendon {t}: cannot mix joint wraps with a spatial path")
        if not path or path[0][0] != "site" or path[-1][0] != "site":
            raise ValueError(f"spatial tendon {t} must start and end at sites")
        for i, op in enumerate(path):
            if op[0] == "geom" and (path[i - 1][0] != "site" or i + 1 >= len(path)
                                    or path[i + 1][0] != "site"):
                raise ValueError(f"spatial tendon {t}: wrap geoms must be bracketed "
                                 f"by sites")
        spatial.append(t)

        def add_seg(a, ab, b, bb, div):
            for key, v in zip(seg, (a, b, ab, bb, t, div)):
                seg[key].append(v)
        i, prev, div = 0, None, 1.0
        while i < len(path):
            op = path[i]
            if op[0] == "pulley":
                div, prev = op[1], None
                i += 1
            elif op[0] == "site":
                if prev is not None:
                    add_seg(prev, site_bodyid[prev], op[1], site_bodyid[op[1]], div)
                prev = op[1]
                i += 1
            else:
                _, gid, side, sphere = op
                nxt = path[i + 1][1]
                w = len(wrap["ten"])
                for key, v in zip(wrap, (t, gid, side, sphere, prev, nxt, div)):
                    wrap[key].append(v)
                gb = geom_bodyid[gid]
                # t0 and t1 of wrap w sit at nsite + w and at nsite + nwrap + w;
                # t1's index is fixed below, once nwrap is known
                add_seg(prev, site_bodyid[prev], nsite + w, gb, div)
                add_seg(-1 - w, gb, nxt, site_bodyid[nxt], div)
                prev = nxt
                i += 2
    nw = len(wrap["ten"])
    seg["a"] = [a if a >= 0 else nsite + nw + (-1 - a) for a in seg["a"]]
    wrap = {k: np.asarray(v, dtype=np.float64 if k == "div" else
                          (bool if k == "sphere" else np.int64)) for k, v in wrap.items()}
    seg = {k: np.asarray(v, dtype=np.float64 if k == "div" else np.int64)
           for k, v in seg.items()}
    return np.asarray(fixed, dtype=np.int64).reshape(-1, 4), wrap, seg, tuple(spatial)


def tendon_meta(m: Model):
    return _tendon_meta(m.tendon_adr, m.tendon_num, m.wrap_type, m.wrap_objid,
                        m.wrap_sidesite, m.wrap_divisor, m.jnt_qposadr, m.jnt_dofadr,
                        m.site_bodyid, m.geom_bodyid, m.nsite)


def check_tendons(m: Model) -> None:
    """Raise ValueError for a spatial tendon whose path is malformed
    (_tendon_meta)."""
    tendon_meta(m)


def site_frames(m: Model, kin: Kinematics):
    """Every site's world position (B, nsite, 3) and frame (B, nsite, 3, 3)."""
    sb = mmath.static_tensor(m.site_bodyid, kin.xpos.device, torch.int64)
    return (kin.xpos[:, sb] + torch.einsum("bsij,sj->bsi", kin.xmat[:, sb], m.site_pos),
            kin.xmat[:, sb] @ mmath.quat_to_mat(m.site_quat))


def _point_jac(m: Model, subtree_com, cdof, point, body):
    """Translational Jacobians (B, K, nv, 3) of world points (B, K, 3) on
    static bodies (K,) (mj_jac)."""
    dev = point.device
    mask = mmath.static_tensor(body_dof_mask(m)[:, body].T, dev, point.dtype)   # (K, nv)
    root = mmath.static_tensor(np.asarray(m.body_rootid, dtype=np.int64)[body], dev)
    off = point - subtree_com[:, root]
    c = cdof[:, None]                                                          # (B, 1, nv, 6)
    return (c[..., 3:] + mmath.cross(c[..., :3], off[:, :, None])) * mask[None, :, :, None]


def tendons(m: Model, qpos, site_xpos, geom_xpos, geom_xmat, subtree_com, cdof):
    """Lengths (B, ntendon) and Jacobians ten_J (B, ntendon, nv) of every
    tendon (mj_tendon). Fixed tendons: sum coef qpos and the coefs at the
    entries' dofs. Spatial tendons: every wrap of every env in one
    wrap.wrap_geom call, then one pass over all straight segments, each
    adding its length and u . (J(b) - J(a)) (u the unit segment, J the
    endpoints' point Jacobians) divided by its branch's pulley divisor; a
    wrap adds its arc, whose endpoints ride the wrap body and add nothing
    to ten_J between them."""
    from mujoco_ros_pkgs_tpu_torch.ops import wrap as wrap_mod

    B, dev, dtype = qpos.shape[0], qpos.device, qpos.dtype
    fixed, wrap, seg, spatial = tendon_meta(m)

    def t(a):
        return mmath.static_tensor(a, dev)
    length = qpos.new_zeros(B, m.ntendon)
    ten_J = qpos.new_zeros(B, m.ntendon, m.nv)
    if len(fixed):
        ten, widx, qa, va = (t(c) for c in fixed.T)
        coef = m.wrap_prm[widx].to(dtype)
        length = length.index_add(1, ten, coef * qpos[:, qa])
        ten_J = ten_J.view(B, -1).index_add(1, ten * m.nv + va, coef.expand(B, -1)).view(
            B, m.ntendon, m.nv)
    if not spatial:
        return length, ten_J
    pts = [site_xpos]
    if len(wrap["ten"]):
        gid = t(wrap["geom"])
        side = site_xpos[:, t(np.maximum(wrap["side"], 0))]
        t0, t1, arc, _ = wrap_mod.wrap_geom(
            site_xpos[:, t(wrap["prev"])], site_xpos[:, t(wrap["next"])],
            geom_xpos[:, gid], geom_xmat[:, gid], m.geom_size[gid, 0].to(dtype),
            t(wrap["sphere"]), side, t(wrap["side"] >= 0))
        pts += [t0, t1]
        length = length.index_add(1, t(wrap["ten"]), arc / t(wrap["div"]).to(dtype))
    pts = torch.cat(pts, 1)
    pa, pb = pts[:, t(seg["a"])], pts[:, t(seg["b"])]
    diff = pb - pa
    dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=mmath.MINVAL ** 2))
    u = diff / dist[..., None]
    div = t(seg["div"]).to(dtype)
    ja = _point_jac(m, subtree_com, cdof, pa, seg["abody"])
    jb = _point_jac(m, subtree_com, cdof, pb, seg["bbody"])
    rows = torch.einsum("bkvi,bki->bkv", jb - ja, u) / div[:, None]
    ten = t(seg["ten"])
    return length.index_add(1, ten, dist / div), ten_J.index_add(1, ten, rows)


def tendon(m: Model, d: Data) -> Data:
    """mj_tendon: ten_length, ten_J and ten_velocity = ten_J qvel."""
    if m.ntendon == 0:
        return d
    length, ten_J = tendons(m, d.qpos, d.site_xpos, d.geom_xpos, d.geom_xmat,
                            d.subtree_com, d.cdof)
    return d.replace(ten_length=length, ten_J=ten_J,
                     ten_velocity=torch.einsum("btv,bv->bt", ten_J, d.qvel))


@functools.lru_cache(maxsize=128)
def _trn_meta(actuator_trntype, actuator_trnid, jnt_type, jnt_qposadr, jnt_dofadr):
    """The JAX package's static actuator groups: 'jnt1' (actuator, qpos
    address, dof address) of hinge and slide transmissions, 'jntb' and
    'jntf' (actuator, dof address) of ball and free joints, 'ten'
    (actuator, tendon), 'site' (actuator, site); other transmissions
    raise."""
    groups = {"jnt1": [], "jntb": [], "jntf": [], "ten": [], "site": []}
    for i, trn in enumerate(actuator_trntype):
        tid = actuator_trnid[i][0]
        if trn in (int(TrnType.JOINT), int(TrnType.JOINTINPARENT)):
            jt = jnt_type[tid]
            if jt in (int(JointType.SLIDE), int(JointType.HINGE)):
                groups["jnt1"].append((i, jnt_qposadr[tid], jnt_dofadr[tid]))
            else:
                groups["jntb" if jt == int(JointType.BALL) else "jntf"].append(
                    (i, jnt_dofadr[tid]))
        elif trn == int(TrnType.TENDON):
            groups["ten"].append((i, tid))
        elif trn == int(TrnType.SITE):
            groups["site"].append((i, tid))
        else:
            raise NotImplementedError(f"transmission: {TrnType(trn).name.lower()} "
                                      f"transmission is not ported to the torch package")
    return {k: np.asarray(v, dtype=np.int64).reshape(-1, 3 if k == "jnt1" else 2)
            for k, v in groups.items()}


def transmission(m: Model, d: Data) -> Data:
    """actuator_length, actuator_moment (B, nu, nv) and actuator_velocity
    = moment qvel (mj_transmission): a hinge or slide's gear qpos and gear
    at its dof; a ball or free joint's gear at its 3 or 6 dofs (length 0);
    a tendon's gear length and gear ten_J; a site's wrench gear (in the
    site's frame) through the site's Jacobian (length 0)."""
    if m.nu == 0:
        return d
    g = _trn_meta(m.actuator_trntype, m.actuator_trnid, m.jnt_type, m.jnt_qposadr,
                  m.jnt_dofadr)
    dev, B = d.qpos.device, d.qpos.shape[0]
    gear = m.actuator_gear
    length = d.qpos.new_zeros(B, m.nu)
    moment = d.qpos.new_zeros(B, m.nu, m.nv)

    def t(a):
        return mmath.static_tensor(a, dev)
    if len(g["jnt1"]):
        i, qa, va = (t(c) for c in g["jnt1"].T)
        length[:, i] = d.qpos[:, qa] * gear[i, 0]
        moment[:, i, va] = gear[i, 0]
    for key, w in (("jntb", 3), ("jntf", 6)):
        if len(g[key]):
            i, va = g[key].T
            moment[:, t(i)[:, None], t(va[:, None] + np.arange(w))] = gear[t(i), :w]
    if len(g["ten"]):
        i, tid = (t(c) for c in g["ten"].T)
        length[:, i] = d.ten_length[:, tid] * gear[i, 0]
        moment[:, i] = d.ten_J[:, tid] * gear[i, 0][:, None]
    if len(g["site"]):
        i, sid = g["site"].T
        sb = np.asarray(m.site_bodyid, dtype=np.int64)[sid]
        mask = mmath.static_tensor(body_dof_mask(m)[:, sb].T, dev, d.qpos.dtype)
        offset = d.site_xpos[:, t(sid)] - d.subtree_com[
            :, t(np.asarray(m.body_rootid, dtype=np.int64)[sb])]
        cdof = d.cdof[:, None]                                   # (B, 1, nv, 6)
        jacp = (cdof[..., 3:] + mmath.cross(cdof[..., :3], offset[:, :, None])) \
            * mask[None, :, :, None]
        jacr = cdof[..., :3] * mask[None, :, :, None]
        xmat = d.site_xmat[:, t(sid)]
        wf = torch.einsum("bwij,wj->bwi", xmat, gear[t(i), :3])
        wt = torch.einsum("bwij,wj->bwi", xmat, gear[t(i), 3:])
        moment[:, t(i)] = (torch.einsum("bwvi,bwi->bwv", jacp, wf)
                           + torch.einsum("bwvi,bwi->bwv", jacr, wt))
    return d.replace(actuator_length=length, actuator_moment=moment,
                     actuator_velocity=torch.einsum("buv,bv->bu", moment, d.qvel))


def check_actuators(m: Model) -> None:
    """Raise NotImplementedError for actuators `transmission` cannot run:
    transmissions other than joints, tendons and sites."""
    _trn_meta(m.actuator_trntype, m.actuator_trnid, m.jnt_type, m.jnt_qposadr,
              m.jnt_dofadr)


@functools.lru_cache(maxsize=128)
def _act_clamp_meta(jnt_actfrclimited, jnt_dofadr):
    """The dofs whose total actuator force is clamped (the first dof of each
    joint with actuatorfrclimited, as mj_fwdActuation clamps per joint) and
    their joints."""
    dofs = [jnt_dofadr[j] for j, lim in enumerate(jnt_actfrclimited) if lim]
    jnts = [j for j, lim in enumerate(jnt_actfrclimited) if lim]
    return np.asarray(dofs, dtype=np.int64), np.asarray(jnts, dtype=np.int64)


def actuation(m: Model, d: Data) -> Data:
    """Actuator forces (mj_fwdActuation): ctrl clamped to ctrlrange where
    ctrllimited (unless CLAMPCTRL is disabled); each activation's act_dot
    (integrator: ctrl, filter and filterexact: (ctrl - act) / dynprm[0],
    muscle: ops/muscle.dynamics), the actuator's input its activation
    where it has one, else ctrl; force = gain input + bias, gain fixed
    (gainprm[0]), affine (gainprm[0] + gainprm[1] length + gainprm[2]
    velocity) or muscle (ops/muscle.gain), bias none, affine (biasprm
    likewise) or muscle (ops/muscle.bias), clamped to forcerange where
    forcelimited; qfrc_actuator = moment^T force clamped to
    actuatorfrcrange at joints that limit it; zeros under
    DisableBit.ACTUATION. What check_actuators refuses raises."""
    if m.nu == 0:
        return d
    check_actuators(m)
    flags = m.opt.disableflags
    if flags & DisableBit.ACTUATION:
        return d.replace(qfrc_actuator=torch.zeros_like(d.qvel),
                         actuator_force=torch.zeros_like(d.ctrl),
                         act_dot=torch.zeros_like(d.act))
    dev = d.qpos.device

    def mask(values):
        return mmath.static_tensor(np.asarray(values), dev)
    ctrl = d.ctrl
    if not flags & DisableBit.CLAMPCTRL and any(m.actuator_ctrllimited):
        rng = m.actuator_ctrlrange
        ctrl = torch.where(mask(np.array(m.actuator_ctrllimited, dtype=bool)),
                           torch.clamp(ctrl, rng[:, 0], rng[:, 1]), ctrl)
    inp, act_dot = ctrl, d.act_dot
    if m.na:
        dyn = np.asarray(m.actuator_dyntype)
        adr = np.asarray(m.actuator_actadr)
        has = adr >= 0
        a_g = d.act[:, mask(np.where(has, adr, 0))]
        inp = torch.where(mask(has), a_g, ctrl)
        ad = torch.where(mask(dyn == int(DynType.INTEGRATOR)), ctrl,
                         (ctrl - a_g) / torch.clamp(m.actuator_dynprm[:, 0], min=mmath.MINVAL))
        if (dyn == int(DynType.MUSCLE)).any():
            ad = torch.where(mask(dyn == int(DynType.MUSCLE)),
                             muscle.dynamics(ctrl, a_g, m.actuator_dynprm), ad)
        act_dot = torch.zeros_like(d.act)
        act_dot[:, mask(adr[has])] = ad[:, mask(np.nonzero(has)[0])]
    L, V = d.actuator_length, d.actuator_velocity
    gp, bp = m.actuator_gainprm, m.actuator_biasprm
    gain = gp[:, 0]
    if any(t == int(GainType.AFFINE) for t in m.actuator_gaintype):
        gain = torch.where(mask(np.array(m.actuator_gaintype) == int(GainType.FIXED)),
                           gp[:, 0], gp[:, 0] + gp[:, 1] * L + gp[:, 2] * V)
    gaintype, biastype = np.array(m.actuator_gaintype), np.array(m.actuator_biastype)
    if (gaintype == int(GainType.MUSCLE)).any():
        gain = torch.where(mask(gaintype == int(GainType.MUSCLE)),
                           muscle.gain(L, V, m.actuator_lengthrange, m.actuator_acc0, gp), gain)
    force = gain * inp
    if (biastype == int(BiasType.AFFINE)).any():
        force = force + torch.where(mask(biastype == int(BiasType.AFFINE)),
                                    bp[:, 0] + bp[:, 1] * L + bp[:, 2] * V, 0.0)
    if (biastype == int(BiasType.MUSCLE)).any():
        force = force + torch.where(mask(biastype == int(BiasType.MUSCLE)),
                                    muscle.bias(L, m.actuator_lengthrange, m.actuator_acc0, bp),
                                    0.0)
    if any(m.actuator_forcelimited):
        rng = m.actuator_forcerange
        force = torch.where(mask(np.array(m.actuator_forcelimited, dtype=bool)),
                            torch.clamp(force, rng[:, 0], rng[:, 1]), force)
    qfrc = torch.einsum("buv,bu->bv", d.actuator_moment, force)
    dofs, jnts = _act_clamp_meta(m.jnt_actfrclimited, m.jnt_dofadr)
    if dofs.size:
        dofs, jnts = mmath.static_tensor(dofs, dev), mmath.static_tensor(jnts, dev)
        rng = m.jnt_actfrcrange[jnts]
        qfrc[:, dofs] = torch.clamp(qfrc[:, dofs], rng[:, 0], rng[:, 1])
    return d.replace(actuator_force=force, qfrc_actuator=qfrc, act_dot=act_dot)


def solve_m(m: Model, d: Data, x: torch.Tensor) -> torch.Tensor:
    """M^-1 x (mj_solveM): the K1 kernel up to nv = 96, the library
    Cholesky above (ops/linalg_tpu.solve)."""
    return linalg_tpu.solve(d.qM, x)


def mul_m(m: Model, d: Data, x: torch.Tensor) -> torch.Tensor:
    return (d.qM @ x[..., None])[..., 0]


# ---------------------------------------------------------------------------
# pipeline stages
# ---------------------------------------------------------------------------

def fwd_position_smooth(m: Model, d: Data) -> Data:
    kin = kinematics(m, d.qpos, d.mocap_pos, d.mocap_quat)
    subtree_com, cinert, cdof = com_pos(m, kin)
    d = d.replace(qpos=kin.qpos, xpos=kin.xpos, xquat=kin.xquat, xmat=kin.xmat,
                  xipos=kin.xipos, ximat=kin.ximat, xanchor=kin.xanchor,
                  xaxis=kin.xaxis, geom_xpos=kin.geom_xpos,
                  geom_xmat=kin.geom_xmat, subtree_com=subtree_com,
                  cinert=cinert, cdof=cdof, qM=crb(m, cinert, cdof))
    if m.nsite:
        site_xpos, site_xmat = site_frames(m, kin)
        d = d.replace(site_xpos=site_xpos, site_xmat=site_xmat)
    return transmission(m, tendon(m, d))


def fwd_velocity_smooth(m: Model, d: Data) -> Data:
    return rne(m, passive(m, com_vel(m, d)))


def fwd_acceleration_smooth(m: Model, d: Data) -> Data:
    qfrc_smooth = (d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator
                   + d.qfrc_applied + xfrc_accumulate(m, d))
    return d.replace(qfrc_smooth=qfrc_smooth,
                     qacc_smooth=solve_m(m, d, qfrc_smooth))
