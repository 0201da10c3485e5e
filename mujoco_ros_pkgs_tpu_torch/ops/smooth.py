"""Smooth dynamics subset: kinematics, com_pos and crb, as level-order batch ops.

Counterpart of mujoco_ros_pkgs_tpu/ops/smooth.py (`kinematics`, `com_pos`,
`crb`). Tree recursions are level-order sweeps: bodies grouped by tree depth
(static), each level one gather/compute/scatter over all its bodies. All
tensors are batch-first; the port uses these at model load time
(core/constants.py), where the fused step does not reach.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core.types import JointType, Model
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

def kinematics(m: Model, qpos: torch.Tensor) -> Kinematics:
    """Forward kinematics of a batch (B, nq); renormalizes quaternions in
    qpos as MuJoCo does. One vectorized pass per tree depth: all four joint
    types are computed and mask-selected."""
    B, dtype, dev = qpos.shape[0], qpos.dtype, qpos.device
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
        par = torch.as_tensor(lv.par, device=dev)
        ids = torch.as_tensor(lv.ids, device=dev)
        pq, pp = xquat[:, par], xpos[:, par]
        quat = mmath.quat_mul(pq, m.body_quat[ids])
        pos = pp + mmath.rot_vec_quat(m.body_pos[ids], pq)

        for jid_np, jmask_np, jt in lv.joints:
            qa = qposadr[jid_np]
            qi = torch.as_tensor(np.minimum(qa[:, None] + np.arange(7), top),
                                 device=dev)
            qblk = qpos[:, qi]                                  # (B, W, 7)
            jid = torch.as_tensor(jid_np, device=dev)
            jp, ja = m.jnt_pos[jid], m.jnt_axis[jid]
            dq = qblk[..., 0] - m.qpos0[torch.as_tensor(np.minimum(qa, top),
                                                        device=dev)]

            anchor_c = pos + mmath.rot_vec_quat(jp, quat)
            axis_c = mmath.rot_vec_quat(ja, quat)

            def flag(t):
                return torch.as_tensor(jt == t, device=dev)[:, None]
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

            jmask = torch.as_tensor(jmask_np, device=dev)
            quat = torch.where(jmask[:, None], new_quat, quat)
            pos = torch.where(jmask[:, None], new_pos, pos)
            lanes = np.nonzero(jmask_np)[0]
            xanchor[:, jid_np[lanes]] = anch[:, lanes]
            xaxis[:, jid_np[lanes]] = axv[:, lanes]
            # renormalized quaternions go back into qpos (free at +3, ball at +0)
            for w in lanes:
                if jt[w] == FREE:
                    qpos_out[:, qa[w] + 3:qa[w] + 7] = quat_f[:, w]
                elif jt[w] == BALL:
                    qpos_out[:, qa[w]:qa[w] + 4] = qloc_b[:, w]

        xquat[:, ids] = mmath.normalize(quat)
        xpos[:, ids] = pos

    xmat = mmath.quat_to_mat(xquat)
    xipos = xpos + mmath.rot_vec_quat(m.body_ipos, xquat)
    ximat = xmat @ mmath.quat_to_mat(m.body_iquat)
    gb = torch.as_tensor(m.geom_bodyid, dtype=torch.int64, device=dev)
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
        wsum = wsum.index_add(1, torch.as_tensor(lv.par, device=dev),
                              wsum[:, torch.as_tensor(lv.ids, device=dev)])
    subtree_com = wsum / torch.clamp(m.body_subtreemass, min=mmath.MINVAL)[:, None]
    if not m.body_subtreemass[0] > mmath.MINVAL:
        subtree_com[:, 0] = 0.0

    rootid = torch.as_tensor(m.body_rootid, dtype=torch.int64, device=dev)
    ref = subtree_com[:, rootid]
    I_world = (kin.ximat * m.body_inertia[:, None, :]) @ kin.ximat.transpose(-1, -2)
    cinert = mmath.inert_from_mass_com_fullinertia(
        m.body_mass.expand(kin.xipos.shape[:-1]), I_world, kin.xipos - ref)

    kind, onehot = _dof_meta(m.jnt_type, m.jnt_dofadr, m.dof_jntid)
    db = torch.as_tensor(m.dof_bodyid, dtype=torch.int64, device=dev)
    dj = torch.as_tensor(m.dof_jntid, dtype=torch.int64, device=dev)
    oh = torch.as_tensor(onehot, dtype=kin.xpos.dtype, device=dev)
    offset = ref[:, db] - kin.xanchor[:, dj]
    rot_axis = torch.einsum("bvij,vj->bvi", kin.xmat[:, db], oh)
    jaxis = kin.xaxis[:, dj]
    k = torch.as_tensor(kind, device=dev)[:, None]
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
            1, torch.as_tensor(lv.par, device=dev),
            crb_inert[:, torch.as_tensor(lv.ids, device=dev)])
    dof_bodyid = torch.as_tensor(m.dof_bodyid, dtype=torch.int64, device=dev)
    F = mmath.inert_vec_mul(crb_inert[:, dof_bodyid], cdof)
    G = F @ cdof.transpose(-1, -2)
    amask = _dof_ancestor_mask(m.dof_parentid, m.nv)
    lower = torch.as_tensor(amask, dtype=G.dtype, device=dev)
    strict = torch.as_tensor(amask & ~np.eye(m.nv, dtype=bool), dtype=G.dtype,
                             device=dev)
    qM = G * lower + (G * strict).transpose(-1, -2)
    return qM + torch.diag(m.dof_armature)
