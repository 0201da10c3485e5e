"""Derived model constants needing dynamics at qpos0 (mj_setConst analogue).

Counterpart of mujoco_ros_pkgs_tpu/core/constants.py: dof_invweight0,
body_invweight0, the tendons' length0 and invweight0 (ten_J M^-1 ten_J^T)
and the actuators' acc0 (|M^-1 moment|) from the port's own position stage
at qpos0, in the model's (float64, load-time) precision.
"""

from __future__ import annotations

import dataclasses

import torch

from mujoco_ros_pkgs_tpu_torch.core.types import JointType, Model


def set_constants(m: Model) -> Model:
    from mujoco_ros_pkgs_tpu_torch.ops import math as mmath
    from mujoco_ros_pkgs_tpu_torch.ops import smooth

    if m.nv == 0:
        return m
    kin = smooth.kinematics(m, m.qpos0[None])
    subtree_com, cinert, cdof = smooth.com_pos(m, kin)
    qM = smooth.crb(m, cinert, cdof)[0]
    cdof, xipos, subtree_com = cdof[0], kin.xipos[0], subtree_com[0]

    # inv_ex: a singular qM (a massless body) gives no error here, as in the
    # JAX package, so that the compile can name what is wrong
    Minv = torch.linalg.inv_ex(qM)[0]
    dof_invweight0 = torch.diagonal(Minv).clone()
    # libmujoco averages invweight0 within ball / free-joint dof groups
    for j in range(m.njnt):
        adr = m.jnt_dofadr[j]
        if m.jnt_type[j] == int(JointType.BALL):
            dof_invweight0[adr:adr + 3] = dof_invweight0[adr:adr + 3].mean()
        elif m.jnt_type[j] == int(JointType.FREE):
            dof_invweight0[adr:adr + 3] = dof_invweight0[adr:adr + 3].mean()
            dof_invweight0[adr + 3:adr + 6] = dof_invweight0[adr + 3:adr + 6].mean()

    # body_invweight0: mean diagonal of J M^-1 J^T for the body-com jacobian
    bmask = torch.as_tensor(smooth.body_dof_mask(m), dtype=qM.dtype)
    ref = subtree_com[torch.as_tensor(m.body_rootid, dtype=torch.int64)]
    inv = []
    for b in range(m.nbody):
        mask = bmask[:, b:b + 1]
        offset = xipos[b] - ref[b]
        jacp = (cdof[:, 3:] + mmath.cross(cdof[:, :3], offset[None, :])) * mask
        jacr = cdof[:, :3] * mask
        inv.append(torch.stack([torch.trace(jacp.T @ Minv @ jacp) / 3.0,
                                torch.trace(jacr.T @ Minv @ jacr) / 3.0]))
    updates = dict(dof_invweight0=dof_invweight0, body_invweight0=torch.stack(inv))
    if m.ntendon or m.nu:
        from mujoco_ros_pkgs_tpu_torch.ops import forward
        d = smooth.fwd_position_smooth(m, forward.make_data(m, 1))
    if m.ntendon:
        ten_J = d.ten_J[0]
        updates.update(tendon_length0=d.ten_length[0], tendon_invweight0=torch.einsum(
            "ti,ij,tj->t", ten_J, Minv, ten_J))
    if m.nu:
        # |M^-1 moment| of each actuator: a muscle's peak force is scale / acc0
        # where its force parameter is negative
        updates.update(actuator_acc0=torch.linalg.vector_norm(
            d.actuator_moment[0] @ Minv, dim=1))
    return dataclasses.replace(m, **updates)
