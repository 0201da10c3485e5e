"""Constraint rows of joint limits and contacts, with the solref/solimp
impedance model.

Counterpart of mujoco_ros_pkgs_tpu/ops/efc.py for limit and contact rows:
one row per limited hinge or slide joint (on the nearer side of its range),
then elliptic cones of condim 1/3/4/6 and pyramidal facets, every slot of
the contact set a row block (inactive rows masked), in libmujoco's row
order so the rows compare 1:1 with the JAX package's. All tensors are
batch-first; the row layout is static and shared by the batch.

Equality and friction-loss rows, and limits of ball joints, raise
NotImplementedError (ROADMAP A5).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core.types import Data, DisableBit, JointType, Model
from mujoco_ros_pkgs_tpu_torch.ops import math as mmath
from mujoco_ros_pkgs_tpu_torch.ops import smooth, solver
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
    kinds: Tuple[str, ...]       # 'lim' per limit row and facet, 'con' per elliptic row
    con_base: Tuple[int, ...]    # first row of each elliptic contact
    con_dim: Tuple[int, ...]     # its condim
    con_mu: torch.Tensor         # (B, ncon_ell, 5) friction of each
    con_active: torch.Tensor     # (B, ncon_ell)


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

def _check_rows(m: Model):
    flags = m.opt.disableflags
    if flags & DisableBit.CONSTRAINT:
        return
    if m.neq and not flags & DisableBit.EQUALITY:
        raise NotImplementedError("efc: equality rows are not ported to the "
                                  "torch package")
    if len(m.dof_floss_adr) and not flags & DisableBit.FRICTIONLOSS:
        raise NotImplementedError("efc: friction-loss rows are not ported to the "
                                  "torch package")
    if not flags & DisableBit.LIMIT:
        for j, lim in enumerate(m.jnt_limited):
            if lim and m.jnt_type[j] not in (int(JointType.HINGE), int(JointType.SLIDE)):
                raise NotImplementedError(
                    f"efc: limit rows of {JointType(m.jnt_type[j]).name.lower()} joints "
                    f"(joint '{m.jnt_names[j]}') are not ported to the torch package")


def _limited(m: Model) -> Tuple[int, ...]:
    """The joints with a limit row, in joint order (none when limits or
    constraints are disabled)."""
    if m.opt.disableflags & (DisableBit.CONSTRAINT | DisableBit.LIMIT):
        return ()
    return tuple(j for j, lim in enumerate(m.jnt_limited) if lim)


def _limit_rows(m: Model, d: Data, jnts) -> dict:
    """One row per limited hinge or slide joint, on the nearer side of its
    range: pos = qpos - range[0] (J = +1 at the dof) or range[1] - qpos (J =
    -1), active where pos < margin, the joint's solref / solimp and the
    dof's invweight0."""
    dev, nv = d.qpos.device, m.nv
    jt = mmath.static_tensor(jnts, dev)
    qa = mmath.static_tensor([m.jnt_qposadr[j] for j in jnts], dev)
    va = mmath.static_tensor([m.jnt_dofadr[j] for j in jnts], dev)
    q = d.qpos[:, qa]
    rng, margin = m.jnt_range[jt], m.jnt_margin[jt]
    dist_lo, dist_hi = q - rng[:, 0], rng[:, 1] - q
    lo_closer = dist_lo < dist_hi
    dist = torch.where(lo_closer, dist_lo, dist_hi)
    sgn = torch.where(lo_closer, 1.0, -1.0).to(q.dtype)
    B, L = q.shape
    J = q.new_zeros(B, L, nv)
    J[:, mmath.static_tensor(np.arange(L), dev), va] = sgn
    k, b, imp = _kbi(m, m.jnt_solref[jt], m.jnt_solimp[jt], dist, margin)
    R = torch.clamp((1.0 - imp) / imp * m.dof_invweight0[va], min=mmath.MINVAL)
    return dict(J=J, pos=dist, margin=margin.expand(B, L), D=1.0 / R, R=R,
                aref=-b * (sgn * d.qvel[:, va]) - k * imp * (dist - margin),
                frictionloss=torch.zeros_like(dist), active=dist < margin)


def make_efc(m: Model, d: Data) -> Optional[Efc]:
    """The limit rows, then the contact rows of every slot of d.contact
    (None without rows)."""
    _check_rows(m)
    if m.opt.disableflags & DisableBit.CONSTRAINT:
        return None
    jnts = _limited(m)
    nlim = len(jnts)
    c = d.contact
    B, dtype, dev, nv = d.qpos.shape[0], d.qpos.dtype, d.qpos.device, m.nv
    pyramidal = m.opt.cone == 0
    slots = []
    if m.ncon_max and not m.opt.disableflags & DisableBit.CONTACT:
        slots = [i for i in range(len(c.geom1)) if c.geom1[i] != -1]
    if not slots and not nlim:
        return None

    def nrows(dim):
        return 2 * (dim - 1) if (pyramidal and dim > 1) else dim
    bases, rb = [], nlim
    for i in slots:
        bases.append(rb)
        rb += nrows(c.dim[i])
    nefc = rb
    ell = [k for k, i in enumerate(slots) if not (pyramidal and c.dim[i] > 1)]
    sel = mmath.static_tensor([slots[k] for k in ell], dev, torch.int64)
    con_base = tuple(bases[k] for k in ell)
    con_dim = tuple(int(c.dim[slots[k]]) for k in ell)
    con_mu = c.friction[:, sel]
    con_act = c.dist[:, sel] < c.includemargin[:, sel]

    bdmask = smooth.body_dof_mask(m)                    # (nv, nbody)
    rootid = np.asarray(m.body_rootid, dtype=np.int64)
    gb = np.asarray(m.geom_bodyid, dtype=np.int64)
    qvel = d.qvel
    out = {name: torch.zeros(B, nefc, dtype=dtype, device=dev)
           for name in ("pos", "margin", "D", "R", "aref", "frictionloss")}
    J = torch.zeros(B, nefc, nv, dtype=dtype, device=dev)
    active = torch.zeros(B, nefc, dtype=torch.bool, device=dev)
    kinds = ["lim"] * nlim + [None] * (nefc - nlim)
    if nlim:
        lim = _limit_rows(m, d, jnts)
        J[:, :nlim] = lim.pop("J")
        active[:, :nlim] = lim.pop("active")
        for name, val in lim.items():
            out[name][:, :nlim] = val

    by_dim: dict = {}
    for k, i in enumerate(slots):
        by_dim.setdefault(int(c.dim[i]), []).append((k, i))
    for dim, items in sorted(by_dim.items()):
        idx = mmath.static_tensor([i for _, i in items], dev)
        nc = len(items)
        b1 = gb[np.array([c.geom1[i] for _, i in items])]
        b2 = gb[np.array([c.geom2[i] for _, i in items])]
        pos = c.pos[:, idx]                                # (B, nc, 3)
        frame = c.frame[:, idx]                            # (B, nc, 3, 3)
        dist = c.dist[:, idx]
        incm = c.includemargin[:, idx]
        fric = c.friction[:, idx]                          # (B, nc, 5)
        act = dist < incm
        iw0 = m.body_invweight0[:, 0]
        invw = (iw0[mmath.static_tensor(b1, dev)]
                + iw0[mmath.static_tensor(b2, dev)]).to(dtype)

        # translational row along axis a at point p: a . cdof_lin + cdof_ang .
        # (off x a), a dot of cdof with [off x a, a], masked by the body chain
        def trans_rows(bs, axes):
            mask = mmath.static_tensor(bdmask[:, bs].T, dev, dtype)
            off = pos - d.subtree_com[:, mmath.static_tensor(rootid[bs], dev)]
            A = torch.cat([mmath.cross(off[:, :, None, :], axes), axes], -1)
            return torch.einsum("bctk,bvk->bctv", A, d.cdof) * mask[None, :, None, :]

        axes_t = frame[:, :, :1] if dim == 1 else frame[:, :, :3]
        Jt_all = trans_rows(b2, axes_t) - trans_rows(b1, axes_t)
        Jn = Jt_all[:, :, 0]                               # (B, nc, nv)
        Jf_list = []
        if dim > 1:
            Jf_list.append(Jt_all[:, :, 1:3])
        if dim > 3:
            mask_d = mmath.static_tensor(bdmask[:, b2].T.astype(np.float64)
                                         - bdmask[:, b1].T, dev, dtype)
            Pr = torch.einsum("bcrk,bvk->bcrv", frame[:, :, :dim - 3], d.cdof[..., :3])
            Jf_list.append(Pr * mask_d[None, :, None, :])
        Jf = (torch.cat(Jf_list, 2) if Jf_list
              else torch.zeros(B, nc, 0, nv, dtype=dtype, device=dev))

        k_, b_, imp_ = _kbi(m, c.solref[:, idx], c.solimp[:, idx], dist, incm)
        rbase = (1.0 - imp_) / imp_
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
            kind = "lim"
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
            else:
                Jblk, R, aref = Jn[:, :, None], Rn[..., None], aref_n[..., None]
                posb, mrgb = dist[..., None], incm[..., None]
            kind = "con"
        dest_np = np.concatenate([np.arange(bases[k], bases[k] + nr) for k, _ in items])
        dest = mmath.static_tensor(dest_np, dev)
        J[:, dest] = Jblk.reshape(B, nc * nr, nv)
        for name, val in (("pos", posb), ("margin", mrgb), ("R", R),
                          ("D", 1.0 / R), ("aref", aref)):
            out[name][:, dest] = val.reshape(B, nc * nr)
        active[:, dest] = act[..., None].expand(B, nc, nr).reshape(B, nc * nr)
        for r in dest_np:
            kinds[r] = kind
    return Efc(J=J, active=active, kinds=tuple(kinds), con_base=con_base,
               con_dim=con_dim, con_mu=con_mu, con_active=con_act, **out)


def row_layout(m: Model) -> dict:
    """Static efc row layout (no Data needed) in assembly order: friction
    loss, joint limits, then the first row of each contact slot, and the
    total row count. (The port compiles no equality constraints.)"""
    flags = m.opt.disableflags
    nrow = 0
    if not flags & (DisableBit.CONSTRAINT | DisableBit.FRICTIONLOSS):
        nrow += len(m.dof_floss_adr)
    if not flags & (DisableBit.CONSTRAINT | DisableBit.LIMIT):
        nrow += sum(1 for lim in m.jnt_limited if lim)
    con_bases, con_nrows = [], []
    if m.ncon_max and not flags & (DisableBit.CONSTRAINT | DisableBit.CONTACT):
        pyramidal = m.opt.cone == 0
        for dim in slot_meta(m)[2]:
            nr = 2 * (dim - 1) if (pyramidal and dim > 1) else dim
            con_bases.append(nrow)
            con_nrows.append(nr)
            nrow += nr
    return dict(con=con_bases, con_nrows=con_nrows,
                pyramidal=(m.opt.cone == 0), nrow=nrow)


def fwd_constraint(m: Model, d: Data) -> Data:
    efc = make_efc(m, d)
    if efc is None:
        return d.replace(qacc=d.qacc_smooth,
                         qfrc_constraint=torch.zeros_like(d.qacc_smooth))
    return solver.solve(m, d, efc)
