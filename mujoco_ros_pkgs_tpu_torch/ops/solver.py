"""Constraint solve of the general step (mj_fwdConstraint's solver).

Counterpart of mujoco_ros_pkgs_tpu/ops/solver.py's Newton solver. `solve`
dispatches as the JAX package's `solve` does for Newton:

- systems the fused solver kernel takes (nv <= 16, at most 64 rows;
  solver_tpu.supports) go through ops/solver_tpu.solve_batched (the K2
  kernel on CUDA): at most 32 Newton trips, a 7-point grid line search and
  max(2, min(ls_iterations, 24) // 3) polish steps, as
  `_solve_dispatch_tpu`;
- every other system (PILE: nv 72, 783 rows) goes through `newton`, the
  counterpart of `_solve_jnp`: opt.iterations honoured exactly, each env
  stopping at its own convergence, its Hessian solved by
  linalg_tpu.solve (the K1 kernel on CUDA up to n = 96) once per trip.
  With m.con_topk, the cone groups efc compacted are iterated at their
  size K (per-env rows, Cones) and their forces scattered back to
  the canonical rows, a dropped slot's rows at exactly 0.

CG and PGS raise NotImplementedError.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mujoco_ros_pkgs_tpu_torch.core.types import Data, DisableBit, Model, SolverType
from mujoco_ros_pkgs_tpu_torch.ops import linalg_tpu, solver_tpu
from mujoco_ros_pkgs_tpu_torch.ops import math as mmath
from mujoco_ros_pkgs_tpu_torch.ops.math import MINVAL

# the bracket grid of the line search, evaluated in one pass
_GRID = (0.0625, 0.25, 0.5, 1.0, 2.0, 4.0, 16.0)
# points of each polish pass
_POLISH_POINTS = 8
# the Newton loop asks the card whether every env has converged once every
# SYNC_EVERY trips (one host sync each), not after every trip
SYNC_EVERY = 3


def solve(m: Model, d: Data, efc) -> Data:
    """The Newton solve of efc's rows (ops/efc.Efc) from d.qacc_smooth and
    d.qacc_warmstart; sets qacc, qfrc_constraint, efc_force_contact (the
    row forces) and qacc_warmstart (the solution)."""
    if int(m.opt.solver) != int(SolverType.NEWTON):
        raise NotImplementedError("solver: only the Newton solver is ported to "
                                  "the torch package (CG and PGS are not)")
    if not solver_tpu.supports(efc, m.nv):
        return newton(m, d, efc)
    niter, nls = solver_tpu.trip_counts(m)
    x, qfrc, frows = solver_tpu.solve_batched(
        efc.kinds, tuple(zip(efc.con_base, efc.con_dim)), m.nv, niter, nls,
        m.opt.tolerance, not m.opt.disableflags & DisableBit.WARMSTART,
        efc.J, efc.aref, efc.D, efc.frictionloss, efc.active, efc.con_mu,
        d.qM, d.qacc_smooth, d.qacc_warmstart)
    return d.replace(qacc=x, qfrc_constraint=qfrc, efc_force_contact=frows,
                     qacc_warmstart=x)


# ---------------------------------------------------------------------------
# the split of the rows: simple rows and per-condim cone groups
# ---------------------------------------------------------------------------

class _Split(NamedTuple):
    """Static split of a row layout (the JAX package's _ConeGroups): the
    simple rows (equality, friction loss, one-sided) by index and kind, and
    the elliptic cones grouped by condim."""
    simple: torch.Tensor          # (ns,) row index
    eq: torch.Tensor              # (ns,) bool
    fri: torch.Tensor
    lim: torch.Tensor
    groups: Tuple[Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor], ...]
    # per cone group: (dim, contact index (C,), row index (C, dim), the
    # friction column of each tangential sigma (dim - 1,))


@functools.lru_cache(maxsize=64)
def _split(kinds, con_base, cone_groups, device) -> _Split:
    """Made once per row layout and device (the layout is static), never
    per step. Rows are coded as the JAX kernel codes them
    (solver_tpu.row_codes): a condim-1 contact's row is one-sided. The cone
    groups are efc's (`Efc.groups`)."""
    codes = np.array(solver_tpu.row_codes(kinds, con_base))
    simple = np.flatnonzero(codes != solver_tpu.ROW_CODE["con"])
    sc = codes[simple]
    groups = []
    for dim, cis in cone_groups:
        idx = np.asarray([con_base[ci][0] for ci in cis])[:, None] + np.arange(dim)
        groups.append((dim, torch.tensor(cis, device=device),
                       torch.tensor(idx, device=device),
                       torch.tensor(solver_tpu._SIGMA_COL[:dim - 1], device=device)))

    def t(a):
        return torch.tensor(a, device=device)
    return _Split(simple=t(simple), eq=t(sc == solver_tpu.ROW_CODE["eq"]),
                  fri=t(sc == solver_tpu.ROW_CODE["fri"]),
                  lim=t(sc == solver_tpu.ROW_CODE["lim"]), groups=tuple(groups))


class _Simple(NamedTuple):
    J: torch.Tensor               # (B, ns, nv)
    aref: torch.Tensor            # (B, ns)
    D: torch.Tensor
    floss: torch.Tensor
    act: torch.Tensor             # (B, ns) bool
    eq: torch.Tensor              # (ns,) bool
    fri: torch.Tensor
    lim: torch.Tensor


class Cones(NamedTuple):
    """One cone group as the Newton iterates on it: rows (B, C, dim), J (B,
    C, dim, nv); a group efc.make_efc compacted (m.con_topk) comes as one,
    its C slots each env's deepest, their row indices per env."""
    dim: int
    idx: torch.Tensor             # (C, dim) canonical row index, or (B, C, dim) per env
    J: torch.Tensor
    aref: torch.Tensor
    D: torch.Tensor
    R: torch.Tensor
    sigma: torch.Tensor           # (B, C, dim - 1)
    act: torch.Tensor             # (B, C) bool


def _views(efc) -> Tuple[_Split, _Simple, Tuple[Cones, ...]]:
    """The solve's view of efc's rows: the split, the simple rows gathered,
    each cone group gathered as (B, C, dim) blocks."""
    sp = _split(efc.kinds, tuple(zip(efc.con_base, efc.con_dim)), efc.groups,
                efc.J.device)
    s = sp.simple
    simple = _Simple(efc.J[:, s], efc.aref[:, s], efc.D[:, s], efc.frictionloss[:, s],
                     efc.active[:, s], sp.eq, sp.fri, sp.lim)
    cones = []
    for k, (dim, cis, idx, scol) in enumerate(sp.groups):
        if efc.cb[k] is not None:      # compacted (m.con_topk): rows per env
            cones.append(efc.cb[k])
            continue
        sigma = torch.clamp(efc.con_mu[:, cis][..., scol], min=MINVAL)
        cones.append(Cones(dim, idx, efc.J[:, idx], efc.aref[:, idx], efc.D[:, idx],
                            efc.R[:, idx], sigma, efc.con_active[:, cis]))
    return sp, simple, tuple(cones)


def _lift(t, like, tail):
    """t (B, ...) with singleton axes after the env axis, so that it
    broadcasts against `like` with `like`'s last `tail` axes dropped (an
    alpha axis of the line search after the env axis)."""
    extra = like.dim() - tail - t.dim()
    return t.reshape(t.shape[:1] + (1,) * extra + t.shape[1:]) if extra else t


# ---------------------------------------------------------------------------
# row forces (the JAX package's _simple_forces, _cone_forces)
# ---------------------------------------------------------------------------

def _simple_forces(sr: _Simple, jar, want_w):
    """Forces, Hessian weights and cost of the simple rows at jar (B, ...,
    ns): equality rows quadratic, friction-loss rows Huber, limit and
    condim-1 contact rows one-sided. Returns (f, w or None, cost (B, ...))."""
    if jar.shape[-1] == 0:          # no simple rows (an elliptic contact model)
        return jar, jar if want_w else None, jar.sum(-1)
    D, act, floss = (_lift(t, jar, 0) for t in (sr.D, sr.act, sr.floss))
    eq_gate = sr.eq & act
    lim_gate = sr.lim & act & (jar < 0)
    quad_gate = eq_gate | lim_gate
    f_unc = -D * jar
    clipped = torch.clamp(f_unc, -floss, floss)
    lin = torch.abs(f_unc) > floss
    fri_gate = sr.fri & act
    zero = torch.zeros_like(jar)
    f = torch.where(quad_gate, f_unc, torch.where(fri_gate, clipped, zero))
    cost_q = torch.where(quad_gate, 0.5 * D * jar * jar, zero)
    cost_f = torch.where(fri_gate,
                         torch.where(lin, floss * torch.abs(jar) - 0.5 * floss * floss
                                     / torch.clamp(D, min=MINVAL), 0.5 * D * jar * jar),
                         zero)
    cost = (cost_q + cost_f).sum(-1)
    w = torch.where(quad_gate | (fri_gate & ~lin), D, zero) if want_w else None
    return f, w, cost


class _ConeW(NamedTuple):
    """A cone group's Hessian block in rank-1 form: W = diag(wrow) +
    ru ru^T - rw rw^T per contact, each (B, C, dim)."""
    wrow: torch.Tensor
    ru: torch.Tensor
    rw: torch.Tensor


def _cone_forces(g: Cones, u, want_w):
    """Elliptic-cone forces, Hessian block and cost of one condim group at
    u (B, ..., C, dim), the groups' jar rows. Returns (f (B, ..., C, dim),
    _ConeW or None, cost (B, ...))."""
    sigma, Dvec, R = (_lift(t, u, 0) for t in (g.sigma, g.D, g.R))
    act = _lift(g.act, u, 1)
    Dn = Dvec[..., 0]
    P_n = -Dn * u[..., 0]
    P_t = -Dvec[..., 1:] * u[..., 1:]
    p_hat = P_t / sigma
    D_hat = Dvec[..., 1:] / (sigma * sigma)
    T_hat = torch.sqrt(torch.clamp((p_hat * p_hat).sum(-1), min=MINVAL ** 2))
    inside = T_hat <= P_n
    D_bar = D_hat.mean(-1)
    fn_mid = (P_n / Dn + T_hat / D_bar) / (1.0 / Dn + 1.0 / D_bar)
    polar = fn_mid <= 0.0
    zero = torch.zeros_like(P_n)
    f_n = torch.where(inside, P_n, torch.where(polar, zero, fn_mid))
    dirs = p_hat / T_hat[..., None]
    h_t = torch.where(inside[..., None], p_hat,
                      torch.where(polar[..., None], torch.zeros_like(p_hat),
                                  fn_mid[..., None] * dirs))
    f_c = torch.cat([f_n[..., None], sigma * h_t], -1)
    f_c = torch.where(act[..., None], f_c, torch.zeros_like(f_c))
    p_full = torch.cat([P_n[..., None], P_t], -1)
    c_cost = (0.5 * (Dvec * u * u).sum(-1)
              - 0.5 * (R * (p_full - f_c) ** 2).sum(-1))
    cost = torch.where(act, c_cost, zero).sum(-1)
    if not want_w:
        return f_c, None, cost
    # the rank-1 form of the dense block: W = A uu^T + btt diag([0, sigma^2])
    # - btt [0, s][0, s]^T with u = [1, s], s = sigma dir
    A = Dn * D_bar / (Dn + D_bar)
    btt = fn_mid * D_bar / T_hat
    mid_zone = act & ~inside & ~polar
    midf = mid_zone[..., None].to(u.dtype)
    sdir = sigma * dirs
    one = torch.ones_like(P_n)[..., None]
    wrow_mid = torch.cat([zero[..., None], btt[..., None] * sigma ** 2], -1)
    wrow = torch.where(mid_zone[..., None], wrow_mid,
                       torch.where((act & inside)[..., None], Dvec, torch.zeros_like(u)))
    sqA = torch.sqrt(torch.clamp(A, min=0.0))[..., None]
    sqB = torch.sqrt(torch.clamp(btt, min=0.0))[..., None]
    ru = midf * sqA * torch.cat([one, sdir], -1)
    rw = midf * sqB * torch.cat([zero[..., None], sdir], -1)
    return f_c, _ConeW(wrow, ru, rw), cost


def _rows_at(x, idx):
    """x (B, nefc) at the rows idx: (C, dim) shared, or (B, C, dim) per env."""
    if idx.dim() == 2:
        return x[:, idx]
    return torch.take_along_dim(x, idx.flatten(1), 1).view(idx.shape)


def _put_rows(out, idx, val):
    """out[:, idx] = val (B, C, dim) for rows idx shared or per env."""
    if idx.dim() == 2:
        out[:, idx] = val
    else:
        out.scatter_(1, idx.flatten(1), val.flatten(1))


def forces_and_weights(efc, jar):
    """Flat row forces f (B, nefc), simple-row weights w (B, nefc; 0 on
    cone rows), the rows' cost (B,) and the dense cone Hessian blocks
    [(row index (C, dim), W (B, C, dim, dim))] at jar (B, nefc): the JAX
    package's `_forces_and_weights`, the test surface of the row model."""
    sp, simple, cones = _views(efc)
    f_s, w_s, cost = _simple_forces(simple, jar[:, sp.simple], True)
    f = torch.zeros_like(jar)
    w = torch.zeros_like(jar)
    f[:, sp.simple] = f_s
    w[:, sp.simple] = w_s
    blocks = []
    for g in cones:
        f_c, cw, c_cost = _cone_forces(g, _rows_at(jar, g.idx), True)
        _put_rows(f, g.idx, f_c)
        cost = cost + c_cost
        W = (cw.ru[..., :, None] * cw.ru[..., None, :]
             - cw.rw[..., :, None] * cw.rw[..., None, :]) + torch.diag_embed(cw.wrow)
        blocks.append((g.idx, W))
    return f, w, cost, blocks


# ---------------------------------------------------------------------------
# the general Newton solve (the JAX package's _solve_jnp)
# ---------------------------------------------------------------------------

def _matvec(A, x):
    """(B, ..., n) of A (B, ..., k, n) with x (B, n)."""
    return torch.einsum("b...kn,bn->b...k", A, x)


def _tmatvec(A, y):
    """A^T y: A (B, ..., n), y (B, ...) -> (B, n)."""
    return torch.einsum("b...n,b...->bn", A, y)


def newton(m: Model, d: Data, efc, trips: Optional[list] = None,
           stats: Optional[dict] = None) -> Data:
    """The Newton solve of a batch of any size (mj_solNewton; the JAX
    package's `_solve_jnp`). Up to opt.iterations Newton trips; an env
    stops at its own convergence and stays frozen while others run, as
    under the JAX package's vmapped while_loop. The line search evaluates
    phi' on the 7-point grid in one pass, then one (ls_iterations <= 8)
    or two passes of 8 points, then a secant step. H = M + J^T W J + 1e-12 I
    is solved by linalg_tpu.solve (K1 on CUDA up to n = 96) once per trip.

    The card is asked whether every env has converged once every
    SYNC_EVERY trips. If `trips` is a list, (the Newton trips each env
    took (B,) int64, the trips the batch ran, the host syncs) is appended.
    If `stats` is a dict, it gets each env's Newton trips (`iterations`),
    the norm of the final gradient (`grad_norm`) and the final cost (`cost`),
    each (B,)."""
    a_s, M = d.qacc_smooth, d.qM
    dtype, dev = a_s.dtype, a_s.device
    nv = m.nv
    sp, simple, cones = _views(efc)
    has_simple = simple.J.shape[1] > 0

    def jar_of(x):
        return _matvec(simple.J, x) - simple.aref

    def us_of(x):
        return [_matvec(g.J, x) - g.aref for g in cones]

    def cost_at(x):
        cost = _simple_forces(simple, jar_of(x), False)[2]
        for g, u in zip(cones, us_of(x)):
            cost = cost + _cone_forces(g, u, False)[2]
        x_a = x - a_s
        return 0.5 * (_matvec(M, x_a) * x_a).sum(-1) + cost

    if m.opt.disableflags & DisableBit.WARMSTART:
        x = a_s
    else:
        ws = d.qacc_warmstart
        x = torch.where((cost_at(ws) < cost_at(a_s))[:, None], ws, a_s)

    niter = int(m.opt.iterations)
    nls = max(2, int(m.opt.ls_iterations))
    npass = 1 if nls <= _POLISH_POINTS else 2
    tol = m.opt.tolerance.to(dtype)
    grid = mmath.static_tensor(_GRID, dev, dtype)
    frac = mmath.static_tensor(np.linspace(0.0, 1.0, _POLISH_POINTS), dev, dtype)
    eye = 1e-12 * torch.eye(nv, dtype=dtype, device=dev)
    scale = torch.clamp(torch.abs(_matvec(M, a_s)).sum(-1), min=MINVAL)
    done = torch.isnan(x).any(-1)
    taken = torch.zeros(x.shape[0], dtype=torch.int64, device=dev)
    ran = syncs = 0

    while ran < niter:
        jar = jar_of(x)
        us = us_of(x)
        f_s, w_s, _ = _simple_forces(simple, jar, True)
        cw = [_cone_forces(g, u, True) for g, u in zip(cones, us)]
        xs = x - a_s
        grad = _matvec(M, xs) - _tmatvec(simple.J, f_s)
        # H = M + J_s^T w J_s + sum over cone groups of J^T diag(wrow) J
        # + (J^T ru)(J^T ru)^T - (J^T rw)(J^T rw)^T, at full float32 on the
        # card (no TF32: an indefinite H gives NaN)
        H = M + eye
        if has_simple:
            H = H + simple.J.mT @ (w_s[..., None] * simple.J)
        for g, (f_c, w, _) in zip(cones, cw):
            grad = grad - _tmatvec(g.J, f_c)
            Jf = g.J.flatten(1, 2)
            Au = torch.einsum("bcdv,bcd->bcv", g.J, w.ru)
            Bw = torch.einsum("bcdv,bcd->bcv", g.J, w.rw)
            H = (H + Jf.mT @ (w.wrow.flatten(1, 2)[..., None] * Jf)
                 + Au.mT @ Au - Bw.mT @ Bw)
        dx = -linalg_tpu.solve(H, grad)

        v = _matvec(simple.J, dx)
        vs = [_matvec(g.J, dx) for g in cones]
        Mdx = _matvec(M, dx)
        gMd = (Mdx * xs).sum(-1)
        dMd = (Mdx * dx).sum(-1)

        def dphi(alpha):
            """phi'(alpha) at alpha (B, K), the alpha axis on the rows."""
            fa = _simple_forces(simple, jar[:, None] + alpha[..., None] * v[:, None],
                                False)[0]
            d1 = gMd[:, None] + alpha * dMd[:, None] - (fa * v[:, None]).sum(-1)
            for g, u, vc in zip(cones, us, vs):
                f_c = _cone_forces(g, u[:, None] + alpha[..., None, None] * vc[:, None],
                                   False)[0]
                d1 = d1 - (f_c * vc[:, None]).sum((-1, -2))
            return d1

        d1_grid = dphi(grid.expand(x.shape[0], -1))
        neg = d1_grid < 0
        lo = torch.where(neg, grid, torch.zeros_like(grid)).amax(-1)
        hi = torch.where(neg, grid[-1], grid).amin(-1)
        hi = torch.maximum(hi, lo)
        d1_lo = torch.where(neg.any(-1), torch.where(neg, d1_grid, -torch.inf).amax(-1),
                            -1.0)
        d1_hi = torch.where((~neg).any(-1),
                            torch.where(~neg, d1_grid, torch.inf).amin(-1), 1.0)
        for _ in range(npass):
            pts = lo[:, None] + (hi - lo)[:, None] * frac
            d1s = dphi(pts)
            n_neg = (d1s < 0).sum(-1)
            lo_i = torch.clamp(n_neg - 1, 0, _POLISH_POINTS - 1)[:, None]
            hi_i = torch.clamp(n_neg, 0, _POLISH_POINTS - 1)[:, None]
            some, short = n_neg > 0, n_neg < _POLISH_POINTS
            new_lo = torch.where(some, pts.gather(1, lo_i)[:, 0], lo)
            new_hi = torch.where(short, pts.gather(1, hi_i)[:, 0], hi)
            d1_lo = torch.where(some, d1s.gather(1, lo_i)[:, 0], d1_lo)
            d1_hi = torch.where(short, d1s.gather(1, hi_i)[:, 0], d1_hi)
            lo, hi = new_lo, torch.maximum(new_hi, new_lo)
        # secant finish on the monotone derivative
        denom = d1_hi - d1_lo
        big = torch.abs(denom) > MINVAL
        alpha = torch.where(big, lo - d1_lo * (hi - lo)
                            / torch.where(big, denom, torch.ones_like(denom)),
                            0.5 * (lo + hi))
        alpha = torch.minimum(torch.maximum(alpha, lo), hi)

        # phi'(0) = <grad, dx> bounds the improvement of this trip
        improved_est = -0.5 * alpha * (grad * dx).sum(-1)
        new_done = done | (improved_est < tol * scale) | ((grad * grad).sum(-1) < tol * tol)
        x = torch.where(done[:, None], x, x + alpha[:, None] * dx)
        taken = taken + (~done).long()
        done = new_done
        ran += 1
        if ran % SYNC_EVERY == 0 and ran < niter:
            syncs += 1
            if bool(done.all()):
                break

    jar = jar_of(x)
    f_s = _simple_forces(simple, jar, False)[0]
    qfrc = _tmatvec(simple.J, f_s)
    f_flat = torch.zeros(efc.J.shape[:2], dtype=dtype, device=dev)
    f_flat[:, sp.simple] = f_s
    for g, u in zip(cones, us_of(x)):
        f_c = _cone_forces(g, u, False)[0]
        qfrc = qfrc + _tmatvec(g.J, f_c)
        _put_rows(f_flat, g.idx, f_c)     # a dropped slot's rows stay 0
    if trips is not None:
        trips.append((taken, ran, syncs))
    if stats is not None:
        stats.update(iterations=taken,
                     grad_norm=torch.linalg.vector_norm(_matvec(M, x - a_s) - qfrc, dim=-1),
                     cost=cost_at(x))
    return d.replace(qacc=x, qfrc_constraint=qfrc, efc_force_contact=f_flat,
                     qacc_warmstart=x)


def solve_stats(m: Model, d: Data) -> dict:
    """A diagnostic re-solve of d's constraint problem by the general Newton
    (the JAX package's `solve_stats`): each env's Newton trips, final
    gradient norm and cost, as numpy arrays (B,); zeros without
    constraints. Not part of the step."""
    from mujoco_ros_pkgs_tpu_torch.ops import constraint, efc as efc_mod

    B = d.qpos.shape[0]
    e = efc_mod.make_efc(m, d) if constraint._has_constraints(m) else None
    if e is None:
        return {"iterations": np.zeros(B, np.int64), "grad_norm": np.zeros(B),
                "cost": np.zeros(B)}
    out: dict = {}
    newton(m, d, e, stats=out)
    return {k: v.cpu().numpy() for k, v in out.items()}
