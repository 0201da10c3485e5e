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

`cg` (`_solve_cg_jnp`: Polak-Ribiere+ nonlinear CG in the M^-1 metric, on
the Newton's row views and line search, M^-1 grad by K1 once per trip) and
`pgs` (`_solve_pgs_jnp`: dual projected Gauss-Seidel on the Delassus
matrix J M^-1 J^T + diag(R), whose M^-1 J^T is K1 on B nefc systems) are
the other two solvers; neither goes to K2, and PGS works on the flat rows
(efc.make_efc does not compact them).
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
# points of each polish pass, as fractions of the bracket
_POLISH_POINTS = 8
_POLISH = np.linspace(0.0, 1.0, _POLISH_POINTS)
# the Newton loop asks the card whether every env has converged once every
# SYNC_EVERY trips (one host sync each), not after every trip
SYNC_EVERY = 3


def solve(m: Model, d: Data, efc) -> Data:
    """The constraint solve of efc's rows (ops/efc.Efc) by m.opt.solver from
    d.qacc_smooth and d.qacc_warmstart; sets qacc, qfrc_constraint,
    efc_force_contact (the row forces) and qacc_warmstart (the solution).
    CG and PGS are chosen before the fused Newton's gate, as in the JAX
    package: K2 takes Newton alone."""
    if int(m.opt.solver) == int(SolverType.CG):
        return cg(m, d, efc)
    if int(m.opt.solver) == int(SolverType.PGS):
        return pgs(m, d, efc)
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


def _polish_passes(m: Model) -> int:
    """Polish passes of the line search: one up to ls_iterations = 8, else
    two (max(2, ls_iterations) as the JAX package counts them)."""
    return 1 if max(2, int(m.opt.ls_iterations)) <= _POLISH_POINTS else 2


def _line_search(simple: _Simple, cones, jar, us, v, vs, gMd, dMd, npass):
    """The step alpha (B,) along a direction whose row images are v (simple
    rows) and vs (cone groups), from phi'(alpha) = gMd + alpha dMd - f(jar +
    alpha v) . v: the 7-point grid in one pass, `npass` passes of 8 points
    tightening the bracket, then a secant step on the monotone phi'."""
    dtype, dev = jar.dtype, jar.device
    grid = mmath.static_tensor(_GRID, dev, dtype)
    frac = mmath.static_tensor(_POLISH, dev, dtype)

    def dphi(alpha):
        """phi'(alpha) at alpha (B, K), the alpha axis on the rows."""
        fa = _simple_forces(simple, jar[:, None] + alpha[..., None] * v[:, None], False)[0]
        d1 = gMd[:, None] + alpha * dMd[:, None] - (fa * v[:, None]).sum(-1)
        for g, u, vc in zip(cones, us, vs):
            f_c = _cone_forces(g, u[:, None] + alpha[..., None, None] * vc[:, None],
                               False)[0]
            d1 = d1 - (f_c * vc[:, None]).sum((-1, -2))
        return d1

    d1_grid = dphi(grid.expand(jar.shape[0], -1))
    neg = d1_grid < 0
    lo = torch.where(neg, grid, torch.zeros_like(grid)).amax(-1)
    hi = torch.where(neg, grid[-1], grid).amin(-1)
    hi = torch.maximum(hi, lo)
    d1_lo = torch.where(neg.any(-1), torch.where(neg, d1_grid, -torch.inf).amax(-1), -1.0)
    d1_hi = torch.where((~neg).any(-1), torch.where(~neg, d1_grid, torch.inf).amin(-1), 1.0)
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
                        / torch.where(big, denom, torch.ones_like(denom)), 0.5 * (lo + hi))
    return torch.minimum(torch.maximum(alpha, lo), hi)


def _jar(simple: _Simple, cones, x):
    """The rows' jar at qacc x: simple rows (B, ns) and each cone group's
    (B, C, dim)."""
    return (_matvec(simple.J, x) - simple.aref, [_matvec(g.J, x) - g.aref for g in cones])


def _cost(M, a_s, simple: _Simple, cones, x):
    """The primal objective 0.5 (x - a_s)^T M (x - a_s) + the rows' cost
    (B,) at qacc x."""
    jar, us = _jar(simple, cones, x)
    cost = _simple_forces(simple, jar, False)[2]
    for g, u in zip(cones, us):
        cost = cost + _cone_forces(g, u, False)[2]
    x_a = x - a_s
    return 0.5 * (_matvec(M, x_a) * x_a).sum(-1) + cost


def _start(m: Model, d: Data, simple: _Simple, cones):
    """The primal solvers' start: qacc_smooth, or, unless WARMSTART is
    disabled, the warm start in the envs where its cost is lower."""
    a_s = d.qacc_smooth
    if m.opt.disableflags & DisableBit.WARMSTART:
        return a_s
    ws = d.qacc_warmstart
    better = _cost(d.qM, a_s, simple, cones, ws) < _cost(d.qM, a_s, simple, cones, a_s)
    return torch.where(better[:, None], ws, a_s)


def _gradient(M, a_s, simple: _Simple, cones, x, jar, us):
    """M (x - a_s) - J^T f(jar) (B, nv), the objective's gradient at x."""
    grad = _matvec(M, x - a_s) - _tmatvec(simple.J, _simple_forces(simple, jar, False)[0])
    for g, u in zip(cones, us):
        grad = grad - _tmatvec(g.J, _cone_forces(g, u, False)[0])
    return grad


def _row_forces(efc, sp: _Split, simple: _Simple, cones, x):
    """qfrc_constraint (B, nv) and the flat row forces (B, nefc) at qacc x,
    a compacted group's forces scattered to its canonical rows (a dropped
    slot's rows stay 0)."""
    jar, us = _jar(simple, cones, x)
    f_s = _simple_forces(simple, jar, False)[0]
    qfrc = _tmatvec(simple.J, f_s)
    f_flat = torch.zeros(efc.J.shape[:2], dtype=x.dtype, device=x.device)
    f_flat[:, sp.simple] = f_s
    for g, u in zip(cones, us):
        f_c = _cone_forces(g, u, False)[0]
        qfrc = qfrc + _tmatvec(g.J, f_c)
        _put_rows(f_flat, g.idx, f_c)
    return qfrc, f_flat


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
    x = _start(m, d, simple, cones)

    niter = int(m.opt.iterations)
    npass = _polish_passes(m)
    tol = m.opt.tolerance.to(dtype)
    eye = 1e-12 * torch.eye(nv, dtype=dtype, device=dev)
    scale = torch.clamp(torch.abs(_matvec(M, a_s)).sum(-1), min=MINVAL)
    done = torch.isnan(x).any(-1)
    taken = torch.zeros(x.shape[0], dtype=torch.int64, device=dev)
    ran = syncs = 0

    while ran < niter:
        jar, us = _jar(simple, cones, x)
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

        alpha = _line_search(simple, cones, jar, us, v, vs, gMd, dMd, npass)

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

    qfrc, f_flat = _row_forces(efc, sp, simple, cones, x)
    if trips is not None:
        trips.append((taken, ran, syncs))
    if stats is not None:
        stats.update(iterations=taken,
                     grad_norm=torch.linalg.vector_norm(_matvec(M, x - a_s) - qfrc, dim=-1),
                     cost=_cost(M, a_s, simple, cones, x))
    return d.replace(qacc=x, qfrc_constraint=qfrc, efc_force_contact=f_flat,
                     qacc_warmstart=x)


# ---------------------------------------------------------------------------
# CG and PGS (the JAX package's _solve_cg_jnp and _solve_pgs_jnp)
# ---------------------------------------------------------------------------

def cg(m: Model, d: Data, efc, trips: Optional[list] = None) -> Data:
    """Polak-Ribiere+ nonlinear CG with the M^-1 metric on the Newton's
    objective (mj_solCG; the JAX package's `_solve_cg_jnp`): the Newton's
    row views (compacted cone groups included), start and line search;
    M^-1 grad by linalg_tpu.solve (K1 on CUDA up to n = 96) once at the
    start and once per trip; a direction that is not a descent restarts
    at -M^-1 grad. An env stops when a trip's estimated improvement falls
    below tolerance times its scale or its gradient below tolerance, and
    stays frozen while others run; the card is asked whether every env has
    stopped once every SYNC_EVERY trips. If `trips` is a list, (the trips
    each env took (B,), the trips the batch ran, the host syncs) is
    appended."""
    a_s, M = d.qacc_smooth, d.qM
    dev = a_s.device
    sp, simple, cones = _views(efc)
    x = _start(m, d, simple, cones)
    niter = int(m.opt.iterations)
    npass = _polish_passes(m)
    tol = m.opt.tolerance.to(a_s.dtype)
    scale = torch.clamp(torch.abs(_matvec(M, a_s)).sum(-1), min=MINVAL)
    grad = _gradient(M, a_s, simple, cones, x, *_jar(simple, cones, x))
    Mg = linalg_tpu.solve(M, grad)
    p = -Mg
    done = torch.isnan(x).any(-1)
    taken = torch.zeros(x.shape[0], dtype=torch.int64, device=dev)
    ran = syncs = 0
    while ran < niter:
        jar, us = _jar(simple, cones, x)
        v = _matvec(simple.J, p)
        vs = [_matvec(g.J, p) for g in cones]
        Mp = _matvec(M, p)
        alpha = _line_search(simple, cones, jar, us, v, vs, (Mp * (x - a_s)).sum(-1),
                             (Mp * p).sum(-1), npass)
        x_n = x + alpha[:, None] * p
        grad_n = _gradient(M, a_s, simple, cones, x_n, *_jar(simple, cones, x_n))
        Mg_n = linalg_tpu.solve(M, grad_n)
        beta = torch.clamp((grad_n * (Mg_n - Mg)).sum(-1)
                           / torch.clamp((grad * Mg).sum(-1), min=MINVAL), min=0.0)
        p_n = -Mg_n + beta[:, None] * p
        p_n = torch.where(((p_n * grad_n).sum(-1) < 0)[:, None], p_n, -Mg_n)
        improved_est = -0.5 * alpha * (grad * p).sum(-1)
        new_done = (done | (improved_est < tol * scale)
                    | ((grad_n * grad_n).sum(-1) < tol * tol))
        keep = done[:, None]
        x, grad, Mg, p = (torch.where(keep, old, new) for old, new in
                          ((x, x_n), (grad, grad_n), (Mg, Mg_n), (p, p_n)))
        taken = taken + (~done).long()
        done = new_done
        ran += 1
        if ran % SYNC_EVERY == 0 and ran < niter:
            syncs += 1
            if bool(done.all()):
                break
    qfrc, f_flat = _row_forces(efc, sp, simple, cones, x)
    if trips is not None:
        trips.append((taken, ran, syncs))
    return d.replace(qacc=x, qfrc_constraint=qfrc, efc_force_contact=f_flat,
                     qacc_warmstart=x)


def _m_inv_rows(M, J):
    """M^-1 J_r^T for every row r of J (B, nefc, nv) -> (B, nefc, nv): one
    batch of B nefc systems of n = nv with M repeated over the rows
    (linalg_tpu.solve: K1 on CUDA up to n = 96)."""
    B, nefc, nv = J.shape
    Mr = M[:, None].expand(B, nefc, nv, nv).reshape(B * nefc, nv, nv)
    return linalg_tpu.solve(Mr, J.reshape(B * nefc, nv)).view(B, nefc, nv)


# the QCQP's multiplier bracket: 24 doublings (by 4) from 1, then 48
# bisections, taken as 8 rounds of 64ths of the bracket (6 bisections each)
_DOUBLINGS, _BISECTIONS, _SPLIT_BITS = 24, 48, 6
_BRACKET = 4.0 ** np.arange(_DOUBLINGS + 1)
_SPLIT = np.arange(1, 2 ** _SPLIT_BITS) / 2 ** _SPLIT_BITS


def _qcqp(Ab, bb, mus, r):
    """min 0.5 x^T Ab x + bb^T x subject to sum (x_i / mus_i)^2 <= r^2, per
    env: Ab (B, k, k), bb, mus (B, k), r (B,). The unconstrained solution
    where it is inside, else at the ellipsoid's multiplier lam, bracketed by
    doubling (hi = 4^j from 1, 24 times, while the violation g(hi) > 0) and
    narrowed by 48 bisections, as the JAX package's fixed trips do; 0 where
    r <= 0. Each x(lam) is torch.linalg.solve_ex (LU, the JAX package's
    jnp.linalg.solve), batched over the lams of a pass: the doublings' hi
    is the first 4^j, j < 24, with g(4^j) <= 0, else 4^24, all 24 solved at
    once; the bisections run as 8 rounds that evaluate g at the 63 interior
    64ths of the bracket and keep the 64th where g changes sign. The points
    are those 6 halvings visit (dyadic, exact in float64) and g decreases
    in lam, so the bracket is the 48 sequential halvings'."""
    Dm = torch.diag_embed(1.0 / (mus * mus))

    def x_of(lam):
        """x at each lam (B, P): (B, P, k)."""
        A = Ab.unsqueeze(-3) + lam[..., None, None] * Dm.unsqueeze(-3)
        return torch.linalg.solve_ex(A, -bb.unsqueeze(-2).expand(A.shape[:-1]))[0]

    def over(lam):
        """Where the violation at lam (B, P) is positive: sum (x / mus)^2 > r^2."""
        return ((x_of(lam) / mus.unsqueeze(-2)) ** 2).sum(-1) > (r * r)[:, None]

    dev, dtype = r.device, r.dtype
    x0 = x_of(torch.zeros_like(r)[:, None])[:, 0]
    inside = ((x0 / mus) ** 2).sum(-1) <= r * r
    out = over(mmath.static_tensor(_BRACKET[:_DOUBLINGS], dev, dtype).expand(r.shape[0], -1))
    first = torch.where(out.all(-1), _DOUBLINGS, (~out).long().argmax(-1))
    hi = mmath.static_tensor(_BRACKET, dev, dtype)[first]
    lo = torch.zeros_like(r)
    split = mmath.static_tensor(_SPLIT, dev, dtype)
    for _ in range(_BISECTIONS // _SPLIT_BITS):
        pts = torch.cat([lo[:, None], lo[:, None] + (hi - lo)[:, None] * split,
                         hi[:, None]], -1)                        # (B, 65)
        n = over(pts[:, 1:-1]).sum(-1, keepdim=True)               # points with g > 0
        lo, hi = pts.gather(1, n)[:, 0], pts.gather(1, n + 1)[:, 0]
    x = torch.where(inside[:, None], x0, x_of((0.5 * (lo + hi))[:, None])[:, 0])
    return torch.where((r > 0)[:, None], x, torch.zeros_like(x))


@functools.lru_cache(maxsize=64)
def _pgs_layout(kinds, con_base, con_dim):
    """The PGS sweep's static layout: the rows the scalar sweep visits (every
    row but the 'con' rows, a condim-1 contact's row among them, whose force
    stays at its start as in the JAX package), the equality and friction-loss
    masks, and the elliptic contacts of condim > 1 grouped by condim in
    condim order: (dim, contact indices, first rows)."""
    k = np.array(kinds)
    by_dim: dict = {}
    for ci, (base, dim) in enumerate(zip(con_base, con_dim)):
        if dim > 1:
            by_dim.setdefault(dim, []).append((ci, base))
    groups = tuple((dim, tuple(c for c, _ in items), tuple(b for _, b in items))
                   for dim, items in sorted(by_dim.items()))
    return (tuple(np.flatnonzero(k != "con").tolist()), k == "eq", k == "fri", k == "con",
            groups)


def pgs(m: Model, d: Data, efc, trips: Optional[list] = None,
        stats: Optional[dict] = None) -> Data:
    """Dual projected Gauss-Seidel (mj_solPGS; the JAX package's
    `_solve_pgs_jnp`) on min 0.5 f^T A f + f^T b, A = J M^-1 J^T + diag(R),
    b = J qacc_smooth - aref, over the flat rows: equality rows free,
    friction-loss rows boxed to +-frictionloss, limit, pyramidal and
    condim-1 rows nonnegative, elliptic contacts in their friction cone.
    One sweep: each simple row's clamped scalar step in canonical order,
    then each elliptic contact, condim groups in order: a step along the
    cone's ray where its friction is saturated (t >= fn - 1e-12), else a
    scalar step of the normal, then the tangential QCQP at the new normal
    force (_qcqp). The start: 0 with WARMSTART disabled, else the soft-model
    forces at the warm start. An env stops when a sweep improves the dual
    cost by less than tolerance times its scale (or at once on a NaN start)
    and stays frozen; the card is asked once every SYNC_EVERY sweeps. A row
    that no env updates and a contact active in no env keep their forces
    (0 for the contact) without their steps: the batch's rows and contacts
    are read once a solve (one host sync). M^-1 J^T and the final qacc =
    qacc_smooth + M^-1 J^T f are K1 on CUDA (linalg_tpu.solve). `trips` as
    in `cg`. If `stats` is a dict, it gets `saturation_margin` (B,): the
    least |t - (fn - 1e-12)| / fn of an active contact's saturation test
    over the solve, where a relative margin near the float's epsilon means
    that rounding decided the branch."""
    a_s, M, J = d.qacc_smooth, d.qM, efc.J
    dtype, dev = a_s.dtype, a_s.device
    B, nefc, nv = J.shape
    A = J @ _m_inv_rows(M, J).mT + torch.diag_embed(efc.R)
    b = _matvec(J, a_s) - efc.aref
    rows, is_eq, is_fri, is_con, groups = _pgs_layout(efc.kinds, efc.con_base, efc.con_dim)
    big = float(np.finfo(np.float32).max)
    eq_fri = mmath.static_tensor(is_eq | is_fri, dev)
    fri = mmath.static_tensor(is_fri, dev)
    lo = torch.where(eq_fri, -big, 0.0).to(dtype).expand(B, nefc)
    lo = torch.where(fri, -efc.frictionloss, lo)
    hi = torch.where(fri, efc.frictionloss, big)
    upd = ~mmath.static_tensor(is_con, dev) & efc.active
    diagA = torch.diagonal(A, dim1=-2, dim2=-1)
    live = torch.cat([upd.any(0), efc.con_active.any(0)]).tolist()
    rows = [i for i in rows if live[i]]
    cone_groups = []
    for dim, cis, bases in groups:
        cist = mmath.static_tensor(cis, dev)
        mus = torch.clamp(efc.con_mu[:, cist][..., :dim - 1], min=MINVAL)
        cone_groups.append([(base, mmath.static_tensor(np.arange(base, base + dim), dev),
                             mus[:, k], efc.con_active[:, ci])
                            for k, (ci, base) in enumerate(zip(cis, bases))
                            if live[nefc + ci]])
    margin = torch.full((B,), torch.inf, dtype=dtype, device=dev)

    def sweep(f):
        nonlocal margin
        f = f.clone()
        for i in rows:
            f_old = f[:, i]
            res = (A[:, i] * f).sum(-1) + b[:, i]
            fi = torch.minimum(torch.maximum(f_old - res / diagA[:, i], lo[:, i]), hi[:, i])
            fi = torch.where(upd[:, i], fi, f_old)
            f[:, i] = f_old + (fi - f_old)
        for contacts in cone_groups:
            for base, it, mus, act in contacts:
                fb = f[:, it]
                fn, ft = fb[:, 0], fb[:, 1:]
                Ar = A[:, it]                                      # (B, dim, nefc)
                res = _matvec(Ar, f) + b[:, it]
                t = torch.sqrt(torch.clamp(((ft / mus) ** 2).sum(-1), min=MINVAL ** 2))
                saturated = (t >= fn - 1e-12) & (t > MINVAL)
                if stats is not None:
                    gap = torch.abs(t - (fn - 1e-12)) / torch.clamp(torch.abs(fn), min=MINVAL)
                    margin = torch.minimum(margin, torch.where(act, gap, torch.inf))
                u_t = ft / t[:, None]
                Au = Ar[:, 0] + torch.einsum("bk,bkn->bn", u_t, Ar[:, 1:])
                uAu = Au[:, base] + (u_t * Au[:, it[1:]]).sum(-1)
                num = res[:, 0] + (u_t * res[:, 1:]).sum(-1)
                fn_ray = torch.clamp(fn - num / torch.clamp(uAu, min=MINVAL), min=0.0)
                ft_ray = ft * (fn_ray / torch.clamp(fn, min=MINVAL))[:, None]
                fn_gs = torch.clamp(fn - res[:, 0] / Ar[:, 0, base], min=0.0)
                fn_new = torch.where(saturated, fn_ray, fn_gs)
                f[:, it] = torch.cat([fn_new[:, None],
                                      torch.where(saturated[:, None], ft_ray, ft)], -1)
                Ab = Ar[:, 1:][:, :, it[1:]]
                other = _matvec(Ar[:, 1:], f) - _matvec(Ab, f[:, it[1:]])
                ft_new = _qcqp(Ab, b[:, it[1:]] + other, mus, fn_new)
                fb_new = torch.cat([fn_new[:, None], ft_new], -1)
                f[:, it] = torch.where(act[:, None], fb_new, torch.zeros_like(fb_new))
        return f

    def cost(f):
        return 0.5 * (f * _matvec(A, f)).sum(-1) + (f * b).sum(-1)

    if m.opt.disableflags & DisableBit.WARMSTART:
        f = torch.zeros_like(b)
    else:
        f = forces_and_weights(efc, _matvec(J, d.qacc_warmstart) - efc.aref)[0]
        f = torch.where(efc.active, f, torch.zeros_like(f))
    niter = int(m.opt.iterations)
    tol = m.opt.tolerance.to(dtype)
    scale = torch.clamp(torch.abs(_matvec(M, a_s)).sum(-1), min=MINVAL)
    prev = cost(f)
    done = torch.isnan(f).any(-1)
    taken = torch.zeros(B, dtype=torch.int64, device=dev)
    ran = syncs = 0
    while ran < niter:
        f_n = sweep(f)
        c = cost(f_n)
        new_done = done | (prev - c < tol * scale)
        f = torch.where(done[:, None], f, f_n)
        prev = torch.where(done, prev, c)
        taken = taken + (~done).long()
        done = new_done
        ran += 1
        if ran % SYNC_EVERY == 0 and ran < niter:
            syncs += 1
            if bool(done.all()):
                break
    qfrc = _tmatvec(J, f)
    qacc = a_s + linalg_tpu.solve(M, qfrc)
    if trips is not None:
        trips.append((taken, ran, syncs))
    if stats is not None:
        stats["saturation_margin"] = margin
    return d.replace(qacc=qacc, qfrc_constraint=qfrc, efc_force_contact=f,
                     qacc_warmstart=qacc)


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
