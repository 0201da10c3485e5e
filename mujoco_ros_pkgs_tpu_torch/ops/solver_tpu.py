"""Plain-torch body of the fused Newton constraint solve.

Counterpart of `_row_forces`, `_chol_solve` and `newton_tiles` in
mujoco_ros_pkgs_tpu/ops/solver_tpu.py, written batch-first: the (8, 128)
env tiles of the JAX kernel become the leading env axis, and the per-row /
per-dof Python lists become stacked tensor axes. This is the plain version
of the device functions in csrc/newton.cuh, which the fused step kernel
(ops/step_tpu.py, csrc/step_fused.cu) runs; the CPU tests hold it against
the JAX kernel in interpret mode.

Shapes: J (B, nefc, nv); aref, D, floss, act (B, nefc); mu (B, ncon, 5) in
MuJoCo order [mu_t1, mu_t2, mu_tor, mu_roll1, mu_roll2]; M (B, nv, nv)
symmetric; a_s, ws (B, nv). Row kinds: 'eq', 'fri', 'lim' or 'con';
`con_base` lists (first row, condim) per contact.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from mujoco_ros_pkgs_tpu_torch.ops.math import MINVAL

_GRID_ALPHAS = (0.0625, 0.25, 0.5, 1.0, 2.0, 4.0, 16.0)
# tangential sigma per cone component: [mu0, mu0, mu_tor, mu_roll1, mu_roll2]
_SIGMA_COL = (0, 0, 2, 3, 4)


def _cone_groups(con_base) -> Dict[int, Tuple[list, list]]:
    """Contacts grouped by condim > 1: dim -> (contact indices, row bases)."""
    groups: Dict[int, Tuple[list, list]] = {}
    for ci, (base, dim) in enumerate(con_base):
        if dim > 1:
            cis, bases = groups.setdefault(dim, ([], []))
            cis.append(ci)
            bases.append(base)
    return groups


def _row_forces(kinds, con_base, mu, D, floss, act, jar, want_w):
    """Forces for every efc row; leading dims of jar (e.g. (B,) or (B, K))
    broadcast against D/floss/act (B, nefc) and mu (B, ncon, 5) by adding
    singleton axes after the env axis.

    Diagonal rows ('eq'/'fri'/'lim' and condim-1 contacts) get per-row
    weights w; elliptic cones (condim 3/4/6) get a dim x dim Hessian block
    per contact — the model of ops/solver.py in the JAX package.

    Returns (f, w, cost, W) with W = {dim: (row index (n, dim), block
    (..., n, dim, dim))}."""
    extra = jar.dim() - D.dim()

    def lift(t):
        return t.reshape(t.shape[:1] + (1,) * extra + t.shape[1:]) if extra else t

    D, floss, act = lift(D), lift(floss), lift(act)
    dev = jar.device
    single = [k == "con" and any(b == r and d == 1 for b, d in con_base)
              for r, k in enumerate(kinds)]
    is_eq = torch.tensor([k == "eq" for k in kinds], device=dev)
    is_fri = torch.tensor([k == "fri" for k in kinds], device=dev)
    is_lim = torch.tensor([k == "lim" or s for k, s in zip(kinds, single)],
                          device=dev)

    # eq: always on; fri: Huber; lim / condim-1 contact: one-sided quadratic
    quad_c = 0.5 * D * jar * jar
    f_unc = -D * jar
    lin = torch.abs(f_unc) > floss
    one_sided = act & (jar < 0)
    f = torch.where(is_eq & act, f_unc,
                    torch.where(is_fri & act, torch.clamp(f_unc, -floss, floss),
                                torch.where(is_lim & one_sided, f_unc, 0.0)))
    w = torch.where((is_eq & act) | (is_fri & act & ~lin) | (is_lim & one_sided),
                    D, 0.0)
    c_fri = torch.where(lin, floss * torch.abs(jar)
                        - 0.5 * floss * floss / torch.clamp(D, min=MINVAL), quad_c)
    cost = torch.where(is_eq & act, quad_c,
                       torch.where(is_fri & act, c_fri,
                                   torch.where(is_lim & one_sided, quad_c, 0.0)))
    cost = cost.sum(-1)

    W = {}
    for dim, (cis, bases) in _cone_groups(con_base).items():
        nt = dim - 1
        idx = torch.tensor([[b + k for k in range(dim)] for b in bases], device=dev)
        u = jar[..., idx]                                   # (..., n, dim)
        Dv = D[..., idx]
        a = act[..., idx[:, 0]]                             # (..., n)
        mu_c = lift(mu[:, cis])                             # (..., n, 5)
        sig = torch.clamp(mu_c[..., list(_SIGMA_COL[:nt])], min=MINVAL)
        Dn = Dv[..., 0]
        P_n = -Dn * u[..., 0]
        P_t = -Dv[..., 1:] * u[..., 1:]
        ph = P_t / sig
        Dh = Dv[..., 1:] / (sig * sig)
        T = torch.sqrt(torch.clamp((ph * ph).sum(-1), min=MINVAL * MINVAL))
        inside = T <= P_n
        Dbar = Dh.sum(-1) / nt
        fn_mid = (P_n / Dn + T / Dbar) / (1.0 / Dn + 1.0 / Dbar)
        polar = fn_mid <= 0.0
        f_n = torch.where(inside, P_n, torch.where(polar, 0.0, fn_mid))
        dirs = ph / T[..., None]
        ft = sig * torch.where(inside[..., None], ph,
                               torch.where(polar[..., None], 0.0,
                                           fn_mid[..., None] * dirs))
        fc = torch.cat([torch.where(a, f_n, 0.0)[..., None],
                        torch.where(a[..., None], ft, 0.0)], -1)
        f = _scatter(f, idx, fc)
        Pfull = torch.cat([P_n[..., None], P_t], -1)
        c = (0.5 * (Dv * u * u).sum(-1)
             - 0.5 * ((Pfull - fc) ** 2 / Dv).sum(-1))
        cost = cost + torch.where(a, c, 0.0).sum(-1)
        if not want_w:
            continue
        A = Dn * Dbar / (Dn + Dbar)
        btt = fn_mid * Dbar / T
        # W_tt = sig sig^T o [btt I + (A - btt) d d^T]; W_t0 = A sig d
        Wt = (sig[..., :, None] * sig[..., None, :]) * (
            (A - btt)[..., None, None] * (dirs[..., :, None] * dirs[..., None, :])
            + btt[..., None, None] * torch.eye(nt, dtype=D.dtype, device=dev))
        Wt0 = A[..., None] * sig * dirs
        Wm = torch.cat([torch.cat([A[..., None, None], Wt0[..., None, :]], -1),
                        torch.cat([Wt0[..., :, None], Wt], -1)], -2)
        Wm = torch.where(inside[..., None, None], torch.diag_embed(Dv), Wm)
        Wm = torch.where((polar | ~a)[..., None, None], 0.0, Wm)
        W[dim] = (idx, Wm)
    return f, w, cost, W


def _scatter(f, idx, vals):
    """f[..., idx] = vals (out of place)."""
    out = f.clone()
    out[..., idx] = vals
    return out


def _chol_solve(H, g):
    """Cholesky solve of (B, n, n) H (lower triangle read) against g (B, n),
    with the pivot clamp of the JAX kernel (sqrt(max(s, 1e-30)))."""
    n = H.shape[-1]
    L = torch.zeros_like(H)
    for i in range(n):
        s = H[..., i, i] - (L[..., i, :i] * L[..., i, :i]).sum(-1)
        Lii = torch.sqrt(torch.clamp(s, min=1e-30))
        L[..., i, i] = Lii
        if i + 1 < n:
            s = H[..., i + 1:, i] - (L[..., i + 1:, :i] * L[..., i:i + 1, :i]).sum(-1)
            L[..., i + 1:, i] = s * (1.0 / Lii)[..., None]
    y = torch.zeros_like(g)
    for i in range(n):
        y[..., i] = (g[..., i] - (L[..., i, :i] * y[..., :i]).sum(-1)) / L[..., i, i]
    x = torch.zeros_like(g)
    for i in reversed(range(n)):
        x[..., i] = (y[..., i] - (L[..., i + 1:, i] * x[..., i + 1:]).sum(-1)) / L[..., i, i]
    return x


def newton_tiles(nv, kinds, con_base, niter, nls, warmstart, tol, J, aref, D,
                 floss, act, mu, M, a_s, ws):
    """The whole Newton constraint solve on a batch. Returns (x (B, nv),
    f (B, nefc)). Up to `niter` Newton steps; an env's x freezes once it
    converges, and the loop stops when every env has."""
    def Mmul(v):
        return (M @ v[..., None])[..., 0]

    def jar_at(x):
        return (J @ x[..., None])[..., 0] - aref

    def forces(jar, want_w):
        return _row_forces(kinds, con_base, mu, D, floss, act, jar, want_w)

    def cost_at(x):
        dx = x - a_s
        return 0.5 * (Mmul(dx) * dx).sum(-1) + forces(jar_at(x), False)[2]

    x = a_s
    if warmstart:
        better = cost_at(ws) < cost_at(a_s)
        x = torch.where(better[:, None], ws, a_s)
    scale = torch.clamp(torch.abs(Mmul(a_s)).sum(-1), min=MINVAL)
    done = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    alphas = torch.tensor(_GRID_ALPHAS, dtype=x.dtype, device=x.device)
    eye = torch.eye(nv, dtype=x.dtype, device=x.device)

    def cone_quad(Wd, vec):
        """sum over contacts of v_c^T W_c v_c, vec (..., nefc)."""
        out = 0.0
        for idx, Wm in Wd.values():
            vc = vec[..., idx]
            out = out + (vc[..., :, None] * Wm * vc[..., None, :]).sum((-1, -2, -3))
        return out

    for _ in range(niter):
        jar = jar_at(x)
        f, w, _, Wc = forces(jar, True)
        xs = x - a_s
        grad = Mmul(xs) - (J * f[..., None]).sum(-2)
        H = M + torch.einsum("bri,br,brj->bij", J, w, J) + 1e-12 * eye
        for idx, Wm in Wc.values():
            Jc = J[:, idx]                                   # (B, n, dim, nv)
            H = H + torch.einsum("bcki,bckl,bclj->bij", Jc, Wm, Jc)
        dx = _chol_solve(H, -grad)
        v_ls = (J @ dx[..., None])[..., 0]
        Mdx = Mmul(dx)
        gMd = (Mdx * xs).sum(-1)
        dMd = (Mdx * dx).sum(-1)

        # vectorized bracket: phi'(alpha) over the static grid at once
        jj = jar[:, None, :] + alphas[None, :, None] * v_ls[:, None, :]
        fa = forces(jj, False)[0]
        d1g = (gMd[:, None] + alphas[None, :] * dMd[:, None]
               - (fa * v_ls[:, None, :]).sum(-1))
        lo = torch.zeros_like(gMd)
        hi = torch.full_like(gMd, _GRID_ALPHAS[-1])
        found_hi = torch.zeros_like(done)
        for k, a in enumerate(_GRID_ALPHAS):
            neg = d1g[:, k] < 0
            lo = torch.where(neg, a, lo)
            hi = torch.where(~neg & ~found_hi, a, hi)
            found_hi = found_hi | ~neg
        hi = torch.maximum(hi, lo)

        alpha = 0.5 * (lo + hi)
        for _k in range(nls):
            fa, wa, _, Wa = forces(jar + alpha[:, None] * v_ls, True)
            d1 = gMd + alpha * dMd - (fa * v_ls).sum(-1)
            d2 = dMd + (wa * v_ls * v_ls).sum(-1) + cone_quad(Wa, v_ls)
            n1 = d1 < 0
            lo = torch.where(n1, alpha, lo)
            hi = torch.where(~n1, alpha, hi)
            newton = alpha - d1 / torch.clamp(d2, min=MINVAL)
            inb = (newton > lo) & (newton < hi)
            alpha = torch.where(inb, newton, 0.5 * (lo + hi))

        improved_est = -0.5 * alpha * (grad * dx).sum(-1)
        gradsq = (grad * grad).sum(-1)
        new_done = done | (improved_est < tol * scale) | (gradsq < tol * tol)
        x = torch.where(done[:, None], x, x + alpha[:, None] * dx)
        done = new_done
        if bool(done.all()):
            break

    f, _, _, _ = forces(jar_at(x), False)
    return x, f
